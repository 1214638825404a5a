"""Session-cookie authentication.

Same surface as the reference's users app (reference backend/users/views.py:
login/register/logout/current-user with Django session cookies) without
Django: the session is a signed token  ``username:expiry:hmac-sha256`` in a
``sessionid`` cookie, plus a double-submit ``csrftoken`` cookie checked on
unsafe methods for session-authenticated requests (Django's CSRF model,
reference backend/core/views.py:23-29 issues the cookie).
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import time
from typing import Optional

SESSION_TTL = 14 * 24 * 3600  # Django's default two-week session age


class SessionSigner:
    def __init__(self, secret: Optional[bytes] = None):
        self.secret = secret or secrets.token_bytes(32)

    def _sig(self, payload: str) -> str:
        return hmac.new(self.secret, payload.encode(),
                        hashlib.sha256).hexdigest()

    def create(self, username: str, now: Optional[float] = None) -> str:
        expiry = int((now or time.time()) + SESSION_TTL)
        payload = f"{username}:{expiry}"
        return f"{payload}:{self._sig(payload)}"

    def verify(self, token: str, now: Optional[float] = None) -> Optional[str]:
        """Returns the username, or None for bad/expired tokens."""
        try:
            username, expiry, sig = token.rsplit(":", 2)
        except ValueError:
            return None
        payload = f"{username}:{expiry}"
        if not hmac.compare_digest(sig, self._sig(payload)):
            return None
        if int(expiry) < (now or time.time()):
            return None
        return username


def new_csrf_token() -> str:
    return secrets.token_hex(16)
