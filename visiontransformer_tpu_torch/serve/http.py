"""Minimal HTTP utilities: multipart parsing, cookies, JSON responses.

Stdlib-only (the image has no web framework); the multipart parser handles
the subset the reference API uses — form fields + file uploads
(reference backend/core/views.py:56 uses DRF's MultiPartParser).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple


class UploadedFile:
    def __init__(self, filename: str, content: bytes,
                 content_type: str = "application/octet-stream"):
        self.filename = filename
        self.content = content
        self.content_type = content_type


def parse_multipart(body: bytes, content_type: str
                    ) -> Tuple[Dict[str, str], Dict[str, UploadedFile]]:
    """Parse multipart/form-data. Returns (fields, files)."""
    boundary = None
    for part in content_type.split(";"):
        part = part.strip()
        if part.startswith("boundary="):
            boundary = part[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("multipart body without boundary")

    delim = b"--" + boundary.encode()
    fields: Dict[str, str] = {}
    files: Dict[str, UploadedFile] = {}

    for chunk in body.split(delim):
        # Remove exactly the delimiter-adjacent CRLF pair on each side —
        # NOT .strip(), which would corrupt file contents that legitimately
        # end in 0x0D/0x0A bytes.
        if chunk.startswith(b"\r\n"):
            chunk = chunk[2:]
        if chunk.endswith(b"\r\n"):
            chunk = chunk[:-2]
        if not chunk or chunk.rstrip(b"\r\n-") == b"":
            continue
        if b"\r\n\r\n" not in chunk:
            continue
        raw_headers, content = chunk.split(b"\r\n\r\n", 1)
        headers = {}
        for line in raw_headers.decode("utf-8", "replace").split("\r\n"):
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        disposition = headers.get("content-disposition", "")
        attrs = _parse_disposition(disposition)
        name = attrs.get("name")
        if not name:
            continue
        if "filename" in attrs:
            files[name] = UploadedFile(
                attrs["filename"], content,
                headers.get("content-type", "application/octet-stream"))
        else:
            fields[name] = content.decode("utf-8", "replace")
    return fields, files


def _parse_disposition(value: str) -> Dict[str, str]:
    out = {}
    for part in value.split(";"):
        part = part.strip()
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def parse_cookies(header: Optional[str]) -> Dict[str, str]:
    cookies = {}
    if header:
        for pair in header.split(";"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                cookies[k.strip()] = v.strip()
    return cookies


def json_bytes(payload) -> bytes:
    return json.dumps(payload).encode()


def paginate(items, page: int, page_size: int, base_url: str) -> Dict:
    """DRF PageNumberPagination response shape with the reference's page
    size 9 (reference backend/project/settings.py:64)."""
    count = len(items)
    start = (page - 1) * page_size
    results = items[start:start + page_size]
    def _url(p):
        return f"{base_url}?page={p}" if p else None
    next_page = page + 1 if start + page_size < count else None
    prev_page = page - 1 if page > 1 else None
    return {"count": count, "next": _url(next_page),
            "previous": _url(prev_page), "results": results}
