"""REST serving platform.

Implements the reference backend's public endpoint table (SURVEY.md §1;
reference backend/project/urls.py:26-37, backend/core/urls.py:5-31,
backend/users/urls.py:5-10) on the stdlib ThreadingHTTPServer, backed by the
SQLite JobStore and the in-process dynamic-batching GPU worker
(serve/worker.py):

  GET  /api/csrf/                         set csrftoken cookie
  GET  /api/hello/                        {"message": "Hello, World!"}
  GET  /api/vision-models/[{pk}/]         model registry (paginated list)
  GET  /api/inference-jobs/[?status=]     own jobs, paginated (page size 9)
  POST /api/inference-jobs/               multipart {vision_model, input_image}
  GET  /api/inference-jobs/{uuid}/        job detail
  POST /api/inference-jobs/{uuid}/complete/  external-worker callback (parity
       path; the embedded worker normally completes jobs itself)
  GET  /api/metrics/                      job/user counts
  POST /api/users/{register,login,logout}/   session auth
  GET  /api/users/current-user/
  GET  /api/schema/                       OpenAPI 3 JSON
  GET  /media/...                         stored inputs/masks

Response shapes mirror the DRF serializers (reference
backend/core/serializers.py:22-75: nested vision_model_details,
user_username, read-only status/mask_image/timestamps).

Jobs are owned by the authenticated user (fixing views.py:58-63 which pins
every job to the first DB user); anonymous submission is still allowed for
contract parity (permission AllowAny, views.py:55) with user=None.
"""

from __future__ import annotations

import hmac
import json
import mimetypes
import os
import uuid as _uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from visiontransformer_tpu_torch.serve.auth import SessionSigner, new_csrf_token
from visiontransformer_tpu_torch.serve.http import (
    json_bytes,
    paginate,
    parse_cookies,
    parse_multipart,
)
from visiontransformer_tpu_torch.serve.store import JobStore

PAGE_SIZE = 9  # reference backend/project/settings.py:64

# Extensions a job upload may be stored under (anything else -> .png).
_IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif",
                     ".tiff", ".webp"}


class ServingApp:
    """Routing + handlers, independent of the HTTP plumbing (testable)."""

    def __init__(self, store: JobStore, *, worker=None,
                 signer: Optional[SessionSigner] = None,
                 orch_url: Optional[str] = None, orch_token: str = ""):
        import threading as _threading

        self.store = store
        self.worker = worker
        self.signer = signer or SessionSigner()
        self._profile_lock = _threading.Lock()
        # External-orchestrator dispatch (the reference's call_model_server,
        # backend/core/views.py:97-114): when configured and no embedded
        # worker claims jobs, each created job is pushed to the orchestrator
        # over HTTP with the shared token. Unlike the reference, a failed
        # push marks the job FAILED instead of leaving it PENDING forever.
        self.orch_url = orch_url
        self.orch_token = orch_token

    # ------------------------------------------------------------ helpers
    def _current_user(self, cookies: Dict[str, str]) -> Optional[Dict]:
        token = cookies.get("sessionid")
        if not token:
            return None
        username = self.signer.verify(token)
        return self.store.get_user_by_name(username) if username else None

    def _check_csrf(self, cookies, headers) -> bool:
        """Django-style double submit: session-authenticated unsafe requests
        must echo the csrftoken cookie in the X-CSRFToken header."""
        if "sessionid" not in cookies:
            return True  # anonymous requests carry no ambient authority
        cookie_token = cookies.get("csrftoken")
        if not cookie_token:
            return False
        return headers.get("x-csrftoken") == cookie_token

    @staticmethod
    def _public_model(model: Optional[Dict]) -> Optional[Dict]:
        """Strip server-side fields (the reference likewise removed the
        weights FileField from the public model, migration 0002)."""
        if model is None:
            return None
        return {k: v for k, v in model.items() if k != "checkpoint_path"}

    def _serialize_job(self, job: Dict) -> Dict:
        model = self._public_model(self.store.get_model(job["vision_model"]))
        return {
            "id": job["id"],
            "vision_model": job["vision_model"],
            "vision_model_details": model,
            "user_username": job["user_username"],
            "status": job["status"],
            "input_image": _media_url(job["input_image"], self.store),
            "mask_image": _media_url(job["mask_image"], self.store),
            "error_message": job["error_message"],
            "detections": json.loads(job["detections"]) if job["detections"] else [],
            "created_at": job["created_at"],
            "updated_at": job["updated_at"],
        }

    # ------------------------------------------------------------- routes
    def handle(self, method: str, path: str, query: Dict, headers: Dict,
               body: bytes, cookies: Dict) -> Tuple[int, Dict, list]:
        """Returns (status, payload, extra_headers)."""
        route = path.rstrip("/")
        send_headers = []

        if route == "/api/csrf" and method == "GET":
            token = new_csrf_token()
            send_headers.append(("Set-Cookie",
                                 f"csrftoken={token}; Path=/; SameSite=Lax"))
            return 200, {"detail": "CSRF cookie set"}, send_headers

        if route == "/api/hello" and method == "GET":
            return 200, {"message": "Hello, World!"}, []

        if route == "/api/vision-models" and method == "GET":
            page = int(query.get("page", ["1"])[0])
            models = [self._public_model(m) for m in self.store.list_models()]
            return 200, paginate(models, page, PAGE_SIZE,
                                 "/api/vision-models/"), []

        if route.startswith("/api/vision-models/") and method == "GET":
            model = self.store.get_model(_int_or(route.split("/")[-1]))
            if model is None:
                return 404, {"detail": "Not found."}, []
            return 200, self._public_model(model), []

        if route == "/api/metrics" and method == "GET":
            return 200, {
                "total_photos_analyzed": self.store.count_jobs(),
                "total_failures_detected": self.store.count_jobs("DONE"),
                "total_users": self.store.count_users(),
            }, []

        if route.startswith("/api/users/"):
            return self._handle_users(method, route, headers, body, cookies)

        if route == "/api/inference-jobs":
            if method == "GET":
                return self._list_jobs(query, cookies)
            if method == "POST":
                if not self._check_csrf(cookies, headers):
                    return 403, {"detail": "CSRF verification failed."}, []
                return self._create_job(headers, body, cookies)

        if route.startswith("/api/inference-jobs/"):
            parts = route.split("/")
            job_id = parts[3]
            if len(parts) == 5 and parts[4] == "complete" and method == "POST":
                return self._complete_job(job_id, headers, body)
            if method == "GET":
                job = self.store.get_job(job_id)
                if job is None:
                    return 404, {"detail": "Not found."}, []
                user = self._current_user(cookies)
                if job["user_id"] is not None and (
                        user is None or user["id"] != job["user_id"]):
                    return 404, {"detail": "Not found."}, []
                # ?wait=N long-poll (beyond the reference, which only
                # supports client-side poll loops): block up to N seconds
                # for DONE/FAILED. Orders of magnitude fewer requests than
                # sleep-loop polling — see store.wait_for_job.
                wait = _float_or(query.get("wait", [None])[0])
                if wait and job["status"] in ("PENDING", "PROCESSING"):
                    job = self.store.wait_for_job(job_id, wait)
                return 200, self._serialize_job(job), []

        if route == "/api/admin/profile" and method == "POST":
            # torch.profiler trace of the live serving workload (the
            # reference has no tracing at all, SURVEY.md §5). Session + CSRF
            # gated like the admin page.
            if self._current_user(cookies) is None:
                return 403, {"detail": "Authentication required."}, []
            if not self._check_csrf(cookies, headers):
                return 403, {"detail": "CSRF verification failed."}, []
            return self._capture_profile(_json_body(body))

        if route == "/api/schema" and method == "GET":
            from visiontransformer_tpu_torch.serve.schema import openapi_schema
            return 200, openapi_schema(), []

        return 404, {"detail": "Not found."}, []

    # ---------------------------------------------------------- users app
    def _handle_users(self, method, route, headers, body, cookies):
        if route == "/api/users/register" and method == "POST":
            data = _json_body(body)
            username = (data.get("username") or "").strip()
            password = data.get("password") or ""
            if not username or not password:
                return 400, {"detail": "username and password required"}, []
            if self.store.get_user_by_name(username):
                return 400, {"detail": "username already exists"}, []
            user = self.store.create_user(username, password,
                                          data.get("email", ""))
            return 201, {"id": user["id"], "username": user["username"]}, []

        if route == "/api/users/login" and method == "POST":
            data = _json_body(body)
            user = self.store.authenticate(data.get("username", ""),
                                           data.get("password", ""))
            if user is None:
                return 400, {"detail": "Invalid credentials"}, []
            token = self.signer.create(user["username"])
            cookie = (f"sessionid={token}; Path=/; HttpOnly; SameSite=Lax")
            return 200, {"id": user["id"], "username": user["username"]}, [
                ("Set-Cookie", cookie)]

        if route == "/api/users/logout" and method == "POST":
            return 200, {"detail": "Logged out"}, [
                ("Set-Cookie",
                 "sessionid=; Path=/; Max-Age=0")]

        if route == "/api/users/current-user" and method == "GET":
            user = self._current_user(cookies)
            if user is None:
                return 403, {"detail": "Not authenticated"}, []
            return 200, {"id": user["id"], "username": user["username"],
                         "email": user["email"]}, []

        return 404, {"detail": "Not found."}, []

    # -------------------------------------------------------------- admin
    def _capture_profile(self, opts: Dict):
        """Blocking torch.profiler capture of the live workload (host and,
        where present, CUDA activity); one at a time. Writes
        ``trace.json`` (Chrome trace format) into the returned trace
        directory."""
        import time as _time

        seconds = min(max(float(opts.get("seconds", 3) or 3), 0.1), 60.0)
        trace_dir = opts.get("trace_dir") or os.path.join(
            self.store.media_root, "traces",
            _time.strftime("%Y%m%d-%H%M%S"))
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"detail": "a profile capture is already running"}, []
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            # The context manager stops the profiler on every exit path, so
            # a failed export cannot leave a session active.
            with profile(activities=activities) as prof:
                _time.sleep(seconds)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        except Exception as exc:
            return 500, {"detail": f"profiler error: {exc}"}, []
        finally:
            self._profile_lock.release()
        return 200, {"trace_dir": trace_dir, "seconds": seconds}, []

    def render_admin(self) -> str:
        """Read-only operations dashboard (the role of the reference's
        Django admin registrations, reference backend/core/admin.py:5-14).

        Every interpolated value is html.escape()d — usernames, model names,
        and error messages (which echo exception text) are attacker-
        influenced. Access is gated by session auth in the handler, matching
        Django admin's staff-login requirement."""
        import html as _html

        def esc(v) -> str:
            return _html.escape(str(v), quote=True)

        jobs = self.store.list_jobs()[:50]
        models = self.store.list_models()
        rows_j = "".join(
            f"<tr><td>{esc(j['id'][:8])}</td><td>{esc(j['status'])}</td>"
            f"<td>{esc(j['user_username'] or '-')}</td>"
            f"<td>{esc(j['vision_model'])}</td>"
            f"<td>{esc(j['created_at'][:19])}</td>"
            f"<td>{esc((j['error_message'] or '')[:60])}</td></tr>"
            for j in jobs)
        rows_m = "".join(
            f"<tr><td>{esc(m['id'])}</td><td>{esc(m['name'])}</td>"
            f"<td>{esc(m['config_name'])}</td><td>{esc(m['num_classes'])}</td>"
            f"<td>{esc(m['input_size'])}</td></tr>" for m in models)
        worker = self.worker
        worker_line = (f"embedded worker: {worker.processed} jobs processed"
                       if worker else "external-orchestrator mode (no worker)")
        return f"""<!doctype html><html lang="en"><head><title>vitseg admin</title>
<style>body{{font-family:sans-serif;margin:2em;color:#111;background:#fff}}
table{{border-collapse:collapse}}
td,th{{border:1px solid #767676;padding:4px 8px;font-size:13px}}
.sr{{position:absolute;left:-9999px}}</style></head>
<body><h1>visiontransformer_tpu_torch — operations</h1>
<p>{worker_line} · jobs total {self.store.count_jobs()} ·
done {self.store.count_jobs('DONE')} · failed {self.store.count_jobs('FAILED')}
· users {self.store.count_users()}</p>
<h2>Vision models</h2>
<table><caption class="sr">Registered vision models</caption>
<tr><th scope="col">id</th><th scope="col">name</th><th scope="col">config</th>
<th scope="col">classes</th><th scope="col">input</th></tr>{rows_m}</table>
<h2>Latest jobs</h2>
<table><caption class="sr">Fifty most recent inference jobs</caption>
<tr><th scope="col">id</th><th scope="col">status</th><th scope="col">user</th>
<th scope="col">model</th><th scope="col">created</th>
<th scope="col">error</th></tr>{rows_j}</table>
</body></html>"""

    # ---------------------------------------------------------- job CRUD
    def _list_jobs(self, query, cookies):
        user = self._current_user(cookies)
        if user is None:
            return 403, {"detail": "Authentication required to list jobs."}, []
        status = query.get("status", [None])[0]
        jobs = self.store.list_jobs(user_id=user["id"], status=status)
        page = int(query.get("page", ["1"])[0])
        payload = paginate([self._serialize_job(j) for j in jobs], page,
                           PAGE_SIZE, "/api/inference-jobs/")
        return 200, payload, []

    def _create_job(self, headers, body, cookies):
        content_type = headers.get("content-type", "")
        if "multipart/form-data" not in content_type:
            return 400, {"detail": "multipart/form-data required"}, []
        fields, files = parse_multipart(body, content_type)
        model_id = _int_or(fields.get("vision_model"))
        upload = files.get("input_image")
        if model_id is None or upload is None:
            return 400, {"detail": "vision_model and input_image required"}, []
        if self.store.get_model(model_id) is None:
            return 400, {"detail": f"unknown vision_model {model_id}"}, []

        # Whitelist the stored extension: a client-supplied .html/.svg name
        # would otherwise be served back as active content from the API
        # origin (stored XSS). Unknown extensions fall back to .png.
        ext = os.path.splitext(upload.filename)[1].lower()
        if ext not in _IMAGE_EXTENSIONS:
            ext = ".png"
        input_dir = os.path.join(self.store.media_root, "inputs")
        os.makedirs(input_dir, exist_ok=True)
        input_path = os.path.join(input_dir, f"{_uuid.uuid4()}{ext}")
        with open(input_path, "wb") as f:
            f.write(upload.content)

        user = self._current_user(cookies)
        job = self.store.create_job(user["id"] if user else None, model_id,
                                    input_path)
        if self.orch_url:
            import threading
            threading.Thread(target=self._push_to_orchestrator,
                             args=(job["id"],), daemon=True).start()
        return 201, self._serialize_job(job), []

    def _push_to_orchestrator(self, job_id: str) -> None:
        """POST {job_id, vision_model_id, input_image} multipart to the
        orchestrator, expecting 202 (the reference's contract,
        views.py:107-110). Non-202/unreachable -> FAILED with a message."""
        import urllib.error
        import urllib.request

        job = self.store.get_job(job_id)
        try:
            with open(job["input_image"], "rb") as f:
                image = f.read()
            boundary = "vitsegorch"
            parts = []
            for name, value in (("job_id", job["id"]),
                                ("vision_model_id", str(job["vision_model"]))):
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{name}"\r\n\r\n{value}\r\n'.encode())
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="input_image"; filename="input"\r\n'
                f'Content-Type: application/octet-stream\r\n\r\n'.encode()
                + image + b"\r\n")
            parts.append(f"--{boundary}--\r\n".encode())
            req = urllib.request.Request(self.orch_url, b"".join(parts))
            req.add_header("Content-Type",
                           f"multipart/form-data; boundary={boundary}")
            req.add_header("X-ORCH-TOKEN", self.orch_token)
            resp = urllib.request.urlopen(req, timeout=60)
            if resp.status != 202:
                self.store.fail_job(job_id,
                                    f"orchestrator returned {resp.status}")
        except Exception as exc:
            self.store.fail_job(job_id, f"orchestrator unreachable: {exc}")

    def _complete_job(self, job_id, headers, body):
        # When an orchestrator token is configured, the completion callback
        # must present it — otherwise anyone with a job UUID could attach an
        # arbitrary mask. (The reference's complete action sits behind DRF's
        # default IsAuthenticated, backend/project/settings.py:52-64.)
        if self.orch_token and not hmac.compare_digest(
                headers.get("x-orch-token", ""), self.orch_token):
            return 403, {"detail": "Invalid orchestrator token."}, []
        job = self.store.get_job(job_id)
        if job is None:
            return 404, {"detail": "Not found."}, []
        if job["status"] == "DONE":
            return 400, {"error": "Job already completed."}, []
        content_type = headers.get("content-type", "")
        if "multipart/form-data" not in content_type:
            return 400, {"error": "mask_image is required."}, []
        _, files = parse_multipart(body, content_type)
        mask = files.get("mask_image")
        if mask is None:
            return 400, {"error": "mask_image is required."}, []
        mask_dir = os.path.join(self.store.media_root, "masks")
        os.makedirs(mask_dir, exist_ok=True)
        # Same stored-XSS whitelist as _create_job: a client-supplied .svg
        # name would be served back as image/svg+xml — an ACTIVE content
        # type — from the API origin.
        ext = os.path.splitext(mask.filename)[1].lower()
        if ext not in _IMAGE_EXTENSIONS:
            ext = ".png"
        mask_path = os.path.join(mask_dir, f"{job_id}{ext}")
        with open(mask_path, "wb") as f:
            f.write(mask.content)
        completed = self.store.complete_job(job_id, mask_path)
        if completed is None:
            return 400, {"error": "Job already completed."}, []
        return 200, self._serialize_job(completed), []


def _media_url(path: Optional[str], store: JobStore) -> Optional[str]:
    if not path:
        return None
    rel = os.path.relpath(path, store.media_root)
    return f"/media/{rel}"


def _json_body(body: bytes) -> Dict:
    try:
        return json.loads(body.decode() or "{}")
    except json.JSONDecodeError:
        return {}


def _int_or(value, default=None):
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def _float_or(value, default=None):
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


class _Handler(BaseHTTPRequestHandler):
    app: ServingApp = None  # set by create_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _dispatch(self, method: str):
        parsed = urlparse(self.path)
        if parsed.path.startswith("/media/") and method == "GET":
            return self._serve_media(parsed.path)
        if method == "GET" and parsed.path.rstrip("/") in (
                "/api/schema/swagger-ui", "/api/schema/redoc"):
            # Human-readable API docs (reference backend/project/urls.py:30-32).
            from visiontransformer_tpu_torch.serve.schema import (
                redoc_html,
                swagger_ui_html,
            )
            page = (swagger_ui_html() if "swagger" in parsed.path
                    else redoc_html()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.send_header("X-Content-Type-Options", "nosniff")
            self.end_headers()
            self.wfile.write(page)
            return
        if parsed.path.rstrip("/") == "/admin" and method == "GET":
            # Gated behind session auth (Django admin requires staff login,
            # reference backend/project/urls.py:24).
            cookies = parse_cookies(self.headers.get("Cookie"))
            if self.app._current_user(cookies) is None:
                data = json_bytes({"detail": "Authentication required."})
                self.send_response(403)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            html = self.app.render_admin().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(html)))
            self.send_header("X-Content-Type-Options", "nosniff")
            self.end_headers()
            self.wfile.write(html)
            return
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        cookies = parse_cookies(self.headers.get("Cookie"))
        headers = {k.lower(): v for k, v in self.headers.items()}
        try:
            status, payload, extra = self.app.handle(
                method, parsed.path, parse_qs(parsed.query), headers, body,
                cookies)
        except ValueError as exc:  # malformed multipart/params -> client error
            status, payload, extra = 400, {"detail": str(exc)}, []
        except Exception:  # noqa: BLE001 — never drop the connection
            import traceback
            traceback.print_exc()
            status, payload, extra = 500, {"detail": "Internal error"}, []
        data = json_bytes(payload)
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _serve_media(self, path: str):
        rel = path[len("/media/"):]
        full = os.path.normpath(os.path.join(self.app.store.media_root, rel))
        root = os.path.abspath(self.app.store.media_root)
        if not os.path.abspath(full).startswith(root + os.sep) or \
                not os.path.isfile(full):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        # Defense in depth vs stored XSS: never serve media as an active
        # content type; force download for anything that isn't an image.
        # SVG counts as active — image/svg+xml documents execute script.
        if not ctype.startswith("image/") or ctype == "image/svg+xml":
            ctype = "application/octet-stream"
        with open(full, "rb") as f:
            data = f.read()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Content-Type-Options", "nosniff")
        if not ctype.startswith("image/"):
            self.send_header("Content-Disposition", "attachment")
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def create_server(store: JobStore, *, host: str = "127.0.0.1", port: int = 0,
                  worker=None, orch_url=None,
                  orch_token: str = "") -> Tuple[ThreadingHTTPServer, ServingApp]:
    """Build (server, app); caller starts serve_forever (usually in a
    thread) and the worker separately."""
    app = ServingApp(store, worker=worker, orch_url=orch_url,
                     orch_token=orch_token)
    handler = type("BoundHandler", (_Handler,), {"app": app})

    class _Server(ThreadingHTTPServer):
        # The socketserver default backlog is 5; concurrent clients without
        # keep-alive burst far past that and get RST (measured: 32 pollers
        # reset mid-benchmark). Gunicorn's default backlog is 2048 — match
        # the same order of magnitude.
        request_queue_size = 512
        daemon_threads = True

    server = _Server((host, port), handler)
    return server, app


def build_arg_parser():
    """CLI for the serving platform (also reached via
    `python -m visiontransformer_tpu_torch serve`)."""
    import argparse

    parser = argparse.ArgumentParser(description="GPU serving platform")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--db", default="serving.db")
    parser.add_argument("--media-root", default="media")
    parser.add_argument("--no-worker", action="store_true",
                        help="external-orchestrator mode: jobs stay PENDING "
                             "until POST /complete/")
    parser.add_argument("--orch-url", default=os.environ.get("ORCH_URL"),
                        help="push created jobs to this orchestrator URL "
                             "(multipart, X-ORCH-TOKEN header)")
    parser.add_argument("--orch-token",
                        default=os.environ.get("ORCH_SHARED_TOKEN", ""))
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip pre-compiling batch buckets at model "
                             "load (faster startup, slower first jobs)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the inference worker; the CPU "
                             "runs only when asked for (--device cpu)")
    return parser


def main(argv=None):  # pragma: no cover - manual entry point
    from visiontransformer_tpu_torch.serve.worker import InferenceWorker

    args = build_arg_parser().parse_args(argv)

    store = JobStore(args.db, media_root=args.media_root)
    if not store.list_models():
        store.register_model("vit-b16-damage", num_classes=17,
                             config_name="P16H768A12",
                             description="ViT-B/16 multiclass damage model")
    worker = None
    if not args.no_worker:
        worker = InferenceWorker(store, warmup=not args.no_warmup,
                                 device=args.device)
        worker.start()
    server, _ = create_server(store, host=args.host, port=args.port,
                              worker=worker, orch_url=args.orch_url,
                              orch_token=args.orch_token)
    print(f"serving on {args.host}:{args.port}")
    try:
        server.serve_forever()
    finally:
        if worker:
            worker.stop()


if __name__ == "__main__":
    main()
