"""Persistence for the serving platform: users, model registry, jobs.

Replaces the reference's Postgres + Django ORM layer
(reference backend/core/models.py: VisionModel :24-36, InferenceJob :39-66
with UUID pk, status PENDING/PROCESSING/DONE/FAILED, error_message;
backend/users via django.contrib.auth) with SQLite in WAL mode.

Design fixes over the reference (SURVEY.md §5 race/failure findings):
- job claiming is an atomic conditional UPDATE (PENDING→PROCESSING), so two
  workers can never grab the same job — the reference's daemon-thread dispatch
  plus non-transactional read-then-write complete() has no such guarantee
  (reference backend/core/views.py:91-95, 127-144);
- FAILED + error_message are actually set on worker errors (the reference
  defines the fields but no code path ever writes them, views.py:110-114);
- jobs are owned by the authenticated submitting user (the reference assigns
  every job to the first user in the DB, views.py:58-63, 83-85).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import os
import secrets
import sqlite3
import threading
import time
import uuid
from typing import Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    username TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL,
    email TEXT DEFAULT '',
    created_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS photos (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER REFERENCES users(id),
    image TEXT NOT NULL,
    caption TEXT DEFAULT '',
    uploaded_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS vision_models (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    description TEXT DEFAULT '',
    num_classes INTEGER NOT NULL,
    input_size INTEGER NOT NULL DEFAULT 224,
    config_name TEXT NOT NULL,
    model_family TEXT NOT NULL DEFAULT 'vitseg',
    checkpoint_path TEXT DEFAULT '',
    token_merge_r INTEGER NOT NULL DEFAULT 0,
    quantize TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS jobs (
    id TEXT PRIMARY KEY,
    user_id INTEGER REFERENCES users(id),
    vision_model_id INTEGER NOT NULL REFERENCES vision_models(id),
    status TEXT NOT NULL DEFAULT 'PENDING',
    input_image TEXT NOT NULL,
    mask_image TEXT DEFAULT '',
    error_message TEXT DEFAULT '',
    detections TEXT DEFAULT '',
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS jobs_status ON jobs(status);
CREATE INDEX IF NOT EXISTS jobs_user ON jobs(user_id, created_at DESC);
"""

STATUSES = ("PENDING", "PROCESSING", "DONE", "FAILED")


def _now() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat()


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    salt = salt or secrets.token_bytes(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 100_000)
    return f"pbkdf2${salt.hex()}${digest.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        _, salt_hex, digest_hex = stored.split("$")
    except ValueError:
        return False
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), 100_000)
    return hmac.compare_digest(digest.hex(), digest_hex)


class JobStore:
    """Thread-safe store; one sqlite connection per thread."""

    def __init__(self, path: str = ":memory:", media_root: str = "media"):
        self.path = path
        self.media_root = media_root
        os.makedirs(media_root, exist_ok=True)
        self._local = threading.local()
        self._memory_conn = None
        if path == ":memory:":
            # A single shared connection (with a lock) for in-memory DBs.
            self._memory_conn = sqlite3.connect(":memory:",
                                                check_same_thread=False)
            self._memory_lock = threading.Lock()
        # Long-poll support: each waiter registers a per-job Event; a
        # terminal transition (DONE/FAILED) wakes only that job's waiters.
        # Cheaper by orders of magnitude than clients hammering
        # GET /jobs/{id}/ in a sleep loop (measured: 37k polls saturating
        # the single core), and than a shared Condition.notify_all(), whose
        # thundering herd woke every parked long-poller on every completion
        # — N_clients SQLite re-reads per DONE (measured by sampling
        # profile, docs/PERFORMANCE.md round 4).
        self._waiters: Dict[str, List[threading.Event]] = {}
        self._waiters_lock = threading.Lock()
        with self._conn() as c:
            c.executescript(_SCHEMA)
            # Migration for databases created before the model_family
            # column existed (CREATE IF NOT EXISTS won't extend them).
            cols = [r[1] for r in c.execute(
                "PRAGMA table_info(vision_models)").fetchall()]
            if "model_family" not in cols:
                c.execute("ALTER TABLE vision_models ADD COLUMN"
                          " model_family TEXT NOT NULL DEFAULT 'vitseg'")
            if "token_merge_r" not in cols:
                c.execute("ALTER TABLE vision_models ADD COLUMN"
                          " token_merge_r INTEGER NOT NULL DEFAULT 0")
            if "quantize" not in cols:
                c.execute("ALTER TABLE vision_models ADD COLUMN"
                          " quantize TEXT NOT NULL DEFAULT ''")

    def _notify_terminal(self, job_id: str) -> None:
        with self._waiters_lock:
            events = self._waiters.pop(job_id, ())
        for ev in events:
            ev.set()

    def wait_for_job(self, job_id: str, timeout: float) -> Optional[Dict]:
        """Return the job, blocking up to `timeout` seconds for it to reach
        a terminal status (DONE/FAILED). Returns the latest row either way."""
        deadline = time.monotonic() + max(0.0, min(timeout, 60.0))
        ev = threading.Event()
        # Register BEFORE the status check: a completion landing between
        # an unregistered check and the wait would notify no one and cost
        # a full wait period.
        with self._waiters_lock:
            self._waiters.setdefault(job_id, []).append(ev)
        try:
            job = self.get_job(job_id)
            while job is not None and job["status"] in ("PENDING",
                                                        "PROCESSING"):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # 5 s safety tick: re-read even without a wakeup, in case a
                # transition happened through a path that doesn't notify
                # (e.g. another process writing the same SQLite file).
                ev.wait(min(remaining, 5.0))
                ev.clear()
                job = self.get_job(job_id)
        finally:
            with self._waiters_lock:
                lst = self._waiters.get(job_id)
                if lst is not None:
                    try:
                        lst.remove(ev)
                    except ValueError:
                        pass
                    if not lst:
                        self._waiters.pop(job_id, None)
        return job

    def _conn(self):
        if self._memory_conn is not None:
            return _LockedConn(self._memory_conn, self._memory_lock)
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            conn.execute("PRAGMA journal_mode=WAL")
            # WAL + NORMAL: commits skip the per-transaction fsync (the WAL
            # is synced at checkpoints). Crash-safe against application
            # crashes — an OS/power crash can lose the most recent commits
            # but never corrupts — the right trade for a job queue whose
            # worker already requeues stale PROCESSING rows at startup.
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute("PRAGMA busy_timeout=5000")
            self._local.conn = conn
        return _LockedConn(conn, threading.Lock())

    # ------------------------------------------------------------- users
    def create_user(self, username: str, password: str,
                    email: str = "") -> Dict:
        with self._conn() as c:
            c.execute(
                "INSERT INTO users (username, password_hash, email, created_at)"
                " VALUES (?,?,?,?)",
                (username, hash_password(password), email, _now()))
        # Outside the with-block: the store lock is not reentrant.
        return self.get_user_by_name(username)

    def get_user_by_name(self, username: str) -> Optional[Dict]:
        with self._conn() as c:
            row = c.execute(
                "SELECT id, username, password_hash, email FROM users"
                " WHERE username=?", (username,)).fetchone()
        if not row:
            return None
        return {"id": row[0], "username": row[1], "password_hash": row[2],
                "email": row[3]}

    def authenticate(self, username: str, password: str) -> Optional[Dict]:
        user = self.get_user_by_name(username)
        if user and verify_password(password, user["password_hash"]):
            return user
        return None

    def count_users(self) -> int:
        with self._conn() as c:
            return c.execute("SELECT COUNT(*) FROM users").fetchone()[0]

    # ------------------------------------------------------------ photos
    # User photo album (the reference's Photo model exists but is unused by
    # its API, reference backend/core/models.py:9-21 — kept for parity).
    def add_photo(self, user_id: Optional[int], image_path: str,
                  caption: str = "") -> int:
        with self._conn() as c:
            cur = c.execute(
                "INSERT INTO photos (user_id, image, caption, uploaded_at)"
                " VALUES (?,?,?,?)", (user_id, image_path, caption, _now()))
            return cur.lastrowid

    def list_photos(self, user_id: Optional[int] = None) -> List[Dict]:
        query = "SELECT id, user_id, image, caption, uploaded_at FROM photos"
        args = []
        if user_id is not None:
            query += " WHERE user_id=?"
            args.append(user_id)
        with self._conn() as c:
            rows = c.execute(query + " ORDER BY uploaded_at DESC",
                             args).fetchall()
        return [{"id": r[0], "user_id": r[1], "image": r[2],
                 "caption": r[3], "uploaded_at": r[4]} for r in rows]

    # ------------------------------------------------------- vision models
    def register_model(self, name: str, *, num_classes: int,
                       config_name: str, description: str = "",
                       input_size: int = 224,
                       checkpoint_path: str = "",
                       model_family: str = "vitseg",
                       token_merge_r: int = 0,
                       quantize: str = "") -> int:
        """model_family: "vitseg" (config_name is a sweep config) or a
        conv family (config_name is an encoder preset) — the serving-side
        face of the model registry (models/registry.py). token_merge_r:
        opt-in ToMe acceleration for vitseg rows (ops/token_merge.py;
        measured near-lossless on trained models, docs/PERFORMANCE.md).
        quantize: "" (exact) or "int8" — W8A8 dynamic quantization of the
        model's dense/conv weights, any family but sam (ops/quant.py;
        measured ~1.18x the vitseg serving pipeline, near-lossless on
        trained models). A "sam" row (config_name a SAM preset) is served
        with a box prompt an image and takes neither opt-in."""
        if token_merge_r and model_family != "vitseg":
            raise ValueError("token_merge_r applies to vitseg models only")
        if quantize not in ("", "int8"):
            raise ValueError("quantize must be '' or 'int8'")
        if quantize and model_family == "sam":
            raise ValueError("the int8 opt-in is not defined for sam")
        with self._conn() as c:
            cur = c.execute(
                "INSERT OR REPLACE INTO vision_models"
                " (name, description, num_classes, input_size, config_name,"
                "  model_family, checkpoint_path, token_merge_r, quantize)"
                " VALUES (?,?,?,?,?,?,?,?,?)",
                (name, description, num_classes, input_size, config_name,
                 model_family, checkpoint_path, token_merge_r, quantize))
            return cur.lastrowid

    _MODEL_COLS = ("id, name, description, num_classes, input_size,"
                   " config_name, model_family, checkpoint_path,"
                   " token_merge_r, quantize")

    def list_models(self) -> List[Dict]:
        with self._conn() as c:
            rows = c.execute(
                f"SELECT {self._MODEL_COLS} FROM vision_models"
                " ORDER BY name").fetchall()
        return [self._model_dict(r) for r in rows]

    def get_model(self, model_id: int) -> Optional[Dict]:
        with self._conn() as c:
            row = c.execute(
                f"SELECT {self._MODEL_COLS} FROM vision_models WHERE id=?",
                (model_id,)).fetchone()
        return self._model_dict(row) if row else None

    @staticmethod
    def _model_dict(row) -> Dict:
        return {"id": row[0], "name": row[1], "description": row[2],
                "num_classes": row[3], "input_size": row[4],
                "config_name": row[5], "model_family": row[6],
                "checkpoint_path": row[7], "token_merge_r": row[8],
                "quantize": row[9]}

    # --------------------------------------------------------------- jobs
    def create_job(self, user_id: Optional[int], vision_model_id: int,
                   input_image_path: str) -> Dict:
        job_id = str(uuid.uuid4())
        now = _now()
        with self._conn() as c:
            c.execute(
                "INSERT INTO jobs (id, user_id, vision_model_id, status,"
                " input_image, created_at, updated_at) VALUES (?,?,?,?,?,?,?)",
                (job_id, user_id, vision_model_id, "PENDING",
                 input_image_path, now, now))
        return self.get_job(job_id)

    def get_job(self, job_id: str) -> Optional[Dict]:
        with self._conn() as c:
            row = c.execute(
                "SELECT j.id, j.user_id, j.vision_model_id, j.status,"
                " j.input_image, j.mask_image, j.error_message, j.detections,"
                " j.created_at, j.updated_at, u.username"
                " FROM jobs j LEFT JOIN users u ON u.id = j.user_id"
                " WHERE j.id=?", (job_id,)).fetchone()
        return self._job_dict(row) if row else None

    def list_jobs(self, user_id: Optional[int] = None,
                  status: Optional[str] = None) -> List[Dict]:
        query = ("SELECT j.id, j.user_id, j.vision_model_id, j.status,"
                 " j.input_image, j.mask_image, j.error_message, j.detections,"
                 " j.created_at, j.updated_at, u.username"
                 " FROM jobs j LEFT JOIN users u ON u.id = j.user_id")
        clauses, args = [], []
        if user_id is not None:
            clauses.append("j.user_id=?")
            args.append(user_id)
        if status:
            clauses.append("j.status=?")
            args.append(status.upper())
        if clauses:
            query += " WHERE " + " AND ".join(clauses)
        query += " ORDER BY j.created_at DESC"
        with self._conn() as c:
            rows = c.execute(query, args).fetchall()
        return [self._job_dict(r) for r in rows]

    def requeue_stale_processing(self, older_than_s: float = 300.0) -> int:
        """PROCESSING -> PENDING for jobs whose worker died (crash
        recovery; the reference leaves such jobs stuck forever,
        SURVEY.md §5 failure-detection gap). Returns the number requeued."""
        cutoff = (_dt.datetime.now(_dt.timezone.utc)
                  - _dt.timedelta(seconds=older_than_s)).isoformat()
        with self._conn() as c:
            cur = c.execute(
                "UPDATE jobs SET status='PENDING', updated_at=?"
                " WHERE status='PROCESSING' AND updated_at < ?",
                (_now(), cutoff))
            return cur.rowcount

    def claim_pending_jobs(self, limit: int) -> List[Dict]:
        """Atomically move up to `limit` PENDING jobs to PROCESSING and
        return them — the by-construction fix for the reference's dispatch
        race (a job can be claimed exactly once)."""
        claimed = []
        with self._conn() as c:
            rows = c.execute(
                "SELECT id FROM jobs WHERE status='PENDING'"
                " ORDER BY created_at LIMIT ?", (limit,)).fetchall()
            for (job_id,) in rows:
                cur = c.execute(
                    "UPDATE jobs SET status='PROCESSING', updated_at=?"
                    " WHERE id=? AND status='PENDING'", (_now(), job_id))
                if cur.rowcount == 1:
                    claimed.append(job_id)
        return [self.get_job(j) for j in claimed]

    def complete_job(self, job_id: str, mask_image_path: str,
                     detections_json: str = "") -> Optional[Dict]:
        """DONE transition; refuses if already DONE (the reference's
        double-completion guard, views.py:129-133) — atomically."""
        with self._conn() as c:
            cur = c.execute(
                "UPDATE jobs SET status='DONE', mask_image=?, detections=?,"
                " updated_at=? WHERE id=? AND status != 'DONE'",
                (mask_image_path, detections_json, _now(), job_id))
            if cur.rowcount == 0:
                return None
        self._notify_terminal(job_id)
        return self.get_job(job_id)

    def fail_job(self, job_id: str, error_message: str) -> None:
        with self._conn() as c:
            c.execute(
                "UPDATE jobs SET status='FAILED', error_message=?,"
                " updated_at=? WHERE id=?",
                (error_message[:1000], _now(), job_id))
        self._notify_terminal(job_id)

    def count_jobs(self, status: Optional[str] = None) -> int:
        with self._conn() as c:
            if status:
                return c.execute("SELECT COUNT(*) FROM jobs WHERE status=?",
                                 (status,)).fetchone()[0]
            return c.execute("SELECT COUNT(*) FROM jobs").fetchone()[0]

    @staticmethod
    def _job_dict(row) -> Dict:
        return {
            "id": row[0], "user_id": row[1], "vision_model": row[2],
            "status": row[3], "input_image": row[4],
            "mask_image": row[5] or None, "error_message": row[6],
            "detections": row[7], "created_at": row[8], "updated_at": row[9],
            "user_username": row[10],
        }


class _LockedConn:
    """Context manager: lock + transaction around a shared connection."""

    def __init__(self, conn: sqlite3.Connection, lock: threading.Lock):
        self._conn = conn
        self._lock = lock

    def __enter__(self):
        self._lock.acquire()
        return self._conn

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                self._conn.commit()
            else:
                self._conn.rollback()
        finally:
            self._lock.release()
        return False
