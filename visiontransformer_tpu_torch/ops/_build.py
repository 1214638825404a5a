"""Builds the port's CUDA sources (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers: a few seconds per
file instead of minutes). All sources build together, one ``nvcc`` process
each, the first time any kernel is needed; importing the package builds
nothing. Libraries land in ``_build/<hash>/`` beside the package, keyed by a
hash of the sources, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds and an unchanged tree is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The ten kernels (the TPU package's nine Pallas kernels and the LayerNorm,
# PERF.md's table) by the wrapper that counts their launches, and the
# source each is built from.
KERNELS = {
    "flash_attention_fwd": "flash_attention_fwd",
    "flash_attention_fwd_train": "flash_attention_fwd",
    "flash_attention_bwd_dq": "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv": "flash_attention_bwd_dkv",
    "upsample_argmax": "upsample_argmax",
    "flash_variant": "flash_variants",
    "flash_multiq": "flash_chains",
    "flash_pvt": "flash_chains",
    "flash_dualq_pvt": "flash_chains",
    "layer_norm": "layer_norm",
}

_LOCK = threading.RLock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds the last build took (0.0 when every library was already built).
last_build_seconds = 0.0


def _nvcc() -> str:
    candidates = [os.path.join(os.environ[var], "bin", "nvcc")
                  for var in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(var)]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def build_dir() -> Path:
    """Keyed by the flags, every source and every shared header."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def _build_all(out_dir: Path) -> None:
    """Compile every source not yet built in ``out_dir``, all at once."""
    global last_build_seconds
    todo = {name: src for name, src in sources().items()
            if not (out_dir / f"lib{name}.so").exists()}
    if not todo:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out_dir / f"lib{name}.so")
        else:
            failed.append(name)
    last_build_seconds = time.perf_counter() - start
    if failed:
        logs = "\n".join((out_dir / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def built() -> Dict[str, bool]:
    """Whether each of ``KERNELS`` is built for the sources as they are."""
    out_dir = build_dir()
    return {name: (out_dir / f"lib{src}.so").exists()
            for name, src in KERNELS.items()}


def build() -> Path:
    """Build every source not built yet; returns the build directory."""
    with _LOCK:
        out_dir = build_dir()
        _build_all(out_dir)
        return out_dir


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources on
    the first call. ``signatures`` maps each C function the caller uses to
    its (argtypes, restype), declared once at load."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
            signatures = {**signatures,
                          "vt_error_string": ([ctypes.c_int], ctypes.c_char_p)}
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib.vt_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
