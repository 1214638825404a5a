"""A/B of the tuning-sweep kernels 6-9 across builds, on the GPU.

Builds several source sets of ``csrc/flash_variants.cu`` and
``csrc/flash_chains.cu`` side by side, each into ``_build/ab/<name>/``:

  tree        this checkout's ``csrc/``, always;
  --set N D   the sources in directory D (for example the parent commit's
              ``csrc/``, unpacked with ``git archive``);
  --sub N F OLD NEW
              this checkout's sources with OLD replaced by NEW (once) in
              file F, e.g. a design constant; repeated with one N, the
              replacements add up.

Each set then runs in its own process, in turns (a, b, ..., b, a): every
instantiation of kernels 6 (3 modes x key tiles 32, 64, 128) and 7-9
(dualq, quadq, pvT, dualq_pvT x key tiles 32, 64) is checked against its
plain version at chip_smoke.py's gates and timed by chip_smoke.py's
``device_ms`` at (192, 1025, 64) and (384, 197, 64), beside SDPA, on
slices of a (B, N, 3, H, 64) tensor. Sets that report them also give each
instantiation's registers, blocks an SM and spilled bytes. One JSON line
per case (mean of the two turns) goes to stdout, and to ``--out``.

    python -m visiontransformer_tpu_torch.scripts.kernel_ab \\
        [--set NAME DIR] [--sub NAME FILE OLD NEW] [--out PATH]

Run it from the repository root (it uses chip_smoke.py's timing and gates)
on a host with CUDA and nvcc; it is not used by the package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

from visiontransformer_tpu_torch.ops import _build

AB_ROOT = _build.BUILD_ROOT / "ab"
LIBS = ("flash_variants", "flash_chains")
SHAPES = ((16, 12, 1025), (32, 12, 197))  # (B, H, N): BH 192 and 384
# (kernel 6's mode, or kernels 7-9's (chains, transposed), block_k).
CASES = ([(m, bk) for m in ("base", "bf16exp", "exp2") for bk in (32, 64, 128)]
         + [(schedule, bk) for schedule in ((2, False), (4, False),
                                            (1, True), (2, True))
            for bk in (32, 64)])
CHAIN_NAMES = {(2, False): "dualq", (4, False): "quadq", (1, True): "pvT",
               (2, True): "dualq_pvT"}


def _label(case) -> str:
    what, bk = case
    return f"{CHAIN_NAMES.get(what, what)}/{bk}"


def _call(case, q, k, v):
    """(kernel call, its plain version's output) of one case."""
    from visiontransformer_tpu_torch.ops import flash_variants as fv

    what, bk = case
    if isinstance(what, str):
        return (lambda: fv.flash_variant(q, k, v, mode=what, block_k=bk),
                fv.variant_plain(q, k, v, mode=what, block_k=bk))
    chains, transposed = what
    if transposed:
        kernel, plain = ((fv.flash_pvt, fv.pvt_plain) if chains == 1 else
                         (fv.flash_dualq_pvt, fv.dualq_pvt_plain))
        return (lambda: kernel(q, k, v, block_k=bk),
                plain(q, k, v, block_k=bk))
    return (lambda: fv.flash_multiq(q, k, v, chains=chains, block_k=bk),
            fv.multiq_plain(q, k, v, block_k=bk))


def _sources(path: Path) -> dict:
    return {p.name: p.read_text() for p in sorted(path.iterdir())
            if p.suffix in (".cu", ".cuh")}


def source_sets(args) -> dict:
    tree = _sources(_build.CSRC_DIR)
    sets = {"tree": tree}
    for name, directory in args.set or ():
        sets[name] = _sources(Path(directory))
    for name, fname, old, new in args.sub or ():
        files = sets.setdefault(name, dict(tree))
        if files[fname].count(old) != 1:
            raise ValueError(f"--sub {name}: {old!r} is not once in {fname}")
        files[fname] = files[fname].replace(old, new)
    return sets


def build(sets: dict) -> None:
    """nvcc for every set and library at once, with the package's flags."""
    nvcc = _build._nvcc()
    procs = []
    for name, files in sets.items():
        out = AB_ROOT / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (out / fname).write_text(text)
        for lib in LIBS:
            log = open(out / f"{lib}.log", "w")
            procs.append((out / f"{lib}.log", log, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"lib{lib}.so"),
                 str(out / f"{lib}.cu")], stdout=log,
                stderr=subprocess.STDOUT)))
    for path, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            raise RuntimeError(f"nvcc failed:\n{path.read_text()[-4000:]}")


def _load(name: str):
    """Put set `name`'s libraries where the wrappers look them up."""
    from visiontransformer_tpu_torch.ops import flash_variants as fv
    for lib in LIBS:
        cdll = ctypes.CDLL(str(AB_ROOT / name / f"lib{lib}.so"))
        for fn, sig in fv._SIGNATURES[lib].items():
            if hasattr(cdll, fn):
                getattr(cdll, fn).argtypes, getattr(cdll, fn).restype = sig
        cdll.vt_error_string.argtypes = [ctypes.c_int]
        cdll.vt_error_string.restype = ctypes.c_char_p
        _build._LIBS[lib] = cdll


def _info(name: str) -> dict:
    """Registers, blocks an SM, threads, shared memory and spilled bytes
    of each instantiation, where the set's libraries report them (None
    where they do not)."""
    from visiontransformer_tpu_torch.ops import flash_variants as fv
    out = {}
    for case in CASES:
        what, bk = case
        try:
            out[_label(case)] = (fv.variant_info(what, bk)
                                 if isinstance(what, str)
                                 else fv.chains_info(*what, bk))
        except (AttributeError, RuntimeError):  # a set without that report
            out[_label(case)] = None
    return out


def child(name: str) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from visiontransformer_tpu_torch.ops import flash_variants as fv

    _load(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"set": name, "info": _info(name)}
    for b, h, n in SHAPES:
        qkv = torch.randn(b, n, 3, h, 64, generator=gen, device="cuda")
        qkv = qkv.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        row = {"sdpa": c.device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))}
        for case in CASES:
            fn, want = _call(case, q, k, v)
            ok, fields = c.flash_agrees(
                fn(), want, c.BF16EXP_TOL if case[0] == "bf16exp" else None)
            if not ok:
                raise AssertionError(f"{name} {_label(case)} at "
                                     f"{(b * h, n)} disagrees: {fields}")
            row[_label(case)] = c.device_ms(fn)
        result[f"{b * h}x{n}"] = row
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--set", nargs=2, action="append",
                   metavar=("NAME", "DIR"))
    p.add_argument("--sub", nargs=4, action="append",
                   metavar=("NAME", "FILE", "OLD", "NEW"))
    p.add_argument("--child", help=argparse.SUPPRESS)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    if not Path("chip_smoke.py").exists():
        raise SystemExit("run from the repository root (chip_smoke.py)")
    sets = source_sets(args)
    t0 = time.perf_counter()
    build(sets)
    names = list(sets)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        proc = subprocess.run(
            [sys.executable, "-m", "visiontransformer_tpu_torch.scripts."
             "kernel_ab", "--child", name], capture_output=True, text=True,
            timeout=600)
        if proc.returncode:
            raise RuntimeError(f"set {name} failed:\n{proc.stderr[-4000:]}")
        turns[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    lines = [{"build_s": time.perf_counter() - t0, "sets": names}]
    lines += [{"info": name, **turns[name][0]["info"]} for name in names]
    for b, h, n in SHAPES:
        shape = f"{b * h}x{n}"
        for case in turns[names[0]][0][shape]:
            lines.append({"shape": shape, "case": case, **{
                name: sum(t[shape][case] for t in turns[name]) / 2
                for name in names}})
    text = "\n".join(json.dumps(line) for line in lines)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
