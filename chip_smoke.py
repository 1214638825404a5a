"""GPU smoke test of the PyTorch/CUDA port (visiontransformer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). It builds the
port's kernels from visiontransformer_tpu_torch/csrc, then runs five
phases, each printing one JSON line, and raises (exit code != 0) on any
failure:

1. env       card, power limit, torch/CUDA versions, kernel build time;
2. flash     flash-attention kernel vs its plain version, bf16 and fp32,
             at the serving shape (B*H = 384, N = 197, d = 64), at
             N = 785/1025/3137, and at d = 80/16/32/128; timed against the
             plain version and F.scaled_dot_product_attention;
3. upsample  fused upsample+argmax kernel vs argmax(resize_bilinear_mm),
             (32, 14, 14, 17) -> 512^2 and 224^2, plus the tie case;
4. model     ViT-B/16 (17 classes, full width and depth, seeded random
             weights) on the bench workload: batch 32, 512^2 fp32 in,
             resize to 224^2, ImageNet normalize, vitseg_predict at 512^2;
             kernels vs plain paths in fp32 and bf16, launch counts per
             forward, masks/s;
5. serving   the port's HTTP server + InferenceWorker on cuda with the
             default P16H768A12 model; 8 PNG jobs through register/login/
             CSRF/POST/?wait= polling; every mask equals ModelRunner.predict
             of the same decoded image; jobs/s.

Then it prints the card's name and power limit as nvidia-smi gives them,
one JSON line describing every kernel of the main path (launches counted
during the serving run), and, last, {"ok": true, "device": {...}}.
Without CUDA it exits with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 rates (NVIDIA data sheets, dense): memory bytes/s, and
# operations/s for bf16 tensor-core math and for fp32 outside the tensor
# cores. SXM unless nvidia-smi names the PCIe card.
_PEAKS = {
    "sxm": {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12},
    "pcie": {"bytes": 2.0e12, "bf16": 756e12, "fp32": 51e12},
}

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# Flash, (atol, rtol). fp32 as the JAX package's flash tests. bf16 scales
# with each case's outputs, which shrink as N grows (randn inputs): atol is
# one bf16 ulp of the largest plain output (2^-7 * max|want|), rtol half an
# ulp; besides, the error's norm must stay within 2^-8 of the output's, so a
# small error shared by every output (a mis-masked key tail) cannot hide
# under the elementwise bound.
FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}
FLASH_BF16_REL_NORM = 2.0 ** -8
LOGITS_TOL = (5e-5, 1e-4)   # fp32 seg logits, atol / rtol
# The kernel and the plain epilogue differ only by FMA contraction (a few
# fp32 ulps), so a flip between them must sit on a logit gap below this.
UPSAMPLE_TIE_TOL = 1e-5
MIN_AGREEMENT = 0.9999


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(peaks, n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / peaks["bytes"] * 1e3
    t_ops = n_ops / peaks[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= atol + rtol * b.abs()).all())
    return ok, float(err.max())


def flash_agrees(got: torch.Tensor, want: torch.Tensor):
    """(ok, fields) of the flash kernel's output against its plain version
    on the same inputs, at FLASH_TOL for want's dtype (bf16: scaled to
    want, plus the error-norm gate)."""
    atol, rtol = FLASH_TOL[want.dtype]
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    rel_norm = float((got - want).norm() / want.norm())
    if bf16:
        atol *= float(want.abs().max())
    ok, err = close(got, want, atol, rtol)
    if bf16:
        ok = ok and rel_norm <= FLASH_BF16_REL_NORM
    return ok, {"max_abs_err": err, "atol": atol, "rtol": rtol,
                "rel_err_norm": rel_norm}


def ties_explained(plain_logits, got, want, tol):
    """(flips, largest logit gap at a flip): at each pixel where the
    kernel's class differs from the plain one, the plain logits of the two
    classes must tie within tol."""
    flips = got != want
    n = int(flips.sum())
    if n == 0:
        return 0, 0.0
    logits = plain_logits[flips]
    gap = (logits.gather(-1, want[flips].long()[:, None])
           - logits.gather(-1, got[flips].long()[:, None]))
    worst = float(gap.abs().max())
    if worst > tol:
        raise AssertionError(f"{n} argmax flips, largest logit gap {worst:.3g} "
                             f"> tie tolerance {tol}")
    return n, worst


# --------------------------------------------------------------------- phases
def phase_env():
    from visiontransformer_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    out_dir = _build.build()
    ptxas = []
    for log in sorted(out_dir.glob("*.log")):
        ptxas += [line.strip() for line in log.read_text().splitlines()
                  if "registers" in line or "spill" in line]
    print("\n".join(ptxas), file=sys.stderr)
    peaks = _PEAKS["pcie" if "PCIe" in smi else "sxm"]
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=_build.last_build_seconds, build_dir=str(out_dir),
         peaks=peaks)
    return smi, peaks


def phase_flash(peaks, gen):
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    cases = [(32, 12, 197, 64), (4, 12, 785, 64), (4, 12, 1025, 64),
             (2, 12, 3137, 64), (8, 16, 257, 80), (2, 4, 130, 16),
             (2, 4, 130, 32), (2, 4, 130, 128)]
    main_row = None
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, n, d in cases:
            # Strided views of one fused QKV tensor, as the model passes.
            qkv = torch.randn(b, n, 3, h, d, generator=gen, device="cuda")
            qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            got = flash_attention(q, k, v)
            want = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            ok, fields = flash_agrees(got, want)
            row = {"shape": [b, h, n, d], "dtype": str(dtype)[6:], **fields}
            if n in (197, 3137) and d == 64:
                elt = q.element_size()
                row["ms"] = time_ms(lambda: flash_attention(q, k, v))
                row["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v))
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    peaks, 4 * b * h * n * d * elt, 4 * b * h * n * n * d,
                    "bf16" if dtype == torch.bfloat16 else "fp32")
            emit("flash", **row)
            if not ok:
                raise AssertionError(f"flash kernel disagrees: {row}")
            if (b, h, n, d) == (32, 12, 197, 64) and dtype == torch.bfloat16:
                main_row = row
    return main_row


def phase_upsample(peaks, gen):
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
    from visiontransformer_tpu_torch.ops.upsample_argmax import (
        upsample_argmax,
        upsample_argmax_plain,
    )

    main_row = None
    for size in (512, 224):
        x = torch.randn(32, 14, 14, 17, generator=gen, device="cuda")
        got = upsample_argmax(x, (size, size))
        want = upsample_argmax_plain(x, (size, size))
        flips, worst = ties_explained(resize_bilinear_mm(x, (size, size)),
                                      got, want, UPSAMPLE_TIE_TOL)
        agreement = 1.0 - flips / got.numel()
        b, h, w, c = x.shape
        n_bytes = x.numel() * 4 + got.numel() * 4 + 2 * size * 16
        # Operations the function needs: the H-stage (2 mul, 1 add) once per
        # (b, Y, input column, class), the W-stage (2 mul, 1 add) and the
        # argmax compare once per output pixel and class.
        n_ops = 3 * b * size * w * c + 4 * b * size * size * c
        row = {"shape": list(x.shape), "out": [size, size], "flips": flips,
               "agreement": agreement, "max_abs_err": worst,
               "ms": time_ms(lambda: upsample_argmax(x, (size, size))),
               "plain_ms": time_ms(
                   lambda: upsample_argmax_plain(x, (size, size))),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = bound_ms(
            peaks, n_bytes, n_ops, "fp32")
        emit("upsample", **row)
        if agreement < MIN_AGREEMENT:
            raise AssertionError(f"upsample_argmax agreement {agreement}")
        if size == 512:
            main_row = row
    plane = torch.randn(1, 6, 6, 1, generator=gen, device="cuda")
    ties = upsample_argmax(torch.cat([plane, plane - 1.0, plane], -1), (24, 24))
    if bool((ties != 0).any()):
        raise AssertionError("upsample_argmax: a tie did not go to class 0")
    emit("upsample_ties", ok=True)
    return main_row


def phase_model(gen):
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.models.vitseg import (
        vitseg_head_logits,
        vitseg_predict,
    )
    from visiontransformer_tpu_torch.ops.flash_attention import flash_attention
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
    from visiontransformer_tpu_torch.ops.upsample_argmax import upsample_argmax

    batch, size, compute = 32, 512, 224
    cfg, model = resolve_model("vitseg", "P16H768A12", num_classes=17,
                               input_size=compute, compute_dtype="float32",
                               device="cuda")
    mean = torch.tensor(MEAN, device="cuda")
    std = torch.tensor(STD, device="cuda")
    raw = torch.rand(batch, size, size, 3, generator=gen, device="cuda")

    def preprocess(images):
        x = resize_bilinear_mm(images, (compute, compute))
        return (x - mean) / std

    def serve_step(kernels: bool):
        masks = vitseg_predict(
            model, preprocess(raw), out_size=(size, size),
            attn_impl="flash" if kernels else "eager",
            epilogue="kernel" if kernels else "plain")
        return masks.to(torch.uint8)

    result = {"config": "P16H768A12", "classes": 17, "batch": batch,
              "in": size, "compute": compute}
    masks = {}
    with torch.inference_mode():
        x = preprocess(raw)
        for dtype in ("float32", "bfloat16"):
            model.cfg = dataclasses.replace(cfg, compute_dtype=dtype)
            flash_attention.launches = upsample_argmax.launches = 0
            got = serve_step(True)
            torch.cuda.synchronize()
            launches = (flash_attention.launches, upsample_argmax.launches)
            if launches != (cfg.vit.num_hidden_layers, 1):
                raise AssertionError(f"{dtype}: launches per forward "
                                     f"{launches}, expected (12, 1)")
            want = serve_step(False)
            grid_k = vitseg_head_logits(model, x, attn_impl="flash").float()
            grid_p = vitseg_head_logits(model, x, attn_impl="eager").float()
            row = {"launches_per_forward": {"flash_attention": launches[0],
                                            "upsample_argmax": launches[1]}}
            if dtype == "float32":
                ok, err = close(grid_k, grid_p, *LOGITS_TOL)
                # Upsampling is a convex combination, so the two paths'
                # upsampled logits differ by at most err: a flip must sit on
                # a plain-path gap of at most 2 * err (+ rounding).
                flips, worst = ties_explained(
                    resize_bilinear_mm(grid_p, (size, size)), got, want,
                    2 * err + UPSAMPLE_TIE_TOL)
                row.update(logits_max_abs_err=err, logits_tol=LOGITS_TOL,
                           mask_flips=flips, flip_max_logit_gap=worst)
                if not ok:
                    raise AssertionError(f"fp32 seg logits disagree: {err}")
            else:
                row["logits_max_abs_err"] = float((grid_k - grid_p).abs().max())
            row["agreement_vs_plain"] = float((got == want).float().mean())
            if dtype == "bfloat16":
                row["agreement_vs_fp32_plain"] = float(
                    (got == masks["float32"]).float().mean())
            masks[dtype] = want
            # Host clock around 10 steps ending in the masks' readback;
            # best of 3 rounds, kernels and plain paths in turns.
            for kernels, key in ((True, "masks_per_s"),
                                 (False, "plain_masks_per_s"),
                                 (True, "masks_per_s"),
                                 (False, "plain_masks_per_s")):
                serve_step(kernels).cpu()
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(10):
                        out = serve_step(kernels)
                    out.cpu()
                    rate = batch * 10 / (time.perf_counter() - t0)
                    row[key] = max(row.get(key, 0.0), rate)
            result[dtype] = row
            emit("model_" + dtype, **row)
        emit("profile", **profile_steps(lambda: serve_step(True), batch))
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit("model", peak_mem_gb=result["peak_mem_gb"])
    model.to("cpu")
    return result


def profile_steps(step, batch: int, steps: int = 5, top: int = 12):
    """Device time by kernel name over a few steps (torch.profiler), and
    the device's busy share of the host-clock window."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = {}
    for e in prof.events():  # device-side events only: kernels and copies
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us[e.name] = (device_us.get(e.name, 0.0)
                                 + e.time_range.elapsed_us())
    busy_ms = sum(device_us.values()) / 1e3
    ranked = sorted(device_us.items(), key=lambda kv: -kv[1])[:top]
    return {"steps": steps, "batch": batch,
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / wall_ms,
            "top": [{"name": k[:90], "ms_per_step": us / 1e3 / steps,
                     "share": us / 1e3 / busy_ms} for k, us in ranked]}


class _Client:
    def __init__(self, base):
        self.base, self.cookies = base, {}

    def request(self, method, path, body=None, content_type=None,
                headers=None):
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        if content_type:
            req.add_header("Content-Type", content_type)
        if self.cookies:
            req.add_header("Cookie", "; ".join(
                f"{k}={v}" for k, v in self.cookies.items()))
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            resp = urllib.request.urlopen(req, timeout=120)
            status = resp.status
        except urllib.error.HTTPError as e:
            resp, status = e, e.code
        for header in resp.headers.get_all("Set-Cookie") or []:
            k, v = header.split(";")[0].split("=", 1)
            if v:
                self.cookies[k] = v
        raw = resp.read()
        try:
            return status, json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return status, raw

    def post_json(self, path, payload):
        return self.request("POST", path, json.dumps(payload).encode(),
                            "application/json")


def _multipart(fields, files):
    boundary = "chipsmokeboundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
             f'\r\n\r\n{v}\r\n'.encode() for k, v in fields.items()]
    for k, (fname, content) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\nContent-Type: '
                     f'image/png\r\n\r\n'.encode() + content + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def phase_serving(n_jobs: int = 8):
    from PIL import Image

    from visiontransformer_tpu_torch.ops.flash_attention import flash_attention
    from visiontransformer_tpu_torch.ops.upsample_argmax import upsample_argmax
    from visiontransformer_tpu_torch.serve.server import create_server
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import (
        InferenceWorker,
        ModelRunner,
    )

    rng = np.random.default_rng(0)
    pngs = []
    for _ in range(n_jobs):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (256, 256, 3), np.uint8)).save(
            buf, format="PNG")
        pngs.append(buf.getvalue())

    # One bucket: every forward has batch 8, so the check below repeats
    # each job's forward at the same shape (per-row results of a fixed
    # shape do not depend on the other rows).
    buckets = (n_jobs,)
    with tempfile.TemporaryDirectory() as media:
        store = JobStore(":memory:", media_root=media)
        model_id = store.register_model("vit-b16-damage", num_classes=17,
                                        config_name="P16H768A12")
        t0 = time.perf_counter()
        worker = InferenceWorker(store, device="cuda", buckets=buckets)
        worker.start()
        server, _ = create_server(store, worker=worker)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        startup_s = time.perf_counter() - t0
        try:
            client = _Client(f"http://127.0.0.1:{server.server_address[1]}")
            assert client.post_json("/api/users/register/", {
                "username": "smoke", "password": "smoke-pass"})[0] == 201
            assert client.post_json("/api/users/login/", {
                "username": "smoke", "password": "smoke-pass"})[0] == 200
            client.request("GET", "/api/csrf/")
            csrf = {"X-CSRFToken": client.cookies["csrftoken"]}

            flash_attention.launches = upsample_argmax.launches = 0
            t0 = time.perf_counter()
            jobs = []
            for i, png in enumerate(pngs):
                body, ctype = _multipart({"vision_model": str(model_id)},
                                         {"input_image": (f"{i}.png", png)})
                status, job = client.request("POST", "/api/inference-jobs/",
                                             body, ctype, headers=csrf)
                assert status == 201, job
                jobs.append(job["id"])
            done = {}
            deadline = time.time() + 300
            while len(done) < n_jobs and time.time() < deadline:
                for job_id in jobs:
                    if job_id not in done:
                        _, detail = client.request(
                            "GET", f"/api/inference-jobs/{job_id}/?wait=5")
                        if detail["status"] in ("DONE", "FAILED"):
                            done[job_id] = detail
            elapsed = time.perf_counter() - t0
            launches = {"flash_attention": flash_attention.launches,
                        "upsample_argmax": upsample_argmax.launches}
            failed = [d for d in done.values() if d["status"] != "DONE"]
            if len(done) < n_jobs or failed:
                raise AssertionError(f"jobs not DONE: {failed or done}")
            if (launches["upsample_argmax"] < 1 or launches["flash_attention"]
                    != 12 * launches["upsample_argmax"]):
                raise AssertionError(f"serving launches {launches}")

            runner = ModelRunner(store.get_model(model_id), device="cuda",
                                 buckets=buckets)
            equal = 0
            for job_id, png in zip(jobs, pngs):
                _, mask_png = client.request("GET", done[job_id]["mask_image"])
                mask = np.asarray(Image.open(io.BytesIO(mask_png)))
                img = Image.open(io.BytesIO(png)).convert("RGB").resize(
                    (224, 224), Image.BILINEAR)
                want = runner.predict(np.asarray(img, np.uint8)[None])[0]
                equal += int(np.array_equal(mask, want))
            if equal != n_jobs:
                raise AssertionError(f"{n_jobs - equal} job masks differ from "
                                     f"ModelRunner.predict")
        finally:
            worker.stop()
            server.shutdown()
            server.server_close()
    result = {"jobs": n_jobs, "jobs_per_s": n_jobs / elapsed,
              "seconds": elapsed, "startup_s": startup_s,
              "masks_equal_runner": equal, "launches": launches,
              "detections_job0": len(done[jobs[0]]["detections"])}
    emit("serving", **result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    smi, peaks = phase_env()
    flash = phase_flash(peaks, gen)
    upsample = phase_upsample(peaks, gen)
    model = phase_model(gen)
    serving = phase_serving()
    emit("done", seconds=time.perf_counter() - t0,
         masks_per_s=model["bfloat16"]["masks_per_s"],
         jobs_per_s=serving["jobs_per_s"])

    src = "visiontransformer_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention_fwd.cu",
         "replaces": "visiontransformer_tpu/ops/flash_attention.py:92",
         "launches": serving["launches"]["flash_attention"],
         **{k: flash[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
         "shape": flash["shape"], "dtype": flash["dtype"]},
        {"name": "upsample_argmax", "route": "cuda",
         "source": src + "upsample_argmax.cu",
         "replaces": "visiontransformer_tpu/ops/upsample_argmax.py:54",
         "launches": serving["launches"]["upsample_argmax"],
         **{k: upsample[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
         "shape": upsample["shape"], "out": upsample["out"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
