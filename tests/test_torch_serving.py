"""PyTorch port vs the JAX package: the serving runner and the job flow.

The port runs on the CPU because the tests ask for it (``device="cpu"``);
its entry points default to CUDA (tests/test_torch_guard.py).
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import visiontransformer_tpu.models.registry as jax_registry
import visiontransformer_tpu_torch.models.registry as port_registry
from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.serve.worker import ModelRunner as JaxModelRunner
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch import native
from visiontransformer_tpu_torch.ckpt.convert import load_jax_params
from visiontransformer_tpu_torch.serve.server import create_server
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import (
    InferenceWorker,
    ModelRunner,
)

TINY = dict(patch_size=8, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128)
ROW = {"input_size": 32, "config_name": "tiny", "num_classes": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _TinyEntry:
    """Stands in for a sweep row: the registries call
    ``sweep_by_name(name).vit_config(image_size=...)``."""

    def __init__(self, config_cls):
        self.config_cls = config_cls

    def vit_config(self, **overrides):
        return self.config_cls(**{**TINY, **overrides})


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setattr(jax_registry, "sweep_by_name",
                        lambda name: _TinyEntry(jcfg.ViTConfig))
    monkeypatch.setattr(port_registry, "sweep_by_name",
                        lambda name: _TinyEntry(tcfg.ViTConfig))


def test_runner_masks_match_jax(rng, tiny_registry):
    jax_runner = JaxModelRunner(ROW, compute_dtype="float32", buckets=(1, 4))
    runner = ModelRunner(ROW, compute_dtype="float32", buckets=(1, 4),
                         device="cpu")
    load_jax_params(runner.model,
                    jax.tree_util.tree_map(np.asarray, jax_runner.params))
    images = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got = runner.predict(images)
    want = jax_runner.predict(images)
    assert got.dtype == np.uint8 and got.shape == (3, 32, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(runner.color_table, jax_runner.color_table)
    with pytest.raises(TypeError):
        runner.predict(images.astype(np.float32))


def test_detections_native_matches_fallback(rng):
    mask = rng.integers(0, 4, (24, 31)).astype(np.int32)
    mask[5:12, 3:20] = 2
    want = native._detections_np(mask)
    assert native.detections(mask) == want
    labels, n = native.connected_components_np(mask == 2)
    assert n == len([d for d in want if d[0] == 2])
    assert labels.max() == n


def _request(base, cookies, method, path, body=None, content_type=None,
             headers=None):
    req = urllib.request.Request(base + path, data=body, method=method)
    if content_type:
        req.add_header("Content-Type", content_type)
    if cookies:
        req.add_header("Cookie", "; ".join(f"{k}={v}"
                                           for k, v in cookies.items()))
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        resp = urllib.request.urlopen(req, timeout=60)
        status = resp.status
    except urllib.error.HTTPError as e:
        resp, status = e, e.code
    for header in resp.headers.get_all("Set-Cookie") or []:
        k, v = header.split(";")[0].split("=", 1)
        if v:
            cookies[k] = v
    raw = resp.read()
    try:
        return status, json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return status, raw


def test_server_job_flow(tmp_path, rng, tiny_registry):
    store = JobStore(":memory:", media_root=str(tmp_path))
    model_id = store.register_model("tiny-vit", num_classes=5,
                                    config_name="tiny", input_size=32)
    worker = InferenceWorker(store, compute_dtype="float32", buckets=(1, 2),
                             device="cpu")
    worker.start()
    server, _ = create_server(store, worker=worker)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    cookies = {}
    try:
        post = lambda path, payload: _request(  # noqa: E731
            base, cookies, "POST", path, json.dumps(payload).encode(),
            "application/json")
        assert post("/api/users/register/",
                    {"username": "ana", "password": "secret1"})[0] == 201
        assert post("/api/users/login/",
                    {"username": "ana", "password": "secret1"})[0] == 200
        _request(base, cookies, "GET", "/api/csrf/")

        pixels = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, format="PNG")
        boundary = "portboundary"
        body = (f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="vision_model"\r\n\r\n{model_id}\r\n'
                f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="input_image"; filename="photo.png"\r\n'
                f'Content-Type: image/png\r\n\r\n').encode() + buf.getvalue() \
            + f"\r\n--{boundary}--\r\n".encode()
        status, job = _request(
            base, cookies, "POST", "/api/inference-jobs/", body,
            f"multipart/form-data; boundary={boundary}",
            headers={"X-CSRFToken": cookies["csrftoken"]})
        assert status == 201, job
        deadline = time.time() + 120
        while time.time() < deadline:
            _, detail = _request(base, cookies, "GET",
                                 f"/api/inference-jobs/{job['id']}/?wait=5")
            if detail["status"] in ("DONE", "FAILED"):
                break
        assert detail["status"] == "DONE", detail
        assert isinstance(detail["detections"], list)
        status, mask_png = _request(base, cookies, "GET", detail["mask_image"])
        assert status == 200
        mask = np.asarray(Image.open(io.BytesIO(mask_png)))
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()

    runner = ModelRunner(store.get_model(model_id), compute_dtype="float32",
                         buckets=(1, 2), device="cpu")
    image = Image.open(io.BytesIO(buf.getvalue())).convert("RGB").resize(
        (32, 32), Image.BILINEAR)
    want = runner.predict(np.asarray(image, np.uint8)[None])[0]
    np.testing.assert_array_equal(mask, want)
