"""The port's spans and counters (``utils/spans.py``) and where the serving
path records them: nesting and batch ids, the ring's bound, counters
under threads, no profiler range without a profiler, the ranges a profile
shows, ``ModelRunner``'s and ``InferenceWorker``'s spans, the exported
serving program and the admin capture's ``spans.json``."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import visiontransformer_tpu_torch.models.registry as port_registry
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.ckpt.export import (
    export_serving,
    load_serving,
)
from visiontransformer_tpu_torch.models.vitseg import ViTSeg, vitseg_apply
from visiontransformer_tpu_torch.serve.server import ServingApp
from visiontransformer_tpu_torch.serve.store import JobStore
from visiontransformer_tpu_torch.serve.worker import (
    InferenceWorker,
    ModelRunner,
)
from visiontransformer_tpu_torch.utils import spans

TINY = dict(patch_size=8, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128)
ROW = {"input_size": 32, "config_name": "tiny", "num_classes": 5}
SERVE = ("serve.dispatch", "serve.input", "serve.forward", "serve.output",
         "serve.resolve")
# The ranges the served masks forward opens; the per-block forward
# (``vit_encode``) opens ``vit.block`` too.
SERVED = ("vit.embed", "vit.attention", "vitseg.head", "vitseg.epilogue")
MODEL = SERVED + ("vit.block",)


class _TinyEntry:
    def vit_config(self, **overrides):
        return tcfg.ViTConfig(**{**TINY, **overrides})


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setattr(port_registry, "sweep_by_name",
                        lambda name: _TinyEntry())


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


def _named(name):
    return [s for s in spans.finished() if s.name == name]


def test_spans_nest_and_share_batch_ids():
    with spans.span("outer", batch=7) as outer:
        with spans.span("inner") as inner:
            with spans.span("own", batch=9) as own:
                pass
    with spans.span("alone") as alone:
        pass
    assert [s.name for s in spans.finished()] == ["own", "inner", "outer",
                                                  "alone"]
    assert (outer.parent, inner.parent, own.parent) == (None, outer.id,
                                                        inner.id)
    assert (outer.batch, inner.batch, own.batch) == (7, 7, 9)
    assert alone.parent is None and alone.batch is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.thread == threading.get_ident()
    assert json.loads(json.dumps(inner.as_dict()))["parent"] == outer.id
    a, b = spans.next_batch(), spans.next_batch()
    assert b > a


def test_a_span_is_recorded_when_its_body_raises():
    with pytest.raises(ValueError):
        with spans.span("fails"):
            raise ValueError("x")
    with spans.span("next") as nxt:
        pass
    assert [s.name for s in spans.finished()] == ["fails", "next"]
    assert nxt.parent is None  # the failed span left the stack


def test_ring_keeps_the_newest():
    assert spans.RING >= 65536
    for i in range(spans.RING + 3):
        with spans.span("s", batch=i):
            pass
    ring = spans.finished()
    assert len(ring) == spans.RING
    assert [s.batch for s in ring[:2]] == [3, 4]
    assert ring[-1].batch == spans.RING + 2


def test_counters_and_spans_under_threads():
    n_threads, n = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(k):
        try:
            for _ in range(n):
                spans.count("c")
                spans.count("c2", 2)
                with spans.span("t", batch=k) as outer:
                    with spans.span("u") as inner:
                        pass
                if inner.parent != outer.id or inner.batch != k:
                    errors.append((k, inner.parent, outer.id))
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert spans.counters() == {"c": n_threads * n, "c2": 2 * n_threads * n}
    assert len(_named("t")) == len(_named("u")) == n_threads * n
    spans.reset()
    assert spans.counters() == {} and spans.finished() == []


def _runner(**kwargs):
    return ModelRunner(ROW, compute_dtype="float32", device="cpu", **kwargs)


def _count_ranges(monkeypatch):
    """The names of the profiler ranges opened from here on, through both
    ways torch opens one."""
    entered = []
    for owner, attr in ((torch.profiler, "record_function"),
                        (torch._C._profiler, "_RecordFunctionFast")):
        real = getattr(owner, attr)
        monkeypatch.setattr(owner, attr, lambda name, *a, real=real: (
            entered.append(name), real(name, *a))[1])
    return entered


def test_no_profiler_range_without_a_profiler(monkeypatch, tiny_registry):
    runner = _runner(buckets=(2,))
    entered = _count_ranges(monkeypatch)
    with spans.span("serve.x"):
        with spans.ranged("vit.x"):
            pass
    runner.predict(np.zeros((2, 32, 32, 3), np.uint8))
    assert entered == []
    assert len(_named("serve.dispatch")) == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        runner.predict(np.zeros((2, 32, 32, 3), np.uint8))
    assert set(SERVE + SERVED) <= set(entered)


def test_a_profile_shows_the_program_ranges(tiny_registry):
    runner = _runner(buckets=(2,))
    images = np.zeros((2, 32, 32, 3), np.uint8)
    runner.predict(images)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner.predict(images)
    events = [e.name for e in prof.events()]
    for name in SERVE + SERVED:
        assert name in events, name
    assert events.count("vit.attention") == 2 and "vit.block" not in events
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            vitseg_apply(runner.model, torch.zeros(2, 32, 32, 3))
    events = [e.name for e in prof.events()]
    assert events.count("vit.block") == events.count("vit.attention") == 2


@pytest.mark.parametrize("dp", [1, 2])
def test_runner_spans_share_one_batch(tiny_registry, dp):
    runner = _runner(buckets=(4,), mesh_shape=(dp,))
    pending = runner.dispatch(np.zeros((3, 32, 32, 3), np.uint8))
    assert pending.resolve().shape == (3, 32, 32)
    (dispatch,), (resolve,) = _named("serve.dispatch"), _named("serve.resolve")
    assert dispatch.batch == resolve.batch == pending.batch is not None
    for name in ("serve.input", "serve.forward", "serve.output"):
        got = _named(name)
        assert len(got) == dp, name  # one a replica
        assert all(s.batch == dispatch.batch and s.parent == dispatch.id
                   for s in got)
    assert resolve.parent is None
    assert spans.counters() == {"serve.batches": 1, "serve.rows": 3,
                                "serve.padded_rows": 1}
    runner.dispatch(np.zeros((4, 32, 32, 3), np.uint8), batch=77).resolve()
    assert {s.batch for s in spans.finished()} == {dispatch.batch, 77}
    assert spans.counters()["serve.padded_rows"] == 1


def test_export_under_a_profiler_holds_no_range(tmp_path, monkeypatch):
    cfg = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(image_size=32, **TINY),
                            num_classes=3, compute_dtype="float32")
    model = ViTSeg(cfg)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    entered = _count_ranges(monkeypatch)
    path = str(tmp_path / "m.pt2")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        export_serving(model.eval(), cfg, out_path=path, batch_size=1)
    assert not set(entered) & set(MODEL), entered
    program = load_serving(path, device="cpu").program
    targets = [str(n.target) for n in program.graph.nodes]
    assert any("aten" in t for t in targets), targets
    assert not [t for t in targets if "profiler" in t], targets


def test_worker_spans_counter_and_admin_capture(tmp_path, tiny_registry):
    store = JobStore(":memory:", media_root=str(tmp_path))
    model_id = store.register_model("tiny-vit", num_classes=5,
                                    config_name="tiny", input_size=32)
    img = tmp_path / "in.png"
    Image.fromarray(np.full((40, 48, 3), 77, np.uint8)).save(img)
    worker = InferenceWorker(store, compute_dtype="float32", buckets=(1, 2),
                             device="cpu", poll_interval=0.005, linger=0.01)
    app = ServingApp(store, worker=worker)
    worker.start()
    try:
        job = store.create_job(None, model_id, str(img))["id"]
        deadline = time.time() + 60
        while (store.get_job(job)["status"] not in ("DONE", "FAILED")
               and time.time() < deadline):
            time.sleep(0.02)
        assert store.get_job(job)["status"] == "DONE"
        deadline = time.time() + 10
        while (spans.counters().get("serve.jobs_done") != 1
               and time.time() < deadline):
            time.sleep(0.01)
    finally:
        worker.stop()
    assert spans.counters()["serve.jobs_done"] == 1
    assert "embedded worker: 1 jobs processed" in app.render_admin()
    (decode,), (post,) = _named("worker.decode"), _named("worker.postprocess")
    # The warm-up dispatched each bucket once, under batch ids of its own.
    assert len(_named("serve.dispatch")) == 3
    (dispatch,) = [s for s in _named("serve.dispatch")
                   if s.batch == decode.batch]
    assert post.batch == decode.batch
    assert dispatch.batch in {s.batch for s in _named("worker.claim")}
    assert dispatch.batch in {s.batch for s in _named("worker.linger")}
    assert decode.thread != dispatch.thread  # on the io pool

    stop = threading.Event()

    def record():
        while not stop.is_set():
            with spans.span("during"):
                time.sleep(0.005)

    with spans.span("before"):
        pass
    t = threading.Thread(target=record)
    t.start()
    try:
        status, out, _ = app._capture_profile(
            {"seconds": 0.2, "trace_dir": str(tmp_path / "trace")})
    finally:
        stop.set()
        t.join(10)
    assert status == 200, out
    with open(tmp_path / "trace" / "spans.json") as f:
        got = json.load(f)
    names = {s["name"] for s in got["spans"]}
    assert "during" in names and "before" not in names
    assert got["counters"]["serve.jobs_done"] == 1
