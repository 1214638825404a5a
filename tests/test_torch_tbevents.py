"""PyTorch port vs the JAX package: the tfevents log and the profiler trace.

The port's ``utils/tbevents.py`` writes the JAX package's records byte for
byte for the same calls and wall time; TensorBoard's own loader reads the
file the port's trainer writes (as tests/test_tbevents.py reads the JAX
writer's), whose (tag, step) pairs equal the JAX trainer's on the same
tiny run. ``fit(profile_dir=)`` writes a torch.profiler Chrome trace of
global steps 2-5, or, when the first epoch ends sooner, of the steps from
2 to the epoch's end (the JAX trainer leaves its trace open there).
"""

import glob
import json
import os
import struct
import time

import numpy as np
import pytest
import torch

from visiontransformer_tpu import configs as jcfg
from visiontransformer_tpu.train.trainer import Trainer as JaxTrainer
from visiontransformer_tpu.utils import tbevents as jtbevents
from visiontransformer_tpu.utils.csvlog import CSVLogger as JaxCSVLogger
from visiontransformer_tpu_torch import configs as tcfg
from visiontransformer_tpu_torch.data import CESegmentationDataset
from visiontransformer_tpu_torch.data.synthetic import generate_multiclass
from visiontransformer_tpu_torch.train.trainer import Trainer
from visiontransformer_tpu_torch.utils import tbevents as ttbevents
from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

tb_loader = pytest.importorskip(
    "tensorboard.backend.event_processing.event_file_loader")

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    generate_multiclass(root, n_samples=8, image_size=40)
    return CESegmentationDataset(f"{root}/image_png", f"{root}/mask_png",
                                 image_size=32, cache=True)


def _records(path):
    """(payload, ...) of a TFRecord file, each CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        assert crc == jtbevents._masked_crc(header)
        payload = data[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        assert crc == jtbevents._masked_crc(payload)
        out.append(payload)
        pos += 16 + n
    return out


def _calls(writer):
    writer.add_scalar("train_loss", 0.5, step=1, wall_time=123.0)
    writer.add_scalar("train_loss", 0.25, step=2, wall_time=124.0)
    writer.add_scalar("valid_iou", 0.8, step=2, wall_time=124.5)
    writer.add_scalar("epoch_time_s", 1e9 + 0.1, step=10 ** 12,
                      wall_time=2e9)
    writer.close()


def test_writer_records_are_jax_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    writers = [module.EventFileWriter(str(tmp_path / name)) for module, name
               in ((jtbevents, "jax"), (ttbevents, "port"))]
    for writer in writers:
        _calls(writer)
    jpath, path = (w.path for w in writers)
    assert os.path.basename(path) == os.path.basename(jpath)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    assert len(_records(path)) == 5
    assert ttbevents._crc32c(b"123456789") == 0xE3069283  # CRC-32C check


def _tags_and_steps(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    events = list(tb_loader.EventFileLoader(path).Load())
    assert events[0].file_version == "brain.Event:2"
    return [(v.tag, e.step) for e in events[1:] for v in e.summary.value]


def test_trainer_events_match_jax(tmp_path, dataset):
    train_cfg = dict(batch_size=4, accumulate_grad_batches=2, max_epochs=2,
                     log_every_n_steps=1)
    j = jcfg.ViTSegConfig(vit=jcfg.ViTConfig(**VIT),
                          num_classes=dataset.num_classes)
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT),
                          num_classes=dataset.num_classes)
    jlogger = JaxCSVLogger(str(tmp_path / "jax"))
    JaxTrainer(j, jcfg.TrainConfig(**train_cfg), use_mesh=False,
               logger=jlogger).fit(dataset, val_dataset=dataset)
    logger = CSVLogger(str(tmp_path / "port"))
    seen = []
    Trainer(t, tcfg.TrainConfig(**train_cfg), device="cpu",
            logger=logger).fit(dataset, val_dataset=dataset,
                               on_epoch_end=lambda e, m: seen.append(m))
    pairs = _tags_and_steps(logger.log_dir)
    assert pairs == _tags_and_steps(jlogger.log_dir)
    assert [step for _, step in pairs] == [2] * len(seen[0]) + [4] * len(
        seen[1])
    # The values are the epoch's metrics (fp32 storage).
    (path,) = glob.glob(os.path.join(logger.log_dir, "events.out.*"))
    events = list(tb_loader.EventFileLoader(path).Load())[1:]
    values = [(v.tensor.float_val[0] if v.tensor.float_val
               else v.simple_value) for e in events for v in e.summary.value]
    want = [m[tag] for m in seen for tag in m]
    np.testing.assert_allclose(values, want, rtol=1e-6)


def _trace_steps(profile_dir):
    (path,) = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({int(e["name"].rsplit("_", 1)[1]) for e in events
                   if str(e.get("name", "")).startswith("train_step_")})


@pytest.mark.parametrize("batch_size,steps", [(1, [2, 3, 4, 5]),
                                               (2, [2, 3])])
def test_profile_dir_traces_steps_two_to_five(tmp_path, dataset,
                                              batch_size, steps):
    """8 steps an epoch: steps 2-5; 4 steps an epoch: the trace stops at
    the epoch's end, and the second epoch starts no other."""
    t = tcfg.ViTSegConfig(vit=tcfg.ViTConfig(**VIT),
                          num_classes=dataset.num_classes)
    trainer = Trainer(t, tcfg.TrainConfig(
        batch_size=batch_size, accumulate_grad_batches=1, max_epochs=2,
        early_stopping_monitor=None), device="cpu")
    profile_dir = str(tmp_path / "prof")
    state = trainer.fit(dataset, profile_dir=profile_dir)
    assert state.step == 2 * len(dataset) // batch_size
    assert _trace_steps(profile_dir) == steps

