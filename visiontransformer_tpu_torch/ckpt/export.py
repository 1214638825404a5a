"""Ahead-of-time serving artifacts: the serving forward as one saved program.

The port's counterpart of the TPU package's ``ckpt/stablehlo.py``.
``torch.export`` traces the serving forward (images in [0, 1] -> uint8
class masks: the family's masks forward,
``models/registry.py:serving_forward``, as the serving worker runs it
eagerly, a W8A8 model's included) once under ``no_grad``, with the
trained weights inside the program, and saves it. A vitseg program's size
is its patch grid's; any other family's is named at export
(``input_size``). A deployment host then runs inference with
``load_serving`` + ``call``: no model code, no configuration, no
re-trace, and an error, not a silent retrace, if the input shape or the
device does not match what was exported. On the card a vitseg program
holds kernels 1 and 5 as the custom ops ``vt::flash_attention_fwd`` (one
node a layer) and ``vt::upsample_argmax`` (``ops/flash_attention.py``,
``ops/upsample_argmax.py``), and kernel 10 as ``vt::layer_norm`` (block
0's ln1) and ``vt::add_layer_norm`` (``ops/layer_norm.py``: each ln2, and
each later ln1 and the final LayerNorm, with the residual before it; under
ToMe those two alone), which this module registers by importing them
before it loads a program.

File format, as the TPU package's: magic, 8-byte big-endian JSON-header
length, JSON metadata (family, classes, shapes, the device type it was
exported for as ``platforms``, torch version), then the
``torch.export.save`` bytes.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

# Imported for the vt:: custom ops they register (torch.export.load needs
# them before it reads a program that calls them).
from visiontransformer_tpu_torch.ops import flash_attention as _flash  # noqa: F401
from visiontransformer_tpu_torch.ops import upsample_argmax as _epilogue  # noqa: F401
from visiontransformer_tpu_torch.ops import layer_norm as _layer_norm  # noqa: F401
from visiontransformer_tpu_torch.configs import ViTSegConfig
from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.models.registry import serving_forward

_MAGIC = b"VTTEXP1\n"


def serving_input_size(cfg, family: str = "vitseg",
                       input_size: Optional[int] = None) -> int:
    """The static image side the artifact is exported for: a vitseg
    model's is fixed by its patch grid; the other families take any size,
    so the caller names one, and none raises (the program is
    static-shape), as in the TPU package."""
    if isinstance(cfg, ViTSegConfig):
        return cfg.vit.image_size
    if input_size is None:
        raise ValueError(
            f"family {family!r} takes any input size but the exported "
            f"program is static: pass input_size")
    return int(input_size)


def export_serving(model: nn.Module, cfg, *, out_path: str,
                   batch_size: int = 8, input_size: Optional[int] = None,
                   attn_impl: str = "auto",
                   epilogue: str = "auto") -> Dict[str, Any]:
    """Save the serving forward of ``model`` (any family; a
    ``ConvSegModel`` names its own) at (batch_size, size, size, 3) fp32
    images, with its weights inside, for the device type the model is on;
    ``size`` is ``serving_input_size(cfg, family, input_size)``. It is
    traced under ``no_grad``, so attention takes the inference kernel.
    attn_impl and epilogue: as ``vitseg_predict``'s ("auto": the kernels
    on CUDA, the plain forms on the CPU). Returns the metadata written to
    the header."""
    size = serving_input_size(cfg, model.family, input_size)
    device = next(model.parameters()).device
    images = torch.zeros((batch_size, size, size, 3), device=device)
    with torch.no_grad():
        program = torch.export.export(
            serving_forward(model, out_size=(size, size),
                            mask_dtype=torch.uint8, attn_impl=attn_impl,
                            epilogue=epilogue).eval(), (images,))
    blob = io.BytesIO()
    torch.export.save(program, blob)
    meta = {
        "family": model.family,
        "num_classes": int(cfg.num_classes),
        "batch_size": int(batch_size),
        "input_size": int(size),
        "platforms": [device.type],
        "torch_version": torch.__version__,
    }
    header = json.dumps(meta, sort_keys=True).encode("utf-8")
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">Q", len(header)))
        f.write(header)
        f.write(blob.getvalue())
    return meta


class ServingArtifact:
    """A loaded serving program: ``call(images)`` -> uint8 masks."""

    def __init__(self, meta: Dict[str, Any],
                 program: torch.export.ExportedProgram):
        self.meta = meta
        self.program = program
        self._forward = program.module()

    def call(self, images: torch.Tensor) -> torch.Tensor:
        """(batch, size, size, 3) fp32 images in [0, 1], on the device the
        program was exported for -> (batch, size, size) uint8 masks."""
        b, s = self.meta["batch_size"], self.meta["input_size"]
        if tuple(images.shape) != (b, s, s, 3):
            raise ValueError(
                f"artifact was exported for shape {(b, s, s, 3)}, "
                f"got {tuple(images.shape)}")
        with torch.inference_mode():
            return self._forward(images)


def load_serving(path: str, device: Optional[Union[str, torch.device]] = None
                 ) -> ServingArtifact:
    """Load an artifact to run on ``device`` (None means CUDA); raises for a
    device type it was not exported for."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a serving artifact "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack(">Q", f.read(8))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        blob = f.read()
    kind = torch.device("cuda" if device is None else device).type
    if kind not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, "
                         f"not {kind}")
    resolve_device(device)
    return ServingArtifact(meta, torch.export.load(io.BytesIO(blob)))
