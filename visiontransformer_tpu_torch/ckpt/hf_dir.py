"""Pretrained SegFormer weights from an HF ``save_pretrained`` directory,
read without ``transformers`` and without ``safetensors``.

A directory written by ``SegformerForSemanticSegmentation.save_pretrained``
holds ``config.json`` and its weights as ``model.safetensors`` (the
default) or ``pytorch_model.bin`` (``safe_serialization=False``); every
MiT preset is far below the size at which ``save_pretrained`` shards.
``read_safetensors`` reads the safetensors format itself: an 8-byte
little-endian header length, a JSON header mapping each name to its
``dtype``, ``shape`` and ``data_offsets`` (begin and end, in bytes, from
the end of the header), then the raw little-endian bytes. A ``.bin`` file
is read by ``torch.load(weights_only=True)``.

``read_hf_segformer`` returns the model's geometry matched to a MiT preset
(``models/mit.py``; widths and depths, as the TPU package's
``resolve_model`` matches them, and heads and reduction ratios too, which
no parameter shape would show), with the class count and decode width,
and the state dict for
``ckpt/torch_convert.py:convert_hf_segformer_seg_state``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import torch

from visiontransformer_tpu_torch.models.mit import MIT_PRESETS

CONFIG = "config.json"
_WEIGHTS = ("model.safetensors", "pytorch_model.bin")

# safetensors dtype names -> torch dtypes.
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def is_hf_dir(path: str) -> bool:
    """True for a directory holding an HF ``config.json``."""
    return os.path.isfile(os.path.join(path, CONFIG))


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        data = bytearray(f.read())
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{entry['dtype']}, which the reader does not "
                             f"know")
        begin, end = entry["data_offsets"]
        dtype = _DTYPES[entry["dtype"]]
        size = dtype.itemsize
        count = 1
        for d in entry["shape"]:
            count *= d
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} "
                             f"bytes, not {count * size} for shape "
                             f"{entry['shape']} {entry['dtype']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=count,
                                 offset=begin) if count
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(entry["shape"]).clone()
    return out


def read_hf_state(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF ``save_pretrained`` directory."""
    safetensors, binary = (os.path.join(path, name) for name in _WEIGHTS)
    if os.path.isfile(safetensors):
        return read_safetensors(safetensors)
    if os.path.isfile(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{path} holds no weights: looked for "
                            f"{' and '.join(_WEIGHTS)}")


def mit_preset(config: dict) -> str:
    """The MiT preset of an HF config's encoder geometry; raises for
    none."""
    geometry = tuple(tuple(config[k]) for k in (
        "hidden_sizes", "depths", "num_attention_heads", "sr_ratios"))
    for name, preset in MIT_PRESETS.items():
        if preset == geometry:
            return name
    raise ValueError(f"HF checkpoint geometry {geometry} (widths, depths, "
                     f"heads, reduction ratios) matches no MiT preset "
                     f"(known: {sorted(MIT_PRESETS)})")


def read_hf_segformer(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """({"encoder_name", "num_labels", "decoder_hidden_size"}, the state
    dict) of an HF SegFormer directory."""
    with open(os.path.join(path, CONFIG)) as f:
        config = json.load(f)
    info = {"encoder_name": mit_preset(config),
            "num_labels": len(config["id2label"]),
            "decoder_hidden_size": int(config["decoder_hidden_size"])}
    return info, read_hf_state(path)
