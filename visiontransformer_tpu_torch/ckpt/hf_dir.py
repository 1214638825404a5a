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

``read_hf_sam`` reads a ``SamModel`` directory: the geometry of its
``config.json`` (``vision_config``, ``prompt_encoder_config``,
``mask_decoder_config``, HF's defaults for keys it leaves out) as the
port's ``SamConfig``, the preset matched by width, depth, heads and global
blocks (``models/sam.py:SAM_PRESETS``), and the state dict under HF's
names less the parameters a box prompt and a single mask never read
(``SAM_UNUSED``).

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
from visiontransformer_tpu_torch.models.sam import SAM_PRESETS, SamConfig

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


# SamModel parameters the port does not hold: the mask-input embedding and
# the point labels' "not a point" entry (box prompts only), and the prompt
# encoder's tied copy of the Fourier matrix (``shared_image_embedding``'s).
SAM_UNUSED = ("prompt_encoder.mask_embed.",
              "prompt_encoder.not_a_point_embed.",
              "prompt_encoder.shared_embedding.")


def sam_preset(vision: dict) -> str:
    """The SAM preset of an HF vision config's geometry; raises for none."""
    geometry = (int(vision.get("hidden_size", 768)),
                int(vision.get("num_hidden_layers", 12)),
                int(vision.get("num_attention_heads", 12)),
                tuple(int(i) for i in vision.get("global_attn_indexes",
                                                 (2, 5, 8, 11))))
    for name, preset in SAM_PRESETS.items():
        if preset == geometry:
            return name
    raise ValueError(f"HF checkpoint geometry {geometry} (width, depth, "
                     f"heads, global blocks) matches no SAM preset (known: "
                     f"{sorted(SAM_PRESETS)})")


def sam_config_from_hf(config: dict, compute_dtype: str) -> SamConfig:
    """The port's ``SamConfig`` of an HF ``SamConfig`` dict; raises where
    the model is not one the port runs (no absolute or relative positions,
    no qkv bias, another activation, unequal widths)."""
    v = config.get("vision_config", {})
    p = config.get("prompt_encoder_config", {})
    m = config.get("mask_decoder_config", {})
    hidden = int(v.get("hidden_size", 768))
    out = int(v.get("output_channels", 256))
    mlp = v.get("mlp_dim") or int(hidden * float(v.get("mlp_ratio", 4.0)))
    checks = {"use_abs_pos": (v.get("use_abs_pos", True), True),
              "use_rel_pos": (v.get("use_rel_pos", True), True),
              "qkv_bias": (v.get("qkv_bias", True), True),
              "vision hidden_act": (v.get("hidden_act", "gelu"), "gelu"),
              "decoder hidden_act": (m.get("hidden_act", "relu"), "relu"),
              "prompt hidden_size": (int(p.get("hidden_size", 256)), out),
              "decoder hidden_size": (int(m.get("hidden_size", 256)), out),
              "num_channels": (int(v.get("num_channels", 3)), 3)}
    for key, (got, want) in checks.items():
        if got != want:
            raise ValueError(f"SAM config: {key} is {got!r}; the port runs "
                             f"{want!r}")
    return SamConfig(
        hidden_size=hidden, num_hidden_layers=int(v.get("num_hidden_layers",
                                                        12)),
        num_attention_heads=int(v.get("num_attention_heads", 12)),
        global_attn_indexes=tuple(int(i) for i in v.get(
            "global_attn_indexes", (2, 5, 8, 11))),
        mlp_dim=int(mlp), window_size=int(v.get("window_size", 14)),
        image_size=int(v.get("image_size", 1024)),
        patch_size=int(v.get("patch_size", 16)), output_channels=out,
        num_pos_feats=int(v.get("num_pos_feats", 128)),
        layer_norm_eps=float(v.get("layer_norm_eps", 1e-6)),
        decoder_layers=int(m.get("num_hidden_layers", 2)),
        decoder_heads=int(m.get("num_attention_heads", 8)),
        decoder_mlp_dim=int(m.get("mlp_dim", 2048)),
        attention_downsample_rate=int(m.get("attention_downsample_rate", 2)),
        num_mask_tokens=int(m.get("num_multimask_outputs", 3)) + 1,
        iou_head_depth=int(m.get("iou_head_depth", 3)),
        iou_head_hidden_dim=int(m.get("iou_head_hidden_dim", 256)),
        decoder_layer_norm_eps=float(m.get("layer_norm_eps", 1e-6)),
        compute_dtype=compute_dtype)


def read_hf_sam(path: str, compute_dtype: str = "bfloat16"
                ) -> Tuple[str, SamConfig, Dict[str, torch.Tensor]]:
    """(preset name, ``SamConfig``, state dict less ``SAM_UNUSED``) of an
    HF ``SamModel`` directory."""
    with open(os.path.join(path, CONFIG)) as f:
        config = json.load(f)
    name = sam_preset(config.get("vision_config", {}))
    state = read_hf_state(path)
    # The Fourier matrix is tied: a file may hold either copy.
    state.setdefault("shared_image_embedding.positional_embedding",
                     state.get("prompt_encoder.shared_embedding."
                               "positional_embedding"))
    state = {k: v for k, v in state.items()
             if v is not None and not k.startswith(SAM_UNUSED)}
    return name, sam_config_from_hf(config, compute_dtype), state
