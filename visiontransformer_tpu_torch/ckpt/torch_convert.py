"""The reference's PyTorch-Lightning checkpoints <-> the port's state dicts.

The vitseg part of the TPU package's ``ckpt/torch_convert.py``. The
reference writes its checkpoints with Lightning's ModelCheckpoint
(reference model/CE/trainCurrentViTmodel.py:69) and reads them back with
``torch.load(ckpt)['state_dict']`` (model/CE/testViTModel.py:117-118). The
port's modules keep the TPU package's layouts (``ckpt/convert.py``), so the
translations are the TPU package's:

- torch Linear stores (out, in); the port's kernels are (in, out): transpose.
- torch Conv2d stores OIHW; the port's conv kernels are HWIO.
- HF's three q/k/v Linears fuse into one (H, 3H) kernel, columns [q|k|v].
- The patch-embedding conv becomes a (p²·C, H) matmul kernel in
  (ph, pw, C) pixel order (``models/vit.py:patchify``).
- HF ViTModel's pooler is dropped on load and written as zeros on export:
  the reference consumes only ``last_hidden_state``
  (model/CE/classes.py:248).

Loaded weights come back as the port's fp32 state dict, keyed as
``ckpt/convert.py:vitseg_params_from_jax`` keys them; exported ones as
numpy arrays, as the TPU package's export returns them.

``convert_hf_segformer_state`` and ``convert_hf_segformer_seg_state`` map
an HF SegFormer state dict (``ckpt/hf_dir.py`` reads one from a
``save_pretrained`` directory) onto the TPU package's segformer tree,
which ``ckpt/convert.py:conv_params_from_jax`` then loads.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from visiontransformer_tpu_torch.ckpt.convert import vitseg_params_from_jax
from visiontransformer_tpu_torch.configs import ViTConfig, ViTSegConfig
from visiontransformer_tpu_torch.models.mit import MIT_PRESETS
from visiontransformer_tpu_torch.models.unet import IMAGENET_MEAN, IMAGENET_STD

Array = np.ndarray


def _to_np(x) -> Array:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _linear(state: Mapping, prefix: str) -> Dict[str, Array]:
    out = {"kernel": _to_np(state[prefix + ".weight"]).T}
    if prefix + ".bias" in state:
        out["bias"] = _to_np(state[prefix + ".bias"])
    return out


def _layer_norm(state: Mapping, prefix: str) -> Dict[str, Array]:
    return {"scale": _to_np(state[prefix + ".weight"]),
            "bias": _to_np(state[prefix + ".bias"])}


def _conv(state: Mapping, prefix: str) -> Dict[str, Array]:
    return {"kernel": _to_np(state[prefix + ".weight"]).transpose(2, 3, 1, 0),
            "bias": _to_np(state[prefix + ".bias"])}


def _hf_vit_tree(state: Mapping, cfg: ViTConfig, p: str) -> dict:
    w = _to_np(state[p + "embeddings.patch_embeddings.projection.weight"])
    tree = {
        "patch_embed": {
            "kernel": w.transpose(2, 3, 1, 0).reshape(-1, cfg.hidden_size),
            "bias": _to_np(
                state[p + "embeddings.patch_embeddings.projection.bias"])},
        "cls_token": _to_np(state[p + "embeddings.cls_token"]),
        "pos_embed": _to_np(state[p + "embeddings.position_embeddings"]),
        "final_ln": _layer_norm(state, p + "layernorm"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        lp = f"{p}encoder.layer.{i}."
        q, k, v = (_linear(state, lp + f"attention.attention.{name}")
                   for name in ("query", "key", "value"))
        qkv = {"kernel": np.concatenate(
            [q["kernel"], k["kernel"], v["kernel"]], axis=1)}
        if "bias" in q:
            qkv["bias"] = np.concatenate([q["bias"], k["bias"], v["bias"]])
        tree["layers"].append({
            "ln1": _layer_norm(state, lp + "layernorm_before"),
            "qkv": qkv,
            "attn_out": _linear(state, lp + "attention.output.dense"),
            "ln2": _layer_norm(state, lp + "layernorm_after"),
            "mlp_in": _linear(state, lp + "intermediate.dense"),
            "mlp_out": _linear(state, lp + "output.dense"),
        })
    return tree


def convert_hf_vit_state(state: Mapping, cfg: ViTConfig,
                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """HF ViTModel state_dict -> the port's ``ViT`` state dict (fp32)."""
    return vitseg_params_from_jax(_hf_vit_tree(state, cfg, prefix))


def convert_vitseg_state(state: Mapping, cfg: ViTSegConfig,
                         backbone_prefix: str = "model.backbone.",
                         head_prefix: str = "model.seg_head."
                         ) -> Dict[str, torch.Tensor]:
    """Full ViTSegmentationModel state_dict (Lightning ``model.`` prefixes,
    reference model/CE/classes.py:240-244 head indices 0 and 2) -> the
    port's ``ViTSeg`` state dict (fp32)."""
    return vitseg_params_from_jax({
        "backbone": _hf_vit_tree(state, cfg.vit, backbone_prefix),
        "head_conv1": _conv(state, head_prefix + "0"),
        "head_conv2": _conv(state, head_prefix + "2"),
    })


def load_lightning_checkpoint(path: str, cfg: ViTSegConfig
                              ) -> Dict[str, torch.Tensor]:
    """A reference .ckpt file -> the port's ``ViTSeg`` state dict. The file
    holds more than tensors (Lightning's callbacks and hyperparameters), so
    it is read with ``weights_only=False``, as the TPU package reads it:
    load only files this project or the reference wrote."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_vitseg_state(ckpt.get("state_dict", ckpt), cfg)


# --------------------------------------------------------------------- export
# The inverse direction: port-trained weights as reference-format Lightning
# state dicts, with the key names its ViTSegmentationModel produces
# (model/CE/classes.py:240-262).

def _export_linear(state: Mapping, src: str, out: Dict[str, Array],
                   dst: str) -> None:
    out[dst + ".weight"] = _to_np(state[src + ".kernel"]).T
    if src + ".bias" in state:
        out[dst + ".bias"] = _to_np(state[src + ".bias"])


def _export_layer_norm(state: Mapping, src: str, out: Dict[str, Array],
                       dst: str) -> None:
    out[dst + ".weight"] = _to_np(state[src + ".scale"])
    out[dst + ".bias"] = _to_np(state[src + ".bias"])


def _export_conv(state: Mapping, src: str, out: Dict[str, Array],
                 dst: str) -> None:
    out[dst + ".weight"] = _to_np(state[src + ".kernel"]).transpose(3, 2, 0, 1)
    out[dst + ".bias"] = _to_np(state[src + ".bias"])


def export_hf_vit_state(state: Mapping, cfg: ViTConfig, prefix: str = "",
                        include_pooler: bool = True) -> Dict[str, Array]:
    """The port's ``ViT`` state dict -> HF ViTModel state_dict (numpy).

    include_pooler writes zero pooler weights, so that a strict
    ``load_state_dict`` into ``ViTModel(add_pooling_layer=True)`` succeeds;
    neither the port's forward nor the reference uses the pooler."""
    p, h = prefix, cfg.hidden_size
    out: Dict[str, Array] = {}
    patch = _to_np(state["patch_embed.kernel"])  # (p²·C, H)
    out[p + "embeddings.patch_embeddings.projection.weight"] = (
        patch.reshape(cfg.patch_size, cfg.patch_size, cfg.num_channels, h)
        .transpose(3, 2, 0, 1))  # -> OIHW
    out[p + "embeddings.patch_embeddings.projection.bias"] = _to_np(
        state["patch_embed.bias"])
    out[p + "embeddings.cls_token"] = _to_np(state["cls_token"])
    out[p + "embeddings.position_embeddings"] = _to_np(state["pos_embed"])
    _export_layer_norm(state, "final_ln", out, p + "layernorm")

    for i in range(cfg.num_hidden_layers):
        src, lp = f"layers.{i}.", f"{p}encoder.layer.{i}."
        kernel = _to_np(state[src + "qkv.kernel"])  # (H, 3H), [q|k|v]
        bias = (_to_np(state[src + "qkv.bias"])
                if src + "qkv.bias" in state else None)
        for j, name in enumerate(("query", "key", "value")):
            dst = lp + f"attention.attention.{name}"
            out[dst + ".weight"] = kernel[:, j * h:(j + 1) * h].T
            if bias is not None:
                out[dst + ".bias"] = bias[j * h:(j + 1) * h]
        _export_layer_norm(state, src + "ln1", out, lp + "layernorm_before")
        _export_linear(state, src + "attn_out", out,
                       lp + "attention.output.dense")
        _export_layer_norm(state, src + "ln2", out, lp + "layernorm_after")
        _export_linear(state, src + "mlp_in", out, lp + "intermediate.dense")
        _export_linear(state, src + "mlp_out", out, lp + "output.dense")

    if include_pooler:
        out[p + "pooler.dense.weight"] = np.zeros((h, h), np.float32)
        out[p + "pooler.dense.bias"] = np.zeros((h,), np.float32)
    return out


def export_vitseg_state(state: Mapping, cfg: ViTSegConfig,
                        backbone_prefix: str = "model.backbone.",
                        head_prefix: str = "model.seg_head.",
                        include_pooler: bool = True) -> Dict[str, Array]:
    """The port's ``ViTSeg`` state dict -> the reference
    ViTSegmentationModel state_dict (Lightning ``model.`` prefixes, head
    Sequential indices 0 and 2, reference model/CE/classes.py:240-244)."""
    backbone = {k[len("backbone."):]: v for k, v in state.items()
                if k.startswith("backbone.")}
    out = export_hf_vit_state(backbone, cfg.vit, backbone_prefix,
                              include_pooler=include_pooler)
    _export_conv(state, "head_conv1", out, head_prefix + "0")
    _export_conv(state, "head_conv2", out, head_prefix + "2")
    return out


def save_lightning_checkpoint(path: str, state: Mapping, cfg: ViTSegConfig,
                              *, epoch: int = 0, global_step: int = 0) -> str:
    """Write a torch-loadable .ckpt with the reference's checkpoint shape,
    ``{"state_dict": ..., "epoch": N, "global_step": M}`` (the fields its
    eval harness reads: datasetTestViTmodel.py:131 parses ``epoch=`` from
    the file name, testViTModel.py:117 the dict)."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in export_vitseg_state(state, cfg).items()}
    torch.save({"state_dict": tensors, "epoch": epoch,
                "global_step": global_step}, path)
    return path


def convert_hf_segformer_state(state: Mapping, encoder_name: str) -> dict:
    """HF ``SegformerModel`` / ``SegformerForSemanticSegmentation`` state
    dict -> the MiT encoder's tree in the TPU package's layout (numpy
    leaves; linear kernels (in, out), conv kernels HWIO), which
    ``ckpt/convert.py:conv_params_from_jax`` turns into the port's state
    dict. The ``segformer.`` prefix of the wrapper is stripped; HF's keys
    (modeling_segformer.py): ``encoder.patch_embeddings.{i}.{proj,
    layer_norm}``, ``encoder.block.{i}.{j}.{layer_norm_1, attention.self.
    (query|key|value|sr|layer_norm), attention.output.dense, layer_norm_2,
    mlp.(dense1|dwconv.dwconv|dense2)}``, ``encoder.layer_norm.{i}``. The
    depthwise Mix-FFN kernel arrives as (C, 1, 3, 3) and becomes the
    (3, 3, 1, C) HWIO kernel of groups = C."""
    state = {k.removeprefix("segformer."): v for k, v in state.items()}
    _, depths, _, srs = MIT_PRESETS[encoder_name]
    stages = []
    for i, (depth, sr) in enumerate(zip(depths, srs)):
        blocks = []
        for j in range(depth):
            b = f"encoder.block.{i}.{j}."
            attn = {"q": _linear(state, b + "attention.self.query"),
                    "k": _linear(state, b + "attention.self.key"),
                    "v": _linear(state, b + "attention.self.value"),
                    "proj": _linear(state, b + "attention.output.dense")}
            if sr > 1:
                attn["sr"] = _conv(state, b + "attention.self.sr")
                attn["sr_ln"] = _layer_norm(state,
                                            b + "attention.self.layer_norm")
            blocks.append({
                "ln1": _layer_norm(state, b + "layer_norm_1"),
                "attn": attn,
                "ln2": _layer_norm(state, b + "layer_norm_2"),
                "ffn": {"fc1": _linear(state, b + "mlp.dense1"),
                        "dw": _conv(state, b + "mlp.dwconv.dwconv"),
                        "fc2": _linear(state, b + "mlp.dense2")}})
        e = f"encoder.patch_embeddings.{i}."
        stages.append({"embed": _conv(state, e + "proj"),
                       "embed_ln": _layer_norm(state, e + "layer_norm"),
                       "blocks": blocks,
                       "norm": _layer_norm(state, f"encoder.layer_norm.{i}")})
    return {"stages": stages}


def convert_hf_segformer_seg_state(state: Mapping, cfg) -> dict:
    """HF ``SegformerForSemanticSegmentation`` state dict -> the whole
    segformer tree (``models/segformer.py``, a MiT encoder, ``head_norm=
    "affine"``) in the TPU package's layout. The decode head
    (modeling_segformer.py ``SegformerDecodeHead``):

    - ``linear_c.{i}.proj`` Linears become 1x1 conv projections ((out, in)
      transposed, as (1, 1, in, out) HWIO);
    - HF concatenates the upsampled levels deepest first, the port
      shallowest first, so the input-channel blocks of the bias-free
      ``linear_fuse`` kernel are reversed;
    - the inference-mode ``batch_norm`` folds to a per-channel affine,
      scale = gamma / sqrt(var + 1e-5), bias = beta - mean * scale (in
      fp32, as the TPU package folds it);
    - ``classifier`` is the 1x1 head."""
    state = {k.removeprefix("segformer."): v for k, v in state.items()}
    if cfg.head_norm != "affine":
        raise ValueError("HF decode-head weights need head_norm='affine' "
                         f"(the folded BatchNorm); got {cfg.head_norm!r}")
    params = convert_hf_segformer_state(state, cfg.encoder_name)
    c = cfg.embed_channels
    n_levels = len(cfg.level_channels)
    params["proj"] = [
        {"kernel": _to_np(state[f"decode_head.linear_c.{i}.proj.weight"])
         .T[None, None],
         "bias": _to_np(state[f"decode_head.linear_c.{i}.proj.bias"])}
        for i in range(n_levels)]
    fuse = _to_np(state["decode_head.linear_fuse.weight"])  # (C, L·C, 1, 1)
    fuse = fuse.reshape(c, n_levels, c, 1, 1)[:, ::-1].reshape(
        c, n_levels * c, 1, 1).transpose(2, 3, 1, 0)
    gamma, beta, mean, var = (
        _to_np(state[f"decode_head.batch_norm.{k}"])
        for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + 1e-5)
    params["fuse"] = {"conv": {"kernel": np.ascontiguousarray(fuse),
                               "bias": np.zeros((c,), np.float32)},
                      "affine": {"scale": scale,
                                 "bias": beta - mean * scale}}
    params["head"] = _conv(state, "decode_head.classifier")
    params["norm_mean"] = np.asarray(IMAGENET_MEAN, np.float32)
    params["norm_std"] = np.asarray(IMAGENET_STD, np.float32)
    return params
