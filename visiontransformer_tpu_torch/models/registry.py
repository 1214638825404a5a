"""Model family registry: name -> (init, apply, config type), the TPU
package's ``models/registry.py``, with ``resolve_model``'s checkpoint
loading (a port checkpoint directory, a reference Lightning ``.ckpt`` for
vitseg, a pretrained HF SegFormer directory for segformer, an HF
``SamModel`` directory for sam, or a TPU-package Orbax checkpoint where
tensorstore is installed).

``vitseg`` is the primary network; the ten conv families share the
residual GroupNorm encoder of ``models/unet.py`` and differ in their
decoders; ``segformer`` puts the all-MLP decoder on a MiT preset
(``models/mit.py``) or on that encoder. ``sam`` (``models/sam.py``), which
the TPU package does not have, is served with a box prompt an image and is
not trained. An init takes (generator, cfg) and returns the model on the
CPU; an apply takes (model, NHWC images, ...) and returns NHWC fp32
logits.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from visiontransformer_tpu_torch.ckpt.convert import conv_params_from_jax
from visiontransformer_tpu_torch.ckpt.hf_dir import (
    is_hf_dir,
    read_hf_sam,
    read_hf_segformer,
)
from visiontransformer_tpu_torch.ckpt.io import restore_checkpoint
from visiontransformer_tpu_torch.ckpt.orbax_read import (
    is_orbax_dir,
    model_from_params,
    read_orbax_tree,
    tree_config,
)
from visiontransformer_tpu_torch.ckpt.torch_convert import (
    convert_hf_segformer_seg_state,
    load_lightning_checkpoint,
)
from visiontransformer_tpu_torch.configs import (
    ViTSegConfig,
    sweep_by_name,
    vit_config_by_name,
)
from visiontransformer_tpu_torch.device import resolve_device
from visiontransformer_tpu_torch.models.deeplab import (
    DeepLabV3Config,
    DeepLabV3PlusConfig,
    deeplabv3_apply,
    deeplabv3_init,
    deeplabv3plus_apply,
    deeplabv3plus_init,
)
from visiontransformer_tpu_torch.models.fpn import FPNConfig, fpn_apply, fpn_init
from visiontransformer_tpu_torch.models.linknet import (
    LinkNetConfig,
    linknet_apply,
    linknet_init,
)
from visiontransformer_tpu_torch.models.manet import (
    MAnetConfig,
    manet_apply,
    manet_init,
)
from visiontransformer_tpu_torch.models.mit import MIT_PRESETS
from visiontransformer_tpu_torch.models.pan import PANConfig, pan_apply, pan_init
from visiontransformer_tpu_torch.models.sam import (
    SAM_PRESETS,
    SamConfig,
    SamMasks,
    SamSeg,
    sam_apply,
    sam_config,
    sam_init,
)
from visiontransformer_tpu_torch.models.pspnet import (
    PSPNetConfig,
    pspnet_apply,
    pspnet_init,
)
from visiontransformer_tpu_torch.models.segformer import (
    SegformerConfig,
    segformer_apply,
    segformer_init,
)
from visiontransformer_tpu_torch.models.unet import (
    ENCODER_PRESETS,
    UNetConfig,
    unet_apply,
    unet_init,
)
from visiontransformer_tpu_torch.models.unetpp import (
    UNetPlusPlusConfig,
    unetplusplus_apply,
    unetplusplus_init,
)
from visiontransformer_tpu_torch.models.upernet import (
    UPerNetConfig,
    upernet_apply,
    upernet_init,
)
from visiontransformer_tpu_torch.models.vitseg import (
    MasksForward,
    ViTSeg,
    vitseg_apply,
)
from visiontransformer_tpu_torch.ops.quant import (
    quantize_conv_model_,
    quantize_vit_,
)


class ModelFamily(NamedTuple):
    init: Callable
    apply: Callable
    config_cls: type


def init_vitseg_(model: ViTSeg, generator: torch.Generator) -> ViTSeg:
    """HF-ViT initialisation in place: trunc-normal(initializer_range,
    ±2 std) kernels and embeddings, zero biases, unit LayerNorm scales.
    Same distribution as the TPU package's init, not the same bits."""
    std = model.cfg.vit.initializer_range
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            else:  # kernel, cls_token, pos_embed
                torch.nn.init.trunc_normal_(p, std=std, a=-2 * std,
                                            b=2 * std, generator=generator)
    return model


def vitseg_init(generator: torch.Generator, cfg: ViTSegConfig) -> ViTSeg:
    return init_vitseg_(ViTSeg(cfg), generator)


MODEL_FAMILIES = {
    "vitseg": ModelFamily(vitseg_init, vitseg_apply, ViTSegConfig),
    "unet": ModelFamily(unet_init, unet_apply, UNetConfig),
    "fpn": ModelFamily(fpn_init, fpn_apply, FPNConfig),
    "linknet": ModelFamily(linknet_init, linknet_apply, LinkNetConfig),
    "pspnet": ModelFamily(pspnet_init, pspnet_apply, PSPNetConfig),
    "deeplabv3": ModelFamily(deeplabv3_init, deeplabv3_apply,
                             DeepLabV3Config),
    "deeplabv3plus": ModelFamily(deeplabv3plus_init, deeplabv3plus_apply,
                                 DeepLabV3PlusConfig),
    "unetplusplus": ModelFamily(unetplusplus_init, unetplusplus_apply,
                                UNetPlusPlusConfig),
    "pan": ModelFamily(pan_init, pan_apply, PANConfig),
    "manet": ModelFamily(manet_init, manet_apply, MAnetConfig),
    "upernet": ModelFamily(upernet_init, upernet_apply, UPerNetConfig),
    "segformer": ModelFamily(segformer_init, segformer_apply,
                             SegformerConfig),
    "sam": ModelFamily(sam_init, sam_apply, SamConfig),
}
# The ten families on the shared GroupNorm encoder alone.
CONV_FAMILIES = tuple(name for name in MODEL_FAMILIES
                      if name not in ("vitseg", "segformer", "sam"))


def get_model_family(name: str) -> ModelFamily:
    try:
        return MODEL_FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown model family {name!r}; "
                       f"known: {sorted(MODEL_FAMILIES)}") from None


def vitseg_config(config_name: str, *, num_classes: int,
                  input_size: int = 224,
                  compute_dtype: str = "bfloat16") -> ViTSegConfig:
    """ViTSegConfig from a sweep row name ("P16H768A12") or a named size
    preset ("vit_b_16" / "vit_l_16" / "vit_h_14") at ``input_size``."""
    try:
        vit_cfg = sweep_by_name(config_name).vit_config(image_size=input_size)
    except KeyError:
        vit_cfg = vit_config_by_name(config_name, image_size=input_size)
    if input_size % vit_cfg.patch_size:
        raise ValueError(
            f"input_size {input_size} is not divisible by "
            f"{config_name}'s patch size {vit_cfg.patch_size}")
    return ViTSegConfig(vit=vit_cfg, num_classes=num_classes,
                        compute_dtype=compute_dtype)


def encoder_presets(family: str) -> list:
    """The encoder presets a non-vitseg family takes: ``ENCODER_PRESETS``,
    and for segformer the MiT presets too; sam's presets for sam."""
    if family == "sam":
        return sorted(SAM_PRESETS)
    return sorted(ENCODER_PRESETS) + (
        sorted(MIT_PRESETS) if family == "segformer" else [])


def model_config(family: str, config_name: str, *, num_classes: int,
                 input_size: int = 224, compute_dtype: str = "bfloat16"):
    """The config of a named model: ``config_name`` is a sweep config or
    ViT size preset for vitseg, a SAM preset for sam (at ``input_size``;
    its masks are {0, 1} whatever ``num_classes``), an encoder preset
    (``encoder_presets``) for the other families, which take any input
    size."""
    fam = get_model_family(family)
    if family == "vitseg":
        return vitseg_config(config_name, num_classes=num_classes,
                             input_size=input_size,
                             compute_dtype=compute_dtype)
    if family == "sam":
        return sam_config(config_name, input_size=input_size,
                          compute_dtype=compute_dtype)
    if config_name not in encoder_presets(family):
        raise KeyError(f"unknown encoder preset {config_name!r}; known: "
                       f"{encoder_presets(family)}")
    return fam.config_cls(encoder_name=config_name, num_classes=num_classes,
                          compute_dtype=compute_dtype)


def resolve_model(family: str, config_name: str, *, num_classes: int,
                  input_size: int = 224, compute_dtype: str = "bfloat16",
                  checkpoint_path: str = "",
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[object, nn.Module]:
    """(cfg, model) for a named model of any ported family, in eval mode on
    ``device`` (None means CUDA; raises without it).

    checkpoint_path: for segformer, a directory holding a ``config.json``
    is an HF ``save_pretrained`` directory of a
    ``SegformerForSemanticSegmentation`` (``ckpt/hf_dir.py``): its MiT
    preset (matched by geometry), class count and decode width replace
    ``config_name``'s and ``num_classes``, the head takes the folded
    BatchNorm (``head_norm="affine"``), as the TPU package's does. For sam,
    such a directory is an HF ``SamModel`` directory (``read_hf_sam``): its
    geometry, matched to a preset, replaces ``config_name``'s, and its
    image size must be ``input_size``. Any
    other directory is a port checkpoint (``ckpt/io.py``); its
    ``params``, or the whole tree if it has none, load strictly (a W8A8
    state dict into the model's W8A8 form). A path
    ending in ``.ckpt`` is a reference Lightning file
    (``ckpt/torch_convert.py``), for vitseg only: a conv family refuses
    it, as the TPU package does. Empty means random weights from a
    generator seeded with 0 (the same weights on every call, like the TPU
    package's PRNGKey(0)). A directory holding ``_METADATA`` and
    ``manifest.ocdbt`` is a TPU-package Orbax checkpoint, converted in
    memory where tensorstore is installed (``ckpt/orbax_read.py``;
    segformer takes its decode width and head norm from it); without
    tensorstore it raises ImportError naming ``convert-orbax``. Any other
    path raises: the TPU package falls through to random weights there,
    which would serve random masks under a trained model's name. The weights load on the CPU and the model
    moves to the device once."""
    dev = resolve_device(device)
    cfg = model_config(family, config_name, num_classes=num_classes,
                       input_size=input_size, compute_dtype=compute_dtype)
    if family == "sam" and checkpoint_path and is_hf_dir(checkpoint_path):
        return _resolve_hf_sam(checkpoint_path, input_size, compute_dtype,
                               dev)
    if family == "segformer" and checkpoint_path and is_hf_dir(
            checkpoint_path):
        hf_cfg, state = read_hf_segformer(checkpoint_path)
        cfg = dataclasses.replace(
            cfg, encoder_name=hf_cfg["encoder_name"], head_norm="affine",
            num_classes=hf_cfg["num_labels"],
            embed_channels=hf_cfg["decoder_hidden_size"])
        params = conv_params_from_jax(convert_hf_segformer_seg_state(
            state, cfg))
    elif checkpoint_path and is_orbax_dir(checkpoint_path):
        tree = read_orbax_tree(checkpoint_path)
        cfg = tree_config(family, tree["params"], cfg)
        return cfg, model_from_params(family, tree["params"], cfg).to(
            dev).eval()
    else:
        params = (_checkpoint_params(checkpoint_path, family, cfg)
                  if checkpoint_path else None)
    if params is None:
        model = get_model_family(family).init(
            torch.Generator().manual_seed(0), cfg)
    else:
        # The weights are overwritten: vitseg skips its init's draws.
        model = (ViTSeg(cfg) if family == "vitseg" else
                 get_model_family(family).init(torch.Generator(), cfg))
        if any(k.endswith(".kernel_q") for k in params):
            # A W8A8 checkpoint: the model takes the form it was saved in.
            quantize_int8_(model)
        model.load_state_dict(params, strict=True)
    return cfg, model.to(dev).eval()


def _resolve_hf_sam(path: str, input_size: int, compute_dtype: str,
                    dev: torch.device) -> Tuple[SamConfig, SamSeg]:
    """(cfg, model) of an HF ``SamModel`` directory: the model is built
    without storage and takes the read tensors as its own (strictly), so
    the weights are held once on the host."""
    _, cfg, state = read_hf_sam(path, compute_dtype)
    if cfg.image_size != input_size:
        raise ValueError(f"{path} holds SAM at {cfg.image_size}^2; the row "
                         f"asks for input_size {input_size}")
    with torch.device("meta"):
        model = SamSeg(cfg)
    model.load_state_dict(state, strict=True, assign=True)
    return cfg, model.to(dev).eval()


def quantize_int8_(model: nn.Module) -> None:
    """The family's W8A8 form, in place (``ops/quant.py``): vitseg's
    encoder linears; every other family's linears and interior convs. sam
    has none: it raises."""
    if isinstance(model, SamSeg):
        raise ValueError("the int8 (W8A8) opt-in is not defined for sam")
    if isinstance(model, ViTSeg):
        quantize_vit_(model.backbone)
    else:
        quantize_conv_model_(model)


class ArgmaxMasks(nn.Module):
    """Every other family's masks forward, as the TPU runner serves it:
    ``argmax(model(images))`` in ``mask_dtype``, in one piece."""

    cut = False

    def __init__(self, model: nn.Module, mask_dtype: torch.dtype):
        super().__init__()
        self.model, self.mask_dtype = model, mask_dtype

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.model(images), dim=-1).to(self.mask_dtype)


def serving_forward(model: nn.Module, *, out_size: Tuple[int, int],
                    mask_dtype: torch.dtype, attn_impl: str = "auto",
                    epilogue: str = "auto") -> nn.Module:
    """What the model's family serves, as a module holding the model:
    (B, H, W, 3) images in [0, 1] -> masks in ``mask_dtype``; vitseg's
    ``MasksForward`` (``cut``: the runner graphs it), sam's ``SamMasks``
    (``prompted``: it also takes (B, 4) boxes; ``out_size`` its image
    size), any other family's ``ArgmaxMasks`` (input size; no
    ``attn_impl`` or ``epilogue``)."""
    if isinstance(model, SamSeg):
        if tuple(out_size) != (model.cfg.image_size,) * 2:
            raise ValueError(f"SAM serves masks at its image size "
                             f"{model.cfg.image_size}, not {out_size}")
        return SamMasks(model, mask_dtype, attn_impl=attn_impl)
    if isinstance(model, ViTSeg):
        return MasksForward(model, out_size, mask_dtype,
                            attn_impl=attn_impl, epilogue=epilogue)
    return ArgmaxMasks(model, mask_dtype)


def _checkpoint_params(path: str, family: str, cfg):
    if os.path.isdir(path):
        from visiontransformer_tpu_torch.parallel.pipeline import (
            maybe_unstack_params,
        )

        tree = restore_checkpoint(path)
        # A pipeline checkpoint's layers are stacked: serve them per layer.
        return maybe_unstack_params(tree["params"] if "params" in tree
                                    else tree)
    if path.endswith(".ckpt"):
        if family != "vitseg":
            raise ValueError(
                "Lightning .ckpt conversion is defined for the vitseg "
                "family only; load conv families from checkpoint "
                "directories of the port")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint {path} does not exist")
        return load_lightning_checkpoint(path, cfg)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    raise ValueError(f"checkpoint {path} is neither a checkpoint directory "
                     f"nor a reference .ckpt file")
