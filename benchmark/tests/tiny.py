"""Tiny configurations and a CPU context for driving the harness here."""

import time

import torch

from benchmark import harness

# A configuration the port knows by name (P16H512A8) at a size the CPU
# runs in seconds: 8 layers of width 512, 2 x 2 patches of 16 at 32².
# The P4 configuration's tiny form takes patches of 8 (a 4 x 4 grid).
TINY = dict(image_size=32, hidden_size=512, num_hidden_layers=8,
            num_attention_heads=8)
PATCH = {"vitseg_b16": 16, "vitseg_p4": 8}


def config(name="vitseg_b16", **overrides):
    cfg = harness.load_config(name)
    patch = PATCH[name]
    cfg.update(TINY, patch_size=patch, port_config_name=f"P{patch}H512A8")
    cfg.update(overrides)
    return cfg


def context(cfg, traffic, tmpdir, *, limits=None, seed=2 ** 31 + 4242,
            seconds=2.0, trace=False, name="tiny"):
    return harness.Context(
        cell={"name": name, "chips": 1}, config=cfg, traffic=traffic,
        limits=limits or {}, seed=seed, seconds=seconds, trace=trace,
        device=torch.device("cpu"), t0=time.perf_counter(), tmpdir=tmpdir)


def port_config(cfg: dict):
    """The port's own configuration of a tiny configuration's model."""
    from visiontransformer_tpu_torch.configs import (
        ViTSegConfig,
        vit_config_by_name,
    )
    vit = vit_config_by_name(cfg["port_config_name"],
                             image_size=cfg["image_size"],
                             layer_norm_eps=cfg["layer_norm_eps"])
    return ViTSegConfig(vit=vit, num_classes=cfg["num_classes"],
                        head_channels=cfg["head_channels"],
                        compute_dtype=cfg["compute_dtype"])
