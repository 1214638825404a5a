"""Resize -> normalize -> patchify -> patch embed as one folded contraction.

The TPU package's ``ops/fused_preproc.py``. Every step from a raw image to
the patch embeddings is linear (the normalize is affine), so the chain
folds offline, in float64 numpy, into constants applied to the raw image:

- the bilinear resize (align_corners=False) is separable: the row stage
  stays one product with ``wh`` (compute, in) (``ops/resize.py``'s
  ``bilinear_matrix``, times ``input_scale``, which folds a uint8 -> [0, 1]
  conversion);
- the column stage, the normalize and the patch-embed projection fold into
  one kernel per column patch, ``K[pc][(ph, v', c), j] = sum_pw
  Ww[p·pc + pw, v0 + v'] · Wp[(ph, pw, c), j] / std[c]``: output patch
  column pc reads only input columns [v0(pc), v0(pc) + DV);
- the mean folds into the bias, ``b'_j = b_j - sum Wp[(., ., c), j] ·
  mean[c] / std[c]``.

``fused_resize_embed`` then takes the row product, a gather of the column
windows and one batched product with K, in the compute dtype. The result
equals the unfused chain up to floating-point association.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from visiontransformer_tpu_torch.ops.resize import bilinear_matrix


def _fold_constants(patch_embed: dict, *, patch_size: int, in_size: int,
                    compute_size: int, mean, std, input_scale: float):
    """The offline fold in float64, the TPU package's arithmetic. Returns
    numpy arrays: wh (compute, in) fp32, vidx (gp, DV) int32, K (gp,
    p·DV·C, hidden) fp32, bias (hidden,) fp32."""
    if compute_size % patch_size:
        raise ValueError(f"{compute_size=} not divisible by {patch_size=}")
    gp = compute_size // patch_size  # patches per side
    wp = np.asarray(patch_embed["kernel"], np.float64)  # (p*p*C, hidden)
    hidden = wp.shape[1]
    n_ch = wp.shape[0] // (patch_size * patch_size)
    wp4 = wp.reshape(patch_size, patch_size, n_ch, hidden)  # (ph, pw, c, j)

    mean = np.asarray(mean, np.float64).reshape(n_ch)
    std = np.asarray(std, np.float64).reshape(n_ch)

    # The normalize folds into the projection: W' = Wp/std, bias' takes
    # -mean/std.
    wp4 = wp4 / std[None, None, :, None]
    bias = np.zeros(hidden, np.float64)
    if patch_embed.get("bias") is not None:
        bias = bias + np.asarray(patch_embed["bias"], np.float64)
    bias = bias - np.einsum("hwcj,c->j", wp4, mean)

    wh = bilinear_matrix(compute_size, in_size).astype(np.float64) * input_scale
    ww = bilinear_matrix(compute_size, in_size).astype(np.float64)

    # Column support of each output patch column: rows p·pc .. p·pc + p-1.
    supports = []
    for pc in range(gp):
        rows = ww[pc * patch_size:(pc + 1) * patch_size]
        nz = np.nonzero(rows.sum(axis=0) != 0.0)[0]
        supports.append((int(nz.min()), int(nz.max())))
    dv = max(hi - lo + 1 for lo, hi in supports)
    v0 = np.array([min(lo, in_size - dv) for lo, _ in supports], np.int32)

    k_mats = np.zeros((gp, patch_size * dv * n_ch, hidden), np.float32)
    for pc in range(gp):
        seg = ww[pc * patch_size:(pc + 1) * patch_size,
                 v0[pc]:v0[pc] + dv]                      # (pw, v')
        k = np.einsum("pv,hpcj->hvcj", seg, wp4)          # (ph, v', c, j)
        k_mats[pc] = k.reshape(-1, hidden).astype(np.float32)

    vidx = v0[:, None] + np.arange(dv, dtype=np.int32)[None, :]
    return wh.astype(np.float32), vidx, k_mats, bias.astype(np.float32)


def build_fused_embed(patch_embed: dict, *, patch_size: int, in_size: int,
                      compute_size: int, mean, std, input_scale: float = 1.0,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict:
    """The constants of ``fused_resize_embed``, as tensors on ``device``.
    ``patch_embed``: the patch-embed linear's {"kernel": (p²C, hidden),
    "bias"} (arrays or tensors); ``in_size`` the raw side (e.g. 512),
    ``compute_size`` the backbone's (224)."""
    wh, vidx, k_mats, bias = _fold_constants(
        {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in patch_embed.items()},
        patch_size=patch_size, in_size=in_size, compute_size=compute_size,
        mean=mean, std=std, input_scale=input_scale)
    return {
        "wh": torch.from_numpy(wh).to(device),                 # (compute, in)
        "vidx": torch.from_numpy(vidx).long().to(device),      # (gp, DV)
        "k": torch.from_numpy(k_mats).to(device),  # (gp, p·DV·C, hidden)
        "bias": torch.from_numpy(bias).to(device),             # (hidden,)
        "patch_size": patch_size,
        "compute_size": compute_size,
    }


def fused_resize_embed(consts: Dict, raw: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, in, in, C) raw images (fp32 in [0, 1], or uint8 where the
    constants fold input_scale = 1/255) -> (B, N, hidden) patch embeddings
    in ``dtype``: the row resize, then the column resize, normalize and
    projection in one batched product."""
    p = consts["patch_size"]
    gp = consts["compute_size"] // p
    b, in_h, in_w, c = raw.shape
    dv = consts["vidx"].shape[1]

    y = torch.matmul(consts["wh"].to(dtype),
                     raw.to(dtype).reshape(b, in_h, in_w * c))
    y = y.reshape(b, gp, p, in_w, c)

    # Column windows: (B, gp, p, in, C) -> (B, pr, pc, p·DV·C).
    w = y[:, :, :, consts["vidx"]]           # (b, pr, ph, pc, v', c)
    w = w.permute(0, 1, 3, 2, 4, 5).reshape(b, gp, gp, p * dv * c)

    tokens = torch.einsum("brpk,pkj->brpj", w, consts["k"].to(dtype))
    tokens = tokens + consts["bias"].to(dtype)
    return tokens.reshape(b, gp * gp, -1)
