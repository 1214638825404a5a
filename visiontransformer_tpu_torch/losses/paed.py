"""PAED (edge-aware, signed-distance-field) losses (the TPU package's
``losses/paed.py``, reference model/PAED/classes.py):

- ``paed_loss_soft``: Sobel edge map × exterior SDF minus interior SDF ×
  occupancy (classes.py:623-661);
- ``paed_binary_total_loss``: the binary trainer's BCE + 0.1·dice +
  5.0·|paed_soft| (classes.py:679-681);
- ``paed_loss_multiclass_soft``: Gaussian-blurred one-hot difference with
  the wrong-class penalty (classes.py:336-369); the 19×19 Gaussian (σ = 3)
  is an exact outer product, applied as two 19-tap depthwise convolutions;
- ``paed_loss_hard``: the skeleton × SDF variant (classes.py:550-577), on
  the host like the reference's.

Tensors are NHWC, as in the TPU package: (B, H, W, 1) predictions, (B, H,
W) SDFs; the convolutions cross to NCHW and back at their boundary.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.losses.basic import (
    binary_cross_entropy,
    dice_loss,
)
from visiontransformer_tpu_torch.ops.resize import resize_bilinear
from visiontransformer_tpu_torch.parallel.launch import global_mean

_SOBEL_X = ((1.0, 0.0, -1.0),
            (2.0, 0.0, -2.0),
            (1.0, 0.0, -1.0))


def paed_loss_soft(gt_sdf_ext: torch.Tensor, gt_sdf_int: torch.Tensor,
                   preds: torch.Tensor, *, data_group=None) -> torch.Tensor:
    """Soft PAED loss (reference model/PAED/classes.py:623-661).

    preds: (B, H, W, 1) probabilities in [0, 1]; gt_sdf_ext / gt_sdf_int:
    (B, Hs, Ws) normalised SDFs, resized here with the gather-form bilinear
    resize (align_corners=False, as the reference at :635-636). The edge
    map is normalised by its max per image with ``amax``, whose gradient
    splits evenly among tied maxima, as ``jnp.max``'s does. ``data_group``:
    the two batch means over the data-parallel ranks' rows too."""
    preds = preds.float()
    b, h, w, _ = preds.shape
    sdf_ext = resize_bilinear(gt_sdf_ext.float(), (h, w))[..., None]
    sdf_int = resize_bilinear(gt_sdf_int.float(), (h, w))[..., None]

    sobel = torch.tensor(_SOBEL_X, dtype=torch.float32, device=preds.device)
    kernels = torch.stack([sobel, sobel.T])[:, None]           # (2, 1, 3, 3)
    grads = F.conv2d(preds.permute(0, 3, 1, 2), kernels, padding=1)
    edge_map = torch.sqrt(grads[:, 0] ** 2 + grads[:, 1] ** 2 + 1e-6)
    max_per_image = torch.amax(edge_map, dim=(1, 2), keepdim=True)
    edge_map = (edge_map / (max_per_image + 1e-6))[..., None]  # (B, H, W, 1)

    external_term = global_mean(torch.mean(sdf_ext * edge_map), data_group)
    internal_term = global_mean(torch.mean(sdf_int * preds), data_group)
    return 1.0 * external_term - 0.5 * internal_term


def paed_binary_total_loss(preds: torch.Tensor, masks: torch.Tensor,
                           sdf_ext: torch.Tensor, sdf_int: torch.Tensor, *,
                           data_group=None):
    """BCE + 0.1·dice + 5.0·|paed| (reference model/PAED/classes.py:
    679-681). Returns (total, {"bce", "dice", "paed"}). ``data_group``:
    the dice's sums and the PAED term's means are the global batch's (the
    BCE is a mean of rows, which the data-parallel average makes
    global)."""
    paed = paed_loss_soft(sdf_ext, sdf_int, preds, data_group=data_group)
    bce = binary_cross_entropy(preds, masks)
    dce = dice_loss(preds, masks, data_group=data_group)
    total = bce + 0.1 * dce + 5.0 * torch.abs(paed)
    return total, {"bce": bce, "dice": dce, "paed": paed}


def _gauss_1d(sigma: float, device) -> torch.Tensor:
    """The normalised 1-D Gaussian of 6σ + 1 taps, in fp32."""
    size = int(6 * sigma + 1)
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _depthwise_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W, C), equal to the reference's
    normalised 2-D kernel (outer(g, g)/sum factorises as (g/Σg) ⊗ (g/Σg)):
    a vertical, then a horizontal depthwise convolution with zero
    padding."""
    g = _gauss_1d(sigma, x.device)
    size, c = g.numel(), x.shape[-1]
    pad = size // 2
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, g.reshape(1, 1, size, 1).expand(c, 1, size, 1),
                 padding=(pad, 0), groups=c)
    y = F.conv2d(y, g.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                 padding=(0, pad), groups=c)
    return y.permute(0, 2, 3, 1)


def paed_loss_multiclass_soft(msk: torch.Tensor, pred_mask: torch.Tensor,
                              sigma: float = 3.0,
                              class_penalty: bool = True) -> torch.Tensor:
    """Multiclass soft PAED (reference model/PAED/classes.py:336-369).

    msk: (B, H, W, C) one-hot ground truth; pred_mask: (B, H, W, C) softmax
    probabilities."""
    msk, pred_mask = msk.float(), pred_mask.float()
    base_loss = torch.abs(_depthwise_blur(msk, sigma)
                          - _depthwise_blur(pred_mask, sigma))
    if class_penalty:
        penalty_map = msk * (1.0 - pred_mask) * base_loss * 2.0
        dist = torch.mean(penalty_map, dim=(1, 2))  # (B, C) spatial mean
    else:
        dist = torch.mean(base_loss, dim=(1, 2))
    return torch.mean(torch.mean(dist, dim=1))


def paed_loss_hard(pred_probs: np.ndarray, sdf_ext: np.ndarray,
                   sdf_int: np.ndarray, threshold: float = 0.5) -> float:
    """Hard skeleton × SDF PAED (reference model/PAED/classes.py:550-577),
    host numpy like the reference's (which round-trips through skimage
    per image). pred_probs: (B, H, W); sdf_*: (B, Hs, Ws)."""
    from visiontransformer_tpu_torch import native

    b, h, w = pred_probs.shape[:3]
    total = 0.0
    for i in range(b):
        pred_bin = (pred_probs[i] > threshold).astype(np.float32)
        skel = native.skeletonize(pred_bin > 0.5).astype(np.float32)
        ext = resize_bilinear(torch.from_numpy(np.asarray(sdf_ext[i])),
                              (h, w)).numpy()
        interior = resize_bilinear(torch.from_numpy(np.asarray(sdf_int[i])),
                                   (h, w)).numpy()
        total += float(np.sum(ext * skel - interior * pred_bin))
    return total / b
