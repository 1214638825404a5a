"""GPU smoke test of the PyTorch/CUDA port (visiontransformer_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). It builds the
port's kernels from visiontransformer_tpu_torch/csrc, then runs the
phases below, each printing JSON lines, and raises (exit code != 0) on any
failure:

1. env       card, power limit, torch/CUDA versions, kernel build time;
2. flash     flash-attention kernel vs its plain version, bf16 and fp32,
             at the serving shape (B*H = 384, N = 197, d = 64), at
             N = 785/1025/3137, at d = 80/16/32/128, and on the edges of
             the forward kernels' 64-row and 64-key tiles (N = 1, 63, 64,
             65, 127, 129, 255, 256, 257 at d = 64, 32 and 128, 48 heads),
             so every instantiation (bf16 "wgmma" at d = 64, "stream" at
             the other head dims, fp32 "scalar"; forward_path) is checked;
             at (B*H, N) = (384, 197), (192, 1025), (24, 3137), d = 64,
             kernel 1 and kernel 2 (dropout 0 and 0.1) timed by device time
             against the plain version and F.scaled_dot_product_attention
             at the same rates (one flash_forward line per shape, printed
             at the end with those of flash_train's timed shapes);
2a. flash_keys  kernel 1 with a key count of its own (Nk != Nq, MiT's
             spatial-reduction attention): SegFormer-B5's four stage
             shapes at 1024^2, batch 2 ((B, H, Nq, Nk) = (2, 1, 65536,
             1024), (2, 2, 16384, 1024), (2, 5, 4096, 1024), (2, 8, 1024,
             1024)), and partial key tiles (Nk = 49, 400) at d = 64 and 32,
             bf16 and fp32, vs the plain version; the four stage shapes
             at the serving bucket (batch 8), where the fill rule may take
             another block size (forward_block_rows, on each line), vs the
             plain version too, and timed by device time beside
             F.scaled_dot_product_attention and the bound; one bf16
             mit_b5 forward through ModelRunner's path, counting
             mit.attention_flash (52 a forward), mit.attention_eager (0)
             and kernel 1's launches (52);
2c. flash_bias  kernel 1 with SAM's decomposed relative-position bias
             (flash_attention_bias: key k of row i adds rel_h[i, k // kw]
             + rel_w[i, k % kw]) against its plain version, bf16, q, k, v
             strided views of a fused QKV and the bias terms spreading
             about 1: at d = 80 (the "stream" ring) SAM-H's shapes at the
             serving bucket of 8, (B*H, N, kh x kw) = (3200, 196, 14 x 14)
             windowed and (128, 4096, 64 x 64) global; at d = 64 ("wgmma")
             SAM-B's (2400, 196), (96, 4096) and SAM-L's (3200, 196),
             (128, 4096); partial row and key tiles (3 x 6, 13 x 10,
             17 x 8) at both head dims; each of SAM's shapes timed by
             device time beside F.scaled_dot_product_attention with the
             bias materialised as attn_mask (its materialisation not
             timed) and the bound; the registers and spills ptxas gave
             the bias instantiations; one SAM-H forward at 8 x 1024^2
             with a box each through the serving forward: 32 launches of
             the bias instantiation, 32 sam.attention_flash (28 windowed
             + 4 global), 0 sam.attention_eager, one launch of kernel 5
             for the masks, and its time; kernel 5 on the forward's
             logits (0, m) bit for bit against its tap-order plain
             version and against the plain step (resize, then > 0) but
             where the resized logit is within 1e-3 of the largest of 0;
2b. flash_variants  the tuning sweeps' kernels (6: softmax forms; 7:
             2 or 4 interleaved chains; 8, 9: transposed P·V), all on
             warpgroup products ("wgmma_tma"): both port sweeps
             (scripts/tune_flash2, tune_flash3) at their defaults, with
             their launches and kernel 1's counted; then every
             instantiation, and kernel 1 (the sweeps' production kernel),
             vs its plain version (kernel 6's bf16exp mode also vs a plain
             version that rounds its exp as the card does), bf16, at
             (B*H, N, d) = (192, 1025, 64), (384, 197, 64) and
             (24, 3137, 64), strided views of a fused QKV, and at the
             edges of their 64-row chains and 256-query blocks (B*H = 2,
             N = 1, 65, 257; checked, not timed); at the first two shapes
             every instantiation timed against kernel 1, SDPA and the
             bound, one configuration per kernel against its plain
             version; each line names its design (variant_path,
             chains_path), and one line gives the registers, blocks an SM
             and spilled bytes of every instantiation;
3. upsample  fused upsample+argmax kernel (kernel 5), fp32 and bf16
             logits into int32 and uint8 masks, on every instantiation
             (epilogue_path) at the timed shapes and the edges of its row
             tiles, runs and class chunks: bit for bit against the
             tap-form plain version, and against argmax(resize_bilinear_mm)
             (agreement, flips only on ties); ties to class 0 across a
             class chunk; a launch refused where one row's H-stage
             exceeds a block's shared memory; device time at B = 32, C = 17, grids 14, 28, 32,
             56 -> 512^2 and 14 -> 224^2 for both output types, beside
             F.interpolate + argmax + cast (two library calls, a yardstick
             the port never calls);
3a. layer_norm  kernel 10 (the LayerNorm, alone and after a bias and a
             residual add; ops/layer_norm.py) against its plain version, in
             bf16 at the serving shapes (rows, C) = (6304, 768) (ViT-B/16,
             bucket 32), (100384, 768) (P4H768A12), SegFormer-B5's
             (524288, 64), (131072, 128), (32768, 320), (8192, 512), and
             in fp32 at (6304, 768), in both forms, with and without the
             bias: s equal bit for bit, y within one bf16 ulp (fp32: 1e-5
             relative), one launch a call; each timed by device time
             beside its byte bound, the plain version and
             F.layer_norm (with the adds before it: a yardstick the port
             never calls); then ViT-B/16 through ModelRunner's CUDA graphs
             at bucket 32: 25 launches a forward in the eager pass before
             the capture and 25 in the capture, none plain, none in a
             replay;
3b. linear   the linears' bias in cuBLASLt's epilogue (nn/layers.py:
             linear) at every linear shape of the benchmark's cells
             (LINEAR_CASES: ViT-B/16 and P4H768A12 at bucket 32, the patch
             embedding, qkv and mlp_in; SegFormer-B5 at 8 crops of 1024^2,
             each stage's q, k, v, proj, fc1, fc2): one call in the
             epilogue, its largest error against the fp64 product of the
             same bf16 operands plus the bias no larger than the plain
             path's, each value within 1.5 bf16 ulps of the plain one
             (linear_agreement); the kernels each path launches (no
             elementwise add on the fused side); each timed by device time
             beside the product alone and its bound; then ViT-B/16 through
             ModelRunner's CUDA graphs at bucket 32 (25 linears in the
             epilogue in the eager pass and 25 in the capture, none plain,
             none in a replay) and one SegFormer-B5 forward at 1024^2 (312,
             none plain);
4. model     ViT-B/16 (17 classes, full width and depth, seeded random
             weights) on the bench workload: batch 32, 512^2 fp32 in,
             resize to 224^2, ImageNet normalize, vitseg_predict at 512^2
             into uint8 masks written by kernel 5; kernels vs plain paths
             in fp32 and bf16, and vs the int32 kernel route then a cast;
             launch counts per forward, masks/s;
5. serving   the port's HTTP server + InferenceWorker on cuda with the
             default P16H768A12 model; 8 PNG jobs through register/login/
             CSRF/POST/?wait= polling; every mask equals ModelRunner.predict
             of the same decoded image; ModelRunner.dispatch launches no
             kernel after kernel 5 (the uint8 masks are its output); jobs/s;
             the runner's CUDA graphs (graphed_runner_check): its masks
             equal vitseg_predict's and the per-block forward's
             (vitseg_head_logits, then kernel 5) bit for bit at every
             bucket 1-32, at
             ViT-B/16, at P4H768A12 and on a 2-replica mesh on the card,
             12 + 1 launches a forward, every dispatch served by replays.
6. flash_train  the training kernels (forward with lse and dropout, dQ,
             dK/dV) vs their plain versions, bf16 and fp32, dropout 0 and
             0.1 under one seed, at the training micro-batch
             (B*H = 48, N = 197, d = 64), (384, 197, 64), N = 785/1025/3137,
             d = 80/16/32/128, and on the edges of the backward kernels'
             64-row tiles (N = 1, 63, 64, 65, 127, 129, 255, 256, 257), so
             every instantiation of dQ and dK/dV (bf16 "wgmma" at d = 64,
             "stream" at the other head dims, fp32 "scalar") is checked;
             delta = rowsum(dO * O) from the dQ kernel's prologue vs
             PyTorch's; timed at (48, 197), (48, 785),
             (48, 1025) and (24, 3137), with and without dropout, against
             the plain versions and F.scaled_dot_product_attention (forward
             with dropout, and its backward as forward+backward minus
             forward), with one line for dQ + dK/dV + delta beside SDPA's
             backward;
7. train     the port's Trainer.fit on ViT-B/16 (17 classes, bf16, the CE
             defaults: batch 16 = 4 micro-batches of 4, dropout 0.1, Adam)
             over a 224^2 synthetic set: finite losses, 12 x 4 launches of
             each training kernel per optimizer step and none of the
             inference kernel; evaluate launches the inference kernel only;
             images/s and steps/s (best of 3 rounds, and at batch 32 with
             accumulate 1), peak memory, a profile of one step;
8. train_fp32_step  one fp32 optimizer step, dropout off, with the kernels
             and with eager attention on the same weights and batch: loss
             and every gradient agree.
9. train_bf16_dropout_step  one bf16 optimizer step with dropout 0.1,
             through the kernels and through their plain versions on the
             card (same weights, batch and seeds): loss and every gradient
             agree, so forward, dQ and dK/dV draw one mask on the path that
             trains.
10. checkpoint  train -> save -> resume -> register -> serve -> .ckpt ->
             export on ViT-B/16 (17 classes, bf16, 224^2, the CE defaults,
             the synthetic set of phase 7, two steps an epoch): one epoch
             of Trainer.fit with checkpoints, then a fresh Trainer resumes
             from them (params, Adam moments, step and learning rate equal
             the saved ones bit for bit, the moments non-zero); a resumed
             second epoch against two uninterrupted epochs (12 x 4
             launches of kernels 2-4 a step); the checkpoint registered in
             a store and served over HTTP (8 jobs, masks equal
             vitseg_predict of the trained model, 12 + 1 launches a
             forward); the reference .ckpt round trip through
             resolve_model (equal masks); export_serving/load_serving at
             batch 8 and 32 (12 + 1 custom-op nodes and launches a call,
             masks equal the eager forward), timed beside the eager
             forward by device_ms and host_ms; save and restore seconds,
             checkpoint bytes; the host seconds of each step. Every
             kernel of the path launched at least once.
11. paed     the binary crack task (paed_binary) on ViT-B/16 (1 class,
             bf16, 224^2, PAED_TRAIN_DEFAULTS: AdamW 1e-4, batch 16 = 4
             micro-batches of 4, dropout 0.1) over a 32-image
             generate_binary set: compute_sdf_batch on the card against
             scipy's EDT at (4, 224^2) and (4, 512^2) crack masks (an
             empty and a full mask against the port's CPU result), its
             device ms and peak memory; Trainer.fit, two epochs of two
             steps with validation and checkpoints (finite losses, 12 x 4
             launches of kernels 2-4 a step, kernel 1 only in validation,
             val_loss / val_IoU epoch metrics that the plateau and
             EarlyStopping monitors read); images/s and step seconds of a
             paed_binary step beside a CE step, in turns, with a profile
             of one step of each; one fp32 paed_binary step, dropout off,
             kernels against eager attention; one bf16 step each of
             paed_multiclass and paed_anchored on the CE set (17
             classes). The host seconds of each step.
12. eval_sweep  kernel 1 against its plain version (bf16) at the
             sweep's 9 shapes (4, heads 8/12/16, N 197/785/3137, 64),
             timed beside SDPA; the eval-sweep command
             (evaluation/evaluate.py) over the 9 sweep configs (CE, seeded
             weights, 224^2, batch 4, two batches): each CSV in the
             reference schema with 8 rows, kernel 1 launched layers x 2
             times and no other kernel, the confusion summing to the
             pixel count, images/s per config; for one config per token
             count (197, 785, 3137) the command's confusion .npy, and the
             CSV's Accuracy and Pred_Classes, against the masks of
             argmax(vitseg_apply) of the same seeded weights called
             directly on the same 8 images. Then eval-sweep --task
             paed_binary --ckpt-root on phase 11's checkpoint: its
             confusion and CSV held the same way against sigmoid(
             vitseg_apply) > 0.5 of the trained in-memory model, and the
             restored model's logits equal the trained one's bit for bit.
13. optin    the serving opt-ins and remat on ViT-B/16 (17 classes, bf16,
             seeded weights; batch 32, 512^2 in -> 224^2 -> 512^2 masks):
             kernel 1 against its plain version at every merged length
             (B*H = 384, N = 197 - i*r, i = 0..11, r = 8 and 16, d = 64);
             ToMe forwards at r = 8 and 16 (12 launches of kernel 1 at
             those lengths and 1 of kernel 5 a forward, masks' agreement
             with r = 0; r = 0 again after merging gives the plain masks
             bit for bit); the W8A8 forward (layer 0's four int8 products
             at the serving shape: the card's int32 accumulators equal the
             CPU's plain int32 product; masks against the quantized model
             on the CPU for one image); the fused preprocessing (fp32
             compute, fp32 and uint8 inputs: masks agree with the unfused
             forward on >= 0.999 of the pixels; bf16 recorded); a row
             registered with token_merge_r=16, quantize="int8" served
             over HTTP (8 jobs, every mask equals ModelRunner.predict);
             rows with ToMe r = 16, int8 and both served through the
             runner's CUDA graphs at buckets 8 and 32, equal to
             vitseg_predict and the per-block forward bit for bit
             (graphed_runner_check);
             one CE training step at r = 16 (12 x 4 launches of kernels
             2-4), then one step without and with remat from the same
             weights and seed under deterministic algorithms, two plain
             steps first: loss, every gradient and a dropout generator's
             final state (after one more forward and backward of the
             batch) equal bit for bit; peak memory of the step and of that
             forward and backward, and device ms, of both; masks/s, host ms, device ms and device kernels a
             forward of the exact, r = 8, r = 16, int8 and fused forwards
             in turns.
14. conv_families  the ten conv families (models/registry.py:
             CONV_FAMILIES) at full width, seeded weights, 17 classes,
             224^2: each at resnet34, and unet at resnet18, resnet50,
             mobilenetv2 and efficientnet_b0, the card's fp32 logits (TF32
             off) against the plain CPU forward of the same weights at
             batch 2 (atol 5e-5, the CPU parity tests'), and the bf16
             argmax's agreement with the fp32 one; device ms (queued) and
             host ms of one bf16 forward at batch 32 for every family, and
             for unet/resnet34 at 512^2; Trainer(model="unet") on resnet34
             at the CE defaults (bf16, batch 16 = 4 x 4), five steps
             (finite losses, images/s, device ms a step), one fp32 step
             (TF32 off) against the same step on the CPU (loss 1e-5,
             gradients 5e-5 / 5e-4); the trained weights saved, registered
             with register-model --family unet --config resnet34 --ckpt and
             served over HTTP (the mask equals ModelRunner.predict's); no
             launch of kernels 1-9 in the phase (no Pallas kernel lies on
             the JAX families' path).
15. segformer_export_int8  segformer (17 classes, 224^2, decode width
             256) on mit_b0, mit_b2 (SegFormer-B2's widths) and resnet34:
             the card's fp32 logits (TF32 off) against the CPU's at batch 2
             (atol 5e-5, fp32 argmax equal); device ms and host ms of one
             bf16 forward at batch 32 (mit_b2 also at 512^2; a forward
             whose launches overflow the device's queue is timed by the
             profiler's device sum, and says so); one fp32 mit_b0 CE step
             against the CPU's (loss 1e-5, gradients 5e-5 / 5e-4);
             Trainer(model="segformer") on mit_b2 at the CE defaults, five
             steps; int8 rows of unet/resnet34 and segformer/mit_b0: every
             W8A8 layer of one forward quantized and multiplied on the
             card (cuBLASLt's int8 product, im2col for the convs) and on
             the CPU, int8 activations, scales and int32 accumulators
             equal; int8 against bf16 at batch 32 (mask agreement and
             device ms, recorded); export-serving --family for
             unet/resnet34 and segformer/mit_b2 at 224^2, batch 8 (the
             program's masks equal ModelRunner.predict's bit for bit);
             the segformer row and both int8 rows registered and served
             over HTTP (each mask equals ModelRunner.predict's); kernel 1
             launched (the MiT rows' attention without a gradient), no
             launch of kernels 2-9 in the phase.
16. reports_tools  the train command on ViT-B/16 (17 classes, the CE
             defaults: bf16, batch 16 = 4 x 4, dropout 0.1) for one epoch
             of 10 steps over a 224^2 synthetic set, with --ckpt-dir,
             --logs and --profile-dir: launches of kernels 2-4 (12 x 4 a
             step) and 1 (validation) counted; the torch.profiler trace of
             steps 2-5 holds 48 launches of each of kernels 2, 3 and 4 a
             step by their names on the card, and none of kernel 1; the
             tfevents file's records carry valid masked CRC-32Cs and its
             (tag, step) pairs equal the CSV's epoch rows (read by a
             TFRecord reader of this script); host ms of a traced and an
             untraced step. doctor exits 0 and names the card and the ten
             kernels as built. demo from the checkpoint just written on a
             PNG of the set (12 launches of kernel 1); the fp32 mask
             (TF32 off) of predict_image on the card against the CPU's,
             flips only on logit ties, detections equal where the masks
             are; the bf16 forward's device ms. eval-sweep --visualize, one
             config, two batches: 2 x 12 launches of kernel 1 and the 8
             panel PNGs. Without matplotlib, predict_image and
             evaluate_model run without drawing, and the line says so.
17. parallel  ViT-B/16 (17 classes, full width and depth, 224^2, the CE
             defaults: batch 16 = 4 x 4) on a 2-rank job (parallel/
             launch.py): the two ranks share the one card over gloo (NCCL,
             a card each, where there are two), and one rank group runs
             every mode in turn: dp (mesh 2), tp (mesh 1,2: 6 heads a
             rank), FSDP (mesh 2, FSDP2), sequence parallelism (mesh 1,2:
             99/98 tokens) and the pipeline (2 stages of 6 layers, 2
             pipeline microbatches). Each mode's fp32 step (TF32 off,
             dropout off) against the single-rank step on the card: loss
             1e-5, every gathered gradient 5e-5 / 5e-4 (and
             step_grads_agree); dp's and FSDP's updated parameters at the
             JAX multihost test's tolerance (rtol 2e-5, atol 2e-6). Each
             mode's bf16 step with dropout 0.1: finite loss, 48 launches of
             each of kernels 2, 3 and 4 a rank (a pipeline stage: 6 layers
             x 4 micro-batches x 2 pipeline microbatches), images/s, the
             device-busy share, the backend and transport (the shared card
             stages point-to-point sends through host memory:
             "gloo-host"). FSDP's (gathered) and the pipeline's (stacked)
             checkpoints restored on one rank: the plain model's fp32
             logits against the trainer's sharded forward. ModelRunner
             over a dp = 2 serving mesh (both replicas on the card) at
             batch 32: its predict at the row's 224^2 and the bench
             workload (512^2 -> 224^2 -> 512^2, phase 4's front end) on
             each replica's rows: fp32 masks equal the single replica's
             but on logit ties, bf16 agreement recorded, 8 jobs over HTTP.
             train --multihost as two OS processes at
             --coordinator 127.0.0.1:<port>: both exit 0, only process 0
             writes metrics.csv.

Then it prints the card's name and power limit as nvidia-smi gives them,
one JSON line describing every kernel (launches of the serving kernels
counted during the serving run, of the training kernels during the train
run, of the sweep kernels during the two sweeps; kernels 1-5 also with
their launches on the paths of phases 10, 11, 12 and 13; kernels 1-9 with
their launches in phases 14 and 15, which must be 0, in phase 16, and
in phase 17, summed over its ranks and its serving mesh), and, last,
{"ok": true, "device": {...}}.
Without CUDA it exits with code 1 and prints no result.

Times: "ms" and "library_ms" are device time (device_ms: CUDA events
around calls queued behind a spin kernel, so back to back on the device
without the host's pace); "call_ms" and "plain_ms" are CUDA events around
calls issued back to back (time_ms), the host's pace included where it
sets it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import os
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from visiontransformer_tpu_torch.utils import spans

# Published H100 rates (NVIDIA data sheets, dense): memory bytes/s, and
# operations/s for bf16 tensor-core math and for fp32 outside the tensor
# cores. SXM unless nvidia-smi names the PCIe card.
_PEAKS = {
    "sxm": {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12},
    "pcie": {"bytes": 2.0e12, "bf16": 756e12, "fp32": 51e12},
}

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# Flash, (atol, rtol). fp32 as the JAX package's flash tests. bf16 scales
# with each case's outputs, which shrink as N grows (randn inputs): atol is
# one bf16 ulp of the largest plain output (2^-7 * max|want|), rtol half an
# ulp; besides, the error's norm must stay within 2^-8 of the output's, so a
# small error shared by every output (a mis-masked key tail) cannot hide
# under the elementwise bound.
FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}
FLASH_BF16_REL_NORM = 2.0 ** -8
# Training kernels. Forward output: FLASH_TOL (it rounds P as the
# inference kernel does). lse (fp32 in both dtypes): atol 3.8e-6, twice the
# largest error measured on the card (1.9e-6 at N = 3137). Gradients, fp32:
# the JAX package's gradient tolerance (tests/test_flash_attention.py:47-48).
# Gradients, bf16: atol 2^-8 * max|want| + rtol 2^-8 (admits a one-ulp
# difference in the final rounding anywhere; the largest error measured was
# 0.47-0.69 of it), and the error's norm within 4.4e-4 of the plain
# gradient's, twice the largest measured (2.2e-4 at N = 3137): it refuses a
# tail of rows past N read as data instead of masked
# (tests/test_torch_flash_train.py).
# delta = rowsum(dO * O) from the dQ kernel's prologue against PyTorch's: both
# sum 64 to 128 fp32 products of the same bf16 values, in another order;
# atol and rtol are four times the largest differences measured on an H100
# (9.5e-7 absolute at |delta| up to 30).
# N = 1: softmax over one key is 1, so without dropout dQ and dK are zero by
# construction and kernel and plain version both return rounding noise
# around zero, which a gate relative to max|plain| cannot hold; where that
# case misses GRAD_TOL it must hold |dQ|, |dK| <= ZERO_GRAD_ATOL in both
# (fp32 noise of dP - delta, 64 terms of size O(1)).
# The bf16 dropout train step: per-parameter gradients through the kernels
# against the plain versions, GRAD_TOL's elementwise form; the error norm,
# accumulated over 12 layers of one-ulp bf16 differences, within
# STEP_GRAD_REL_NORM, twice the largest measured on an H100 (1.45e-2, the
# position embedding's gradient; backward kernels that drew the forward's
# mask one column off are refused on a small model:
# tests/test_torch_flash_bwd.py); the loss within STEP_LOSS_RTOL (measured
# 1.2e-6).
LSE_ATOL = 3.8e-6
DELTA_TOL = (4e-6, 1e-6)
ZERO_GRAD_ATOL = 1e-5
STEP_GRAD_REL_NORM = 3e-2
STEP_LOSS_RTOL = 2e-3
GRAD_TOL = {torch.float32: (5e-5, 5e-4), torch.bfloat16: (2.0 ** -8, 2.0 ** -8)}
GRAD_BF16_REL_NORM = 4.4e-4
# Tuning-sweep kernels 6-9 (bf16): FLASH_TOL and its norm gate, as kernel 1,
# except kernel 6's bf16exp mode, which is held twice, as flash_agrees'
# (atol scale, rtol, error norm). The kernel takes exp in bf16 as the bf16
# ex2 of x·log2 e rounded to bf16, where its plain version's torch exp (the
# TPU kernel's bf16 jnp.exp) computes in fp32 and rounds once. Against that
# plain version, BF16EXP_TOL: twice the largest errors measured on an H100
# over the three VARIANT_SHAPES and key tiles 32/64/128, 0.0105·max|plain|
# (N = 1025) and a norm of 0.0055 (N = 3137). The product's rounding moves
# p as much as the mode's own rounding does, so an output with exp in fp32
# passes that gate too. Against bf16exp_card_plain, which rounds as the
# kernel does, BF16EXP_CARD_TOL: FLASH_TOL, and an error norm of twice the
# largest measured on an H100 over the same cases, 2.09e-4 (N = 3137); an
# output with exp in fp32, or with torch's bf16 exp, lies more than five
# times that gate away (tests/test_torch_flash_variants.py).
BF16EXP_TOL = (0.021, 0.0, 0.011)
BF16EXP_CARD_TOL = (2.0 ** -7, 2.0 ** -8, 4.2e-4)
LOSS_RTOL = 1e-5            # fp32 train step, kernels vs eager attention
LOGITS_TOL = (5e-5, 1e-4)   # fp32 seg logits, atol / rtol
# The kernel and the plain epilogue differ only by FMA contraction (a few
# fp32 ulps), so a flip between them must sit on a logit gap below this.
UPSAMPLE_TIE_TOL = 1e-5
MIN_AGREEMENT = 0.9999


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of fn() per call over iters calls back to back (CUDA events;
    the host's launch overhead included where it sets the pace). The plain
    versions are timed so: they launch more kernels than the device's
    queue holds, so device_ms cannot queue them ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SPIN_MS_PER_MCYCLE = []  # device ms of torch.cuda._sleep(10**6), measured once


def device_ms(fn, iters: int = 10) -> float:
    """Device time of fn() per call, without the host's launch overhead
    between calls, which sets the pace of back-to-back calls of a small
    kernel: CUDA events around iters calls that the host queued while a
    spin kernel held the device, so the calls ran back to back (the
    device's own gaps between kernels are in it). The reading checks
    itself: the event before the calls must not have fired when the last
    call is queued, else the host set the pace and the reading is taken
    again behind a longer spin."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not _SPIN_MS_PER_MCYCLE:
        torch.cuda._sleep(10 ** 6)  # the first spin also loads its kernel
        start.record()
        torch.cuda._sleep(10 ** 6)
        end.record()
        end.synchronize()
        _SPIN_MS_PER_MCYCLE.append(start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2 * queue_ms + 1.0
    for _ in range(3):
        torch.cuda._sleep(int(spin_ms / _SPIN_MS_PER_MCYCLE[0] * 10 ** 6))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_ms *= 4
    raise RuntimeError("device_ms: the host could not queue the calls "
                       "ahead of the device in 3 tries")


def bound_ms(peaks, n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / peaks["bytes"] * 1e3
    t_ops = n_ops / peaks[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= atol + rtol * b.abs()).all())
    return ok, float(err.max())


def flash_agrees(got: torch.Tensor, want: torch.Tensor, tol=None):
    """(ok, fields) of the flash kernel's output against its plain version
    on the same inputs, at FLASH_TOL for want's dtype (bf16: scaled to
    want, plus the error-norm gate). ``tol`` = (atol, rtol, error norm)
    replaces FLASH_TOL and FLASH_BF16_REL_NORM, read as they are."""
    bf16 = want.dtype == torch.bfloat16
    if tol is None:
        tol = (*FLASH_TOL[want.dtype], FLASH_BF16_REL_NORM)
    atol, rtol, max_norm = tol
    got, want = got.float(), want.float()
    rel_norm = float((got - want).norm() / want.norm())
    if bf16:
        atol *= float(want.abs().max())
    ok, err = close(got, want, atol, rtol)
    if bf16:
        ok = ok and rel_norm <= max_norm
    return ok, {"max_abs_err": err, "atol": atol, "rtol": rtol,
                "rel_err_norm": rel_norm}


def grad_agrees(got: torch.Tensor, want: torch.Tensor):
    """(ok, fields) of a backward kernel's gradient against its plain
    version, at GRAD_TOL for want's dtype (bf16: atol scaled to max|want|,
    plus the error-norm gate)."""
    atol, rtol = GRAD_TOL[want.dtype]
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    rel_norm = float((got - want).norm() / want.norm())
    if bf16:
        atol *= float(want.abs().max())
    ok, err = close(got, want, atol, rtol)
    if bf16:
        ok = ok and rel_norm <= GRAD_BF16_REL_NORM
    return ok, {"max_abs_err": err, "atol": atol, "rtol": rtol,
                "rel_err_norm": rel_norm}


def ties_explained(plain_logits, got, want, tol):
    """(flips, largest logit gap at a flip): at each pixel where the
    kernel's class differs from the plain one, the plain logits of the two
    classes must tie within tol."""
    flips = got != want
    n = int(flips.sum())
    if n == 0:
        return 0, 0.0
    logits = plain_logits[flips]
    gap = (logits.gather(-1, want[flips].long()[:, None])
           - logits.gather(-1, got[flips].long()[:, None]))
    worst = float(gap.abs().max())
    if worst > tol:
        raise AssertionError(f"{n} argmax flips, largest logit gap {worst:.3g} "
                             f"> tie tolerance {tol}")
    return n, worst


# --------------------------------------------------------------------- phases
def phase_env():
    from visiontransformer_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    out_dir = _build.build()
    ptxas = []
    for log in sorted(out_dir.glob("*.log")):
        ptxas += [line.strip() for line in log.read_text().splitlines()
                  if "registers" in line or "spill" in line
                  or "Compiling entry" in line or "arning" in line]
    print("\n".join(ptxas), file=sys.stderr)
    peaks = _PEAKS["pcie" if "PCIe" in smi else "sxm"]
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=_build.last_build_seconds, build_dir=str(out_dir),
         peaks=peaks)
    return smi, peaks


# (B, H, N, d) of the flash checks: the main shapes, then the edges of the
# forward kernels' 64-row and 64-key tiles at d = 64 ("wgmma") and at
# d = 32 and 128 ("stream", two chains a warp and one), at 48 heads.
FLASH_CASES = [(32, 12, 197, 64), (4, 12, 785, 64), (16, 12, 1025, 64),
               (2, 12, 3137, 64), (8, 16, 257, 80), (2, 4, 130, 16),
               (2, 4, 130, 32), (2, 4, 130, 128)]
FLASH_TIMED = ((384, 197), (192, 1025), (24, 3137))  # (B*H, N), d = 64


def phase_flash(peaks, gen):
    """Kernel 1 vs its plain version on every instantiation; returns the
    serving shape's bf16 row and the timed rows by (B*H, N)."""
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        forward_path,
    )

    cases = FLASH_CASES + [(4, 12, n, d) for d in (64, 32, 128)
                           for n in TRAIN_EDGE_NS]
    main_row, timed = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, n, d in cases:
            # Strided views of one fused QKV tensor, as the model passes.
            qkv = torch.randn(b, n, 3, h, d, generator=gen, device="cuda")
            qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            got = flash_attention(q, k, v)
            want = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            ok, fields = flash_agrees(got, want)
            row = {"shape": [b, h, n, d], "dtype": str(dtype)[6:],
                   "path": forward_path(n, d, dtype), **fields}
            if d == 64 and (b * h, n) in FLASH_TIMED:
                if dtype == torch.bfloat16:
                    row["timing"] = _time_forward(peaks, q, k, v, gen)
                    row.update({key: row["timing"][key] for key in (
                        "ms", "call_ms", "plain_ms", "library_ms",
                        "library_call_ms", "bound_ms", "bound_by")})
                    timed[(b * h, n)] = row
                elif n in (197, 3137):
                    row["ms"] = device_ms(lambda: flash_attention(q, k, v))
                    row["plain_ms"] = time_ms(
                        lambda: flash_attention_plain(q, k, v), 3, 1)
                    row["library_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v))
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        peaks, 4 * b * h * n * d * 4, 4 * b * h * n * n * d,
                        "fp32")
            # The timing goes out on the flash_forward lines.
            emit("flash", **{k: x for k, x in row.items() if k != "timing"})
            if not ok:
                raise AssertionError(f"flash kernel disagrees: {row}")
            if (b, h, n, d) == (32, 12, 197, 64) and dtype == torch.bfloat16:
                main_row = row
    return main_row, timed


# (B, H, Nq, Nk, d) of the checks at Nk != Nq: SegFormer-B5's stages at
# 1024^2 (Nk = 1,024 keys after the r x r reduction), then partial last
# key tiles (49: stage 1 at 224^2; 400: stage 1 at 640^2) on the "wgmma"
# and "stream" instantiations.
FLASH_KEY_CASES = [(2, 1, 65536, 1024, 64), (2, 2, 16384, 1024, 64),
                   (2, 5, 4096, 1024, 64), (2, 8, 1024, 1024, 64),
                   (2, 1, 3136, 49, 64), (2, 1, 25600, 400, 64),
                   (2, 1, 3136, 49, 32), (2, 2, 784, 49, 32)]
FLASH_KEY_TIMED_BATCH = 8  # the serving cell's bucket


def phase_flash_keys(peaks, gen):
    """Phase 2a: kernel 1 at Nk != Nq (module docstring). Returns the
    timed rows."""
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        forward_block_rows,
        forward_path,
    )

    def launch_fields(b, h, nq, d, dtype):
        path = forward_path(nq, d, dtype)
        rows = forward_block_rows(b * h, nq) if path == "wgmma" else None
        return {"path": path, "block_rows": rows}

    failed, timed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, nq, nk, d in FLASH_KEY_CASES:
            # q and k, v from separate projections, (B, N, H·d) viewed as
            # heads, as MiT passes them.
            q = torch.randn(b, nq, h, d, generator=gen, device="cuda")
            kv = torch.randn(b, nk, 2, h, d, generator=gen, device="cuda")
            q = q.to(dtype).transpose(1, 2)
            kv = kv.to(dtype).permute(2, 0, 3, 1, 4)
            k, v = kv[0], kv[1]
            got = flash_attention(q, k, v)
            want = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            ok, fields = flash_agrees(got, want)
            emit("flash_keys", shape=[b, h, nq, nk, d], dtype=str(dtype)[6:],
                 **launch_fields(b, h, nq, d, dtype), **fields)
            if not ok:
                failed.append([b, h, nq, nk, d, str(dtype)])
            del q, kv, k, v, got, want
    # The stage shapes at the serving cell's bucket, checked as well as
    # timed: at batch 8 the fill rule may take another block size than at
    # batch 2.
    b = FLASH_KEY_TIMED_BATCH
    for _, h, nq, nk, d in FLASH_KEY_CASES[:4]:
        q = torch.randn(b, h, nq, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, h, nk, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        ok, fields = flash_agrees(flash_attention(q, k, v),
                                  flash_attention_plain(q, k, v))
        torch.cuda.empty_cache()
        if not ok:
            failed.append([b, h, nq, nk, d, "bfloat16"])
        row = {"shape": [b * h, nq, nk, d],
               **launch_fields(b, h, nq, d, q.dtype), "agrees": ok,
               "max_abs_err": fields["max_abs_err"],
               "ms": device_ms(lambda: flash_attention(q, k, v)),
               "library_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v))}
        row["bound_ms"], row["bound_by"] = bound_ms(
            peaks, 2 * b * h * (nq + nk) * d * 2, 4 * b * h * nq * nk * d,
            "bf16")
        row["ratio"] = row["ms"] / row["library_ms"]
        row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
        emit("flash_keys_timed", **row)
        timed.append(row)
        del q, k, v
    if failed:
        raise AssertionError(f"kernel 1 at Nk != Nq disagrees: {failed}")
    # One bf16 mit_b5 forward as ModelRunner runs it: every block's
    # attention through kernel 1, none eager.
    _, model = resolve_model("segformer", "mit_b5", num_classes=19,
                             input_size=512, device="cuda")
    x = torch.rand(2, 512, 512, 3, generator=gen, device="cuda")
    spans.reset()
    with torch.inference_mode():
        model(x).argmax(-1)
    torch.cuda.synchronize()
    counts = {k: spans.counters().get(k, 0) for k in (
        "mit.attention_flash", "mit.attention_eager", "flash_attention")}
    emit("flash_keys_mit_b5", **counts)
    if counts != {"mit.attention_flash": 52, "mit.attention_eager": 0,
                  "flash_attention": 52}:
        raise AssertionError(f"mit_b5's attention did not run on kernel 1 "
                             f"once a block: {counts}")
    del model
    torch.cuda.empty_cache()
    return timed


# (B*H, kh, kw, d, timed) of the bias checks: SAM-H at the serving bucket
# of 8 (16 heads; 25 windows an image), SAM-B (12 heads) and SAM-L (16
# heads) at the same bucket, then partial row and key tiles.
FLASH_BIAS_CASES = [(3200, 14, 14, 80, True), (128, 64, 64, 80, True),
                    (2400, 14, 14, 64, True), (96, 64, 64, 64, True),
                    (3200, 14, 14, 64, True), (128, 64, 64, 64, True),
                    (4, 3, 6, 80, False), (4, 13, 10, 80, False),
                    (4, 17, 8, 80, False), (4, 3, 6, 64, False),
                    (4, 13, 10, 64, False), (4, 17, 8, 64, False)]


def _ptxas_lines(kernel_part: str) -> list:
    """ptxas's register, shared-memory and spill lines for the kernels of
    kernel 1's build whose mangled name holds ``kernel_part``."""
    from visiontransformer_tpu_torch.ops import _build

    log = (_build.build_dir() / "flash_attention_fwd.log").read_text()
    out, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line
        elif current and kernel_part in current and (
                "registers" in line or "spill" in line):
            out.append(f"{current}: {line.split('info    :')[-1].strip()}")
    return out


def phase_flash_bias(peaks, gen):
    """Phase 2c: kernel 1 with SAM's decomposed bias (module docstring).
    Returns the timed rows."""
    from visiontransformer_tpu_torch.models import sam
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention_bias,
        flash_attention_bias_plain,
        forward_path,
    )
    from visiontransformer_tpu_torch.ops.upsample_argmax import (
        upsample_argmax,
        upsample_argmax_tap_plain,
    )

    failed, timed = [], []
    for bh, kh, kw, d, is_timed in FLASH_BIAS_CASES:
        n = kh * kw
        heads = 16 if bh % 16 == 0 else 12 if bh % 12 == 0 else 2
        b = bh // heads
        qkv = torch.randn(b, n, 3, heads, d, generator=gen, device="cuda",
                          dtype=torch.bfloat16).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        rel_h = torch.randn(b, heads, n, kh, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        rel_w = torch.randn(b, heads, n, kw, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        got = flash_attention_bias(q, k, v, rel_h, rel_w)
        want = flash_attention_bias_plain(q, k, v, rel_h, rel_w)
        torch.cuda.synchronize()
        ok, fields = flash_agrees(got, want)
        row = {"shape": [bh, n, d], "grid": [kh, kw],
               "path": forward_path(n, d, torch.bfloat16), "agrees": ok,
               **fields}
        del got, want
        if not ok:
            failed.append(row)
        if is_timed and ok:
            # SDPA's yardstick: the same logits with the bias materialised
            # as an additive (B, H, N, N) mask, built outside the timing.
            mask = (rel_h.unsqueeze(-1) + rel_w.unsqueeze(-2)).reshape(
                b, heads, n, n)
            row["ms"] = device_ms(
                lambda: flash_attention_bias(q, k, v, rel_h, rel_w))
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask))
            row["bound_ms"], row["bound_by"] = bound_ms(
                peaks, bh * (4 * n * d + n * (kh + kw)) * 2,
                4 * bh * n * n * d, "bf16")
            row["ratio"] = row["ms"] / row["library_ms"]
            row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
            timed.append(row)
            del mask
        emit("flash_bias", **row)
        del qkv, q, k, v, rel_h, rel_w
        torch.cuda.empty_cache()
    for line in _ptxas_lines("bias"):
        emit("flash_bias_ptxas", line=line)
    if failed:
        raise AssertionError(f"kernel 1 with the bias disagrees: {failed}")
    # One SAM-H forward as the runner serves it, seeded weights made on the
    # card: every block's attention core through the bias instantiation.
    cfg = sam.sam_config("sam_vit_h", input_size=1024)
    with torch.device("cuda"):
        model = sam.SamSeg(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        for layer in model.vision_encoder.layers:
            for table in (layer.attn.rel_pos_h, layer.attn.rel_pos_w):
                table.normal_(0.0, cfg.head_dim ** -0.5, generator=gen)
    forward = sam.SamMasks(model.eval(), torch.uint8)
    images = torch.rand(8, 1024, 1024, 3, generator=gen, device="cuda")
    boxes = torch.tensor([[100.0, 200.0, 700.0, 900.0]],
                         device="cuda").expand(8, 4)
    spans.reset()
    with torch.inference_mode():
        masks = forward(images, boxes)
    torch.cuda.synchronize()
    counts = {k: spans.counters().get(k, 0) for k in (
        "flash_attention_bias", "sam.attention_flash", "sam.attention_eager",
        "flash_attention", "layer_norm_plain", "linear_plain",
        "upsample_argmax")}
    with torch.inference_mode():
        ms = time_ms(lambda: forward(images, boxes), iters=3, warmup=1)
        # The masks step on the forward's logits: kernel 5 on (0, m) bit
        # for bit against its tap-order plain version, and against the
        # plain step (resize in fp32, then > 0), which it may differ from
        # only where the resized logit is within rounding of 0.
        logits = sam.sam_mask_logits(model, images, boxes)
        two = torch.stack([torch.zeros_like(logits), logits], dim=-1)
        kernel = upsample_argmax(two, (1024, 1024), out_dtype=torch.uint8)
        tap = upsample_argmax_tap_plain(two, (1024, 1024), torch.uint8)
        up = sam.upscale_logits(logits, (1024, 1024))
    flips = kernel != (up > 0).to(torch.uint8)
    flip_max = float(up.abs()[flips].max()) if bool(flips.any()) else 0.0
    epilogue = {"kernel_equals_tap_plain": torch.equal(kernel, tap),
                "forward_equals_kernel": torch.equal(masks, kernel),
                "plain_step_flips": int(flips.sum()),
                "flip_logit_max": flip_max,
                "logit_abs_max": float(up.abs().max())}
    emit("flash_bias_sam_h", batch=8, **counts, forward_ms=ms,
         mask_share=float(masks.float().mean()), **epilogue)
    if (counts["flash_attention_bias"], counts["sam.attention_flash"],
            counts["sam.attention_eager"], counts["upsample_argmax"]) != (
                32, 32, 0, 1):
        raise AssertionError(f"SAM-H's attention did not run on kernel 1's "
                             f"bias instantiation once a block, or its "
                             f"masks not on kernel 5 once: {counts}")
    if not epilogue["kernel_equals_tap_plain"] or (
            flip_max > 1e-3 * epilogue["logit_abs_max"]):
        raise AssertionError(f"SAM-H's masks step on kernel 5 disagrees "
                             f"with the plain step: {epilogue}")
    del model, forward, images, logits, two, kernel, tap, up, flips
    torch.cuda.empty_cache()
    return timed


def _time_forward(peaks, q, k, v, gen):
    """Kernels 1 and 2 (dropout 0 and 0.1) on these bf16 inputs beside SDPA
    at the same rates, by device time (``device_ms``): ms, library_ms
    (SDPA), bounds and ratios of kernel 1; call_ms, library_call_ms and
    plain_ms are CUDA-event times of back-to-back calls (host overhead
    included); train_ms, sdpa_ms, train_bound_ms and
    train_ratio by rate for kernel 2."""
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_attention_train,
        forward_path,
    )

    b, h, n, d = q.shape
    bh, elt = b * h, q.element_size()
    seed = torch.randint(0, 2 ** 31, (), generator=gen, device="cuda")
    kernel = lambda: flash_attention(q, k, v)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
    row = {"shape": [bh, n, d], "path": forward_path(n, d, q.dtype),
           "ms": device_ms(kernel), "call_ms": time_ms(kernel),
           "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), 3, 1),
           "library_ms": device_ms(sdpa), "library_call_ms": time_ms(sdpa)}
    row["bound_ms"], row["bound_by"] = bound_ms(
        peaks, 4 * bh * n * d * elt, 4 * bh * n * n * d, "bf16")
    row["ratio"] = row["ms"] / row["library_ms"]
    train_bound = bound_ms(peaks, 4 * bh * n * d * elt + 4 * bh * n,
                           4 * bh * n * n * d, "bf16")[0]
    row.update(train_ms={}, sdpa_ms={}, train_bound_ms=train_bound,
               train_ratio={})
    for rate in (0.0, 0.1):
        row["train_ms"][rate] = device_ms(
            lambda: flash_attention_train(q, k, v, rate, seed))
        with torch.no_grad():
            row["sdpa_ms"][rate] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       dropout_p=rate))
        row["train_ratio"][rate] = row["train_ms"][rate] / row["sdpa_ms"][rate]
    return row


# The sweep kernels by TPU kernel: (source, line replaced, the configuration
# timed and listed on the kernels line).
VARIANT_KERNELS = {
    "flash_variant": ("flash_variants.cu", "scripts/tune_flash2.py:41",
                      "base/64"),
    "flash_multiq": ("flash_chains.cu", "scripts/tune_flash3.py:51",
                     "dualq/64"),
    "flash_pvt": ("flash_chains.cu", "scripts/tune_flash3.py:94", "pvT/64"),
    "flash_dualq_pvt": ("flash_chains.cu", "scripts/tune_flash3.py:132",
                        "dualq_pvT/64"),
}
# (B, H, N): the sweeps' shape (BH = 192, N = 1025), the serving shape
# (384, 197) and (24, 3137); the first two are timed.
VARIANT_SHAPES = ((16, 12, 1025), (32, 12, 197), (2, 12, 3137))
# (B, H, N) of the edges, checked only: one key and one live row; a second
# 64-row chain with one live row beside a warpgroup with none; a 256-query
# block with one live row (and kernel 6's peeled tiles, first and last).
VARIANT_EDGE_SHAPES = ((1, 2, 1), (1, 2, 65), (1, 2, 257))


def _variant_cases():
    """(kernel, "config", kernel call, checks, design) for every
    instantiation of kernels 6-9; checks are (label, plain call,
    flash_agrees tol), the first against the kernel's own plain version,
    each at its block_k; design is variant_path's or chains_path's name."""
    from functools import partial

    from visiontransformer_tpu_torch.ops import flash_variants as fv

    cases = []
    for mode in fv.MODES:
        for bk in fv.VARIANT_BLOCK_KS:
            config = f"{mode}/{bk}"
            checks = [(config, partial(fv.variant_plain, mode=mode, block_k=bk),
                       BF16EXP_TOL if mode == "bf16exp" else None)]
            if mode == "bf16exp":
                checks.append((f"{config} card", partial(
                    fv.bf16exp_card_plain, block_k=bk), BF16EXP_CARD_TOL))
            cases.append(("flash_variant", config, partial(
                fv.flash_variant, mode=mode, block_k=bk), checks,
                fv.variant_path(mode, bk)))
    for bk in fv.CHAIN_BLOCK_KS:
        for name, config, kernel, plain, chains, transposed in (
                ("flash_multiq", "dualq", partial(fv.flash_multiq, chains=2),
                 fv.multiq_plain, 2, False),
                ("flash_multiq", "quadq", partial(fv.flash_multiq, chains=4),
                 fv.multiq_plain, 4, False),
                ("flash_pvt", "pvT", fv.flash_pvt, fv.pvt_plain, 1, True),
                ("flash_dualq_pvt", "dualq_pvT", fv.flash_dualq_pvt,
                 fv.dualq_pvt_plain, 2, True)):
            config = f"{config}/{bk}"
            cases.append((name, config, partial(kernel, block_k=bk),
                          [(config, partial(plain, block_k=bk), None)],
                          fv.chains_path(chains, transposed, bk)))
    return cases


# The sweep names of kernels 7-9 by (chains, transposed).
CHAIN_NAMES = {(2, False): "dualq", (4, False): "quadq", (1, True): "pvT",
               (2, True): "dualq_pvT"}


def _variant_resources():
    """Registers a thread, blocks an SM, threads, shared memory and spilled
    bytes of every instantiation of kernels 6-9, as the card's runtime
    reports them."""
    from visiontransformer_tpu_torch.ops import flash_variants as fv

    out = {f"{mode}/{bk}": fv.variant_info(mode, bk)
           for mode in fv.MODES for bk in fv.VARIANT_BLOCK_KS}
    out.update({f"{CHAIN_NAMES[schedule]}/{bk}": fv.chains_info(*schedule, bk)
                for schedule in fv.CHAIN_SCHEDULES
                for bk in fv.CHAIN_BLOCK_KS})
    return out


def _check_variants(cases, q, k, v, checks, failed):
    """Every case of ``cases`` on q, k, v against its plain versions,
    into ``checks`` by label; failed labels appended to ``failed``."""
    for _, _, kernel, kernel_checks, _ in cases:
        got = kernel(q, k, v)
        for label, plain, tol in kernel_checks:
            want = plain(q, k, v)
            torch.cuda.synchronize()
            ok, checks[label] = flash_agrees(got, want, tol)
            if not ok:
                failed.append(label)


def phase_flash_variants(peaks, gen):
    """Kernels 6-9: both tuning sweeps at their defaults (the path that
    launches them and kernel 1, counted), then every instantiation and
    kernel 1 against its plain version at VARIANT_SHAPES, every
    instantiation timed at the first two, each line naming its design;
    then every instantiation at VARIANT_EDGE_SHAPES, checked only.
    Returns the kernels-line entries."""
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from visiontransformer_tpu_torch.scripts import tune_flash2, tune_flash3

    spans.reset()
    t0 = time.perf_counter()
    tune_flash2.main([])
    tune_flash3.main([])
    sweep_s = time.perf_counter() - t0
    launches = {name: _launches(name) for name in VARIANT_KERNELS}
    emit("flash_variants_sweeps", seconds=sweep_s, launches=launches,
         flash_attention_launches=_launches("flash_attention"))
    launches_all = {**launches, "flash_attention": _launches("flash_attention")}
    if not all(launches_all.values()):
        raise AssertionError(f"sweeps missed a kernel: {launches_all}")

    cases = _variant_cases()
    resources = _variant_resources()
    emit("flash_variants_resources", **resources)
    entries = {}
    for b, h, n in VARIANT_SHAPES:
        qkv = torch.randn(b, n, 3, h, 64, generator=gen, device="cuda")
        qkv = qkv.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        checks, failed = {}, []
        # Kernel 1, the sweeps' production kernel, at the same shape.
        production = ("flash_attention", "flash_attention", flash_attention,
                      [("flash_attention", flash_attention_plain, None)],
                      "wgmma")
        _check_variants([production, *cases], q, k, v, checks, failed)
        row = {"shape": [b * h, n, 64], "checks": checks}
        if n in (1025, 197):
            row["timing"] = _time_variants(peaks, q, k, v, cases)
            row["timing"]["flash_attention_ms"] = device_ms(
                lambda: flash_attention(q, k, v))
        emit("flash_variants", **row)
        if failed:
            raise AssertionError(f"sweep kernels {failed} disagree at "
                                 f"{row['shape']}: {checks}")
        if n == 1025:
            entries = {name: {**row["timing"][config],
                              "max_abs_err": checks[config]["max_abs_err"],
                              "resources": resources.get(config)}
                       for name, (_, _, config) in VARIANT_KERNELS.items()}
        elif n == 197:
            for name, (_, _, config) in VARIANT_KERNELS.items():
                entries[name]["serving_shape"] = row["timing"][config]
    for b, h, n in VARIANT_EDGE_SHAPES:
        qkv = torch.randn(b, n, 3, h, 64, generator=gen, device="cuda")
        q, k, v = qkv.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
        checks, failed = {}, []
        _check_variants(cases, q, k, v, checks, failed)
        worst = max(checks.values(), key=lambda f: f["max_abs_err"])
        emit("flash_variants_edge", shape=[b * h, n, 64], cases=len(checks),
             failed=failed, worst_max_abs_err=worst["max_abs_err"])
        if failed:
            raise AssertionError(f"sweep kernels {failed} disagree at "
                                 f"{[b * h, n, 64]}: {checks}")
    src = "visiontransformer_tpu_torch/csrc/"
    return [{"name": name, "route": "cuda", "source": src + source,
             "replaces": replaces, "launches": launches[name],
             **{k: entries[name][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             "config": config, "design": entries[name]["design"],
             "resources": entries[name]["resources"],
             "shape": [192, 1025, 64], "dtype": "bfloat16",
             "call_ms": entries[name]["call_ms"],
             "serving_shape": entries[name]["serving_shape"]}
            for name, (source, replaces, config) in VARIANT_KERNELS.items()]


def _time_variants(peaks, q, k, v, cases):
    """Device time (``device_ms``) of every instantiation of kernels 6-9
    and of SDPA on the same inputs, with the bound and each case's design;
    call_ms and plain_ms (CUDA events, back to back) of the listed
    configurations."""
    b, h, n, d = q.shape
    bound = bound_ms(peaks, 4 * b * h * n * d * q.element_size(),
                     4 * b * h * n * n * d, "bf16")
    library = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    listed = {config for _, _, config in VARIANT_KERNELS.values()}
    timing = {}
    for name, config, kernel, checks, design in cases:
        fn = lambda: kernel(q, k, v)
        timing[config] = {"design": design, "ms": device_ms(fn),
                          "library_ms": library, "bound_ms": bound[0],
                          "bound_by": bound[1]}
        timing[config]["ratio"] = timing[config]["ms"] / library
        if config in listed:
            plain = checks[0][1]  # the kernel's own plain version
            timing[config].update(
                call_ms=time_ms(fn),
                plain_ms=time_ms(lambda: plain(q, k, v), 3, 1))
    return timing


# ((B, h, w, C), (H, W)) of the epilogue checks: the timed shapes below,
# then the edges of the kernel's instantiations (epilogue_path): unaligned
# and narrow widths (scalar stores, a row's tail), downsampling (100 -> 37),
# class counts 1, 3, 40 (chunks of 8), ragged row tiles of 8 and 4 rows,
# and an H-stage row above the default 48 KB of shared memory (700 x 40).
# Every case runs fp32 and bf16 logits into int32 and uint8 masks.
UPSAMPLE_CASES = [
    ((1, 5, 7, 17), (4, 1)), ((1, 5, 7, 17), (4, 3)), ((1, 5, 7, 17), (4, 17)),
    ((1, 5, 7, 17), (4, 33)), ((1, 5, 7, 17), (4, 513)),
    ((2, 100, 100, 17), (37, 37)), ((3, 14, 14, 17), (33, 40)),
    ((8, 16, 16, 17), (250, 256)),
    ((2, 9, 11, 1), (19, 32)), ((2, 9, 11, 3), (19, 37)),
    ((2, 9, 11, 40), (19, 48)), ((4, 6, 700, 40), (9, 64)),
    ((32, 56, 56, 17), (100, 512)), ((32, 14, 14, 40), (512, 512)),
]
# (grid, output side) of the timed shapes, B = 32, C = 17: P16, P8,
# native-512^2 P16 and P4 grids to 512^2, and P16 to 224^2.
UPSAMPLE_TIMED = ((14, 512), (28, 512), (32, 512), (56, 512), (14, 224))


def _upsample_agrees(x, size, out_dtype):
    """Kernel 5 on x against the tap-form plain version (bit for bit) and
    the matrix-form one (agreement, flips only on ties)."""
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
    from visiontransformer_tpu_torch.ops.upsample_argmax import (
        upsample_argmax,
        upsample_argmax_plain,
        upsample_argmax_tap_plain,
    )

    got = upsample_argmax(x, size, out_dtype=out_dtype)
    torch.cuda.synchronize()
    if got.dtype != out_dtype or not torch.equal(
            got, upsample_argmax_tap_plain(x, size, out_dtype)):
        raise AssertionError(f"upsample_argmax {tuple(x.shape)} {x.dtype} -> "
                             f"{size} {out_dtype}: not equal to the tap-form "
                             f"plain version")
    want = upsample_argmax_plain(x, size, out_dtype)
    flips, worst = ties_explained(resize_bilinear_mm(x, size), got, want,
                                  UPSAMPLE_TIE_TOL)
    agreement = 1.0 - flips / got.numel()
    if agreement < MIN_AGREEMENT:
        raise AssertionError(f"upsample_argmax {tuple(x.shape)} -> {size}: "
                             f"agreement {agreement}")
    return {"flips": flips, "agreement": agreement, "max_abs_err": worst}


def phase_upsample(peaks, gen):
    """Kernel 5: every instantiation against both plain versions, the tie
    case, then device time at the timed shapes for both output types."""
    from visiontransformer_tpu_torch.ops.upsample_argmax import (
        epilogue_path,
        upsample_argmax,
        upsample_argmax_plain,
    )

    out_dtypes = {"int32": torch.int32, "uint8": torch.uint8}
    in_dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    cases = [((32, g, g, 17), (s, s)) for g, s in UPSAMPLE_TIMED]
    paths, rows = set(), {}
    for shape, size in cases + UPSAMPLE_CASES:
        x = torch.randn(*shape, generator=gen, device="cuda")
        for in_name, in_dtype in in_dtypes.items():
            for out_name, out_dtype in out_dtypes.items():
                paths.add(epilogue_path(*shape, *size, out_dtype))
                rows[(shape, size, in_name, out_name)] = _upsample_agrees(
                    x.to(in_dtype), size, out_dtype)
    checked = {"cases": len(rows), "instantiations": sorted(paths),
               "flips": sum(r["flips"] for r in rows.values()),
               "min_agreement": min(r["agreement"] for r in rows.values())}
    emit("upsample_checks", **checked)

    plane = torch.randn(1, 6, 6, 1, generator=gen, device="cuda")
    for classes in (3, 17, 40):  # class 0 ties class 8 (2 at C = 3)
        x = torch.cat([plane - 1.0 - 0.1 * k for k in range(classes)], -1)
        twin = 8 if classes > 8 else classes - 1
        x[..., 0] = x[..., twin] = plane[..., 0]
        for out_dtype in out_dtypes.values():
            if bool((upsample_argmax(x, (24, 20), out_dtype=out_dtype) != 0)
                    .any()):
                raise AssertionError(f"upsample_argmax: a tie at C = "
                                     f"{classes} did not go to class 0")
    emit("upsample_ties", ok=True)
    # One output row's H-stage, 3500 columns x 20 floats, exceeds what a
    # block may opt in to: the launch must be refused, and raise.
    try:
        upsample_argmax(torch.zeros(1, 4, 3500, 17, device="cuda"), (8, 8))
    except RuntimeError:
        pass
    else:
        raise AssertionError("upsample_argmax: an H-stage row above a "
                             "block's shared memory was not refused")

    timed = {}
    for g, side in UPSAMPLE_TIMED:
        size = (side, side)
        x32 = torch.randn(32, g, g, 17, generator=gen, device="cuda")
        xs = {"fp32": x32, "bf16": x32.bfloat16()}
        for out_name, out_dtype in out_dtypes.items():
            row = {"shape": [32, g, g, 17], "out": [side, side],
                   "out_dtype": out_name,
                   "path": epilogue_path(32, g, g, 17, side, side, out_dtype)}
            for in_name, x in xs.items():
                def kernel(x=x):
                    return upsample_argmax(x, size, out_dtype=out_dtype)

                def pair(x=x):  # two library calls: a yardstick only
                    return F.interpolate(
                        x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=False).argmax(1).to(out_dtype)

                n_bytes = (x.numel() * x.element_size()
                           + 32 * side * side * kernel().element_size()
                           + 2 * side * 16)
                # Operations the function needs: the H-stage (2 mul, 1 add)
                # once per (b, Y, input column, class), the W-stage (2 mul,
                # 1 add) and the argmax compare once per pixel and class.
                n_ops = 3 * 32 * side * g * 17 + 4 * 32 * side * side * 17
                bound = bound_ms(peaks, n_bytes, n_ops, "fp32")
                row[in_name] = {
                    "ms": device_ms(kernel), "call_ms": time_ms(kernel),
                    "plain_ms": time_ms(lambda x=x: upsample_argmax_plain(
                        x, size, out_dtype)),
                    "library_ms": None, "library_pair_ms": device_ms(pair),
                    "bound_ms": bound[0], "bound_by": bound[1],
                    **rows[((32, g, g, 17), size, in_name, out_name)]}
                row[in_name]["ratio"] = row[in_name]["ms"] / bound[0]
            timed[(g, side, out_name)] = row
            emit("upsample", **row)
    # The serving path's shape: bf16 head logits, 14^2 -> 512^2, uint8.
    main = timed[(14, 512, "uint8")]
    return {**main["bf16"], "shape": main["shape"], "out": main["out"],
            "in_dtype": "bf16", "out_dtype": "uint8", "path": main["path"],
            "instantiations": checked["instantiations"],
            "int32_fp32": {k: timed[(14, 512, "int32")]["fp32"][k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}}


# ((rows, C), dtype) of kernel 10's checks, here and in
# tests/test_torch_layer_norm.py: the residual stream of ViT-B/16 and
# P4H768A12 at bucket 32, SegFormer-B5's four stage widths at bucket 8,
# and ViT-B/16's in fp32.
LAYER_NORM_CASES = tuple(
    (shape, torch.bfloat16) for shape in (
        (6304, 768), (100384, 768), (524288, 64), (131072, 128),
        (32768, 320), (8192, 512))) + (((6304, 768), torch.float32),)


# Kernel 10's bf16 output against its plain version: within one bf16 ulp
# of the value, or within this absolute floor, the fp32 rounding of the
# LayerNorm's terms (|x_hat * scale|, |shift| of order 1, a few fp32 ulps,
# summed in another order) where the result nearly cancels and a bf16 ulp
# of it is smaller. fp32: within 1e-5, relative (absolute below 1).
LAYER_NORM_ABS_FLOOR = 2.0 ** -20
LAYER_NORM_FP32_REL = 1e-5


def layer_norm_inputs(shape, dtype, gen):
    """(x, t, b, scale, shift, eps) of a kernel 10 check on the card: x and
    t N(0, 1), the bias and the shift 0.5 N(0, 1), the scale 1 + 0.1 N(0,
    1), eps that of the model with such rows (ViT 1e-12, MiT 1e-5)."""
    c = shape[1]
    x, t = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    b, h = (0.5 * torch.randn(c, generator=gen, device="cuda")
            for _ in range(2))
    g = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, t, b, g, h, 1e-12 if c == 768 else 1e-5


def layer_norm_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel 10's y against its plain version, with "ok" by the tolerance
    above. bf16: the largest difference absolute and, above the floor, in
    bf16 ulps of want; the values more than one ulp off, and those of them
    above the floor. fp32: the largest relative difference."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        rel = float((err / want.abs().clamp_min(1.0)).max())
        return {"y_rel_err": rel, "ok": rel <= LAYER_NORM_FP32_REL}
    e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126)).exponent
    ulp = torch.ldexp(torch.ones_like(err), e - 8)
    over = err > ulp
    above = err > LAYER_NORM_ABS_FLOOR
    bad = int((over & above).sum())
    return {"y_max_ulps": float((err / ulp)[above].max()) if bool(
                above.any()) else 0.0,
            "y_max_abs": float(err.max()),
            "y_over_1ulp": int(over.sum()),
            "y_over_1ulp_and_floor": bad, "ok": bad == 0}


def phase_layer_norm(peaks, gen):
    """Phase 3a: kernel 10 against its plain version, timed (module
    docstring); then its launches in ViT-B/16's captured forward. Returns
    the row of the ViT-B/16 residual shape."""
    from visiontransformer_tpu_torch.ops import layer_norm as ln
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    rows, failed = {}, []
    for shape, dtype in LAYER_NORM_CASES:
        c = shape[1]
        x, t, b, g, h, eps = layer_norm_inputs(shape, dtype, gen)
        gl, hl = g.to(dtype), h.to(dtype)
        for form in ("ln", "add_bias", "add"):
            bias = b if form == "add_bias" else None
            if form == "ln":
                def kernel():
                    return None, ln.layer_norm(x, g, h, eps=eps)

                def plain():
                    return None, ln.layer_norm_plain(x, g, h, eps)

                def library():
                    return F.layer_norm(x, (c,), gl, hl, eps)
            else:
                def kernel(bias=bias):
                    return ln.add_layer_norm(x, t, bias, g, h, eps=eps)

                def plain(bias=bias):
                    return ln.add_layer_norm_plain(x, t, bias, g, h, eps)

                def library(bias=bias):
                    s = x + (t if bias is None else t + bias.to(dtype))
                    return F.layer_norm(s, (c,), gl, hl, eps)
            with torch.inference_mode():
                spans.reset()
                s, y = kernel()
                torch.cuda.synchronize()
                launches = spans.counters().get("layer_norm", 0)
                want_s, want_y = plain()
                row = {"shape": list(shape), "dtype": str(dtype)[6:],
                       "form": form, "launches": launches,
                       "s_equal": None if s is None else bool(
                           torch.equal(s, want_s))}
                row.update(layer_norm_agreement(y, want_y))
                ok = (row.pop("ok") and launches == 1
                      and row["s_equal"] is not False)
                n_bytes = ((2 if form == "ln" else 4) * x.numel()
                           * x.element_size()
                           + (3 if form == "add_bias" else 2) * c * 4)
                n_ops = (8 + (0 if form == "ln" else 2)) * x.numel()
                bound = bound_ms(peaks, n_bytes, n_ops, "fp32")
                row.update(ms=device_ms(kernel), plain_ms=time_ms(plain),
                           library_ms=device_ms(library), bound_ms=bound[0],
                           bound_by=bound[1])
            row["roofline"] = bound[0] / row["ms"]
            row["ok"] = ok
            rows[(shape, dtype, form)] = row
            emit("layer_norm", **row)
            if not ok:
                failed.append(row)
        del x, t
    # ViT-B/16 at bucket 32 through the runner's CUDA graphs: the eager
    # pass that settles the libraries, then the capture, 25 calls each (12
    # ln1, 12 ln2 with attn_out's bias and residual, the final LayerNorm);
    # replays call nothing.
    row = {"model_family": "vitseg", "config_name": "P16H768A12",
           "num_classes": 17, "input_size": 224}
    spans.reset()
    runner = ModelRunner(row, device="cuda", buckets=(32,))
    runner.warmup()
    warm = spans.counters()
    runner.predict(np.zeros((32, 224, 224, 3), np.uint8))
    after = spans.counters()
    graphed = {"warmup_launches": warm.get("layer_norm", 0),
               "warmup_plain": warm.get("layer_norm_plain", 0),
               "replay_launches": after.get("layer_norm", 0)
               - warm.get("layer_norm", 0),
               "captures": warm.get("serve.graph_captures", 0)}
    emit("layer_norm_graphed", **graphed)
    del runner
    torch.cuda.empty_cache()
    if (graphed["captures"] != 1 or graphed["warmup_launches"] != 2 * 25
            or graphed["warmup_plain"] or graphed["replay_launches"]):
        failed.append(graphed)
    if failed:
        raise AssertionError(f"layer_norm: {failed}")
    return {**rows[((6304, 768), torch.bfloat16, "add_bias")],
            "graphed": graphed,
            "p4": rows[((100384, 768), torch.bfloat16, "add_bias")]}



# (rows, in, out) of every linear with a bias that the benchmark's cells run,
# at their buckets, here and in tests/test_torch_linear.py: ViT-B/16 at 32
# (the patch embedding, qkv, mlp_in), P4H768A12 at 32 (the same), and
# SegFormer-B5 at 8 crops of 1024^2, stage by stage (q and proj, k and v on
# the reduced keys, fc1, fc2).
LINEAR_CASES = (
    (6272, 768, 768), (6304, 768, 2304), (6304, 768, 3072),
    (100352, 48, 768), (100384, 768, 2304), (100384, 768, 3072),
    (524288, 64, 64), (8192, 64, 64), (524288, 64, 256), (524288, 256, 64),
    (131072, 128, 128), (8192, 128, 128), (131072, 128, 512),
    (131072, 512, 128),
    (32768, 320, 320), (8192, 320, 320), (32768, 320, 1280),
    (32768, 1280, 320),
    (8192, 512, 512), (8192, 512, 2048), (8192, 2048, 512))
# The fused linear against the plain one, value by value: the plain code
# rounds the product (half a bf16 ulp of it), then the sum (half an ulp of
# its result), the fused code the sum alone (half an ulp of its result), so
# the two lie within 1.5 bf16 ulps of the largest of |x·W| and the results.
# Or within this absolute floor, where all three are so small that a bf16
# ulp of them is below the spread of two GEMMs' fp32 accumulations over
# ``in`` terms in different orders (~sqrt(in)·2^-24 at these operands).
LINEAR_MAX_ULPS = 1.5
LINEAR_ABS_FLOOR = 2.0 ** -16


def linear_inputs(shape, gen):
    """(x, kernel, bias) of a linear check on the card: x N(0, 1) in bf16,
    the kernel N(0, 1/in) and the bias 0.5 N(0, 1) in fp32, as a model
    holds them (``linear`` casts both to x's dtype), so that |x·W| and the
    bias are of one order and both roundings of the plain code count."""
    rows, n_in, n_out = shape
    x = torch.randn(rows, n_in, generator=gen, device="cuda").to(
        torch.bfloat16)
    kernel = torch.randn(n_in, n_out, generator=gen,
                         device="cuda") / n_in ** 0.5
    bias = 0.5 * torch.randn(n_out, generator=gen, device="cuda")
    return x, kernel, bias


def linear_agreement(x, kernel, bias, fused, plain) -> dict:
    """The fused and the plain linear's bf16 outputs against the fp64
    product of the same bf16 operands plus the bf16 bias: each one's
    largest error; their largest difference in bf16 ulps of the largest of
    |x·W|, |fused| and |plain|, over the values above LINEAR_ABS_FLOOR; the
    values more than LINEAR_MAX_ULPS apart, and those of them above the
    floor. "ok": the fused error no larger than the plain one, and no value
    apart by both."""
    dt = x.dtype
    prod = x.double() @ kernel.to(dt).double()
    want = prod + bias.to(dt).double()
    err_fused = float((fused.double() - want).abs().max())
    err_plain = float((plain.double() - want).abs().max())
    del want
    scale = torch.maximum(prod.abs(), torch.maximum(
        fused.double().abs(), plain.double().abs())).float()
    del prod
    e = torch.frexp(scale.clamp_min(2.0 ** -126)).exponent
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    diff = (fused.float() - plain.float()).abs()
    ulps = diff / ulp
    over = ulps > LINEAR_MAX_ULPS
    above = diff > LINEAR_ABS_FLOOR
    bad = int((over & above).sum())
    return {"err_fused": err_fused, "err_plain": err_plain,
            "max_ulps": float(ulps[above].max()) if bool(above.any())
            else 0.0,
            "max_abs_diff": float(diff.max()),
            "over_ulps": int(over.sum()), "over_ulps_and_floor": bad,
            "ok": err_fused <= err_plain and bad == 0}


def _kernel_names(fn) -> list:
    """The device kernels one call of fn launches, in order (torch.profiler,
    after a call that settles the libraries)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(
        (e for e in prof.events() if _device_work(e)),
        key=lambda e: e.time_range.start)]


def phase_linear(peaks, gen):
    """Phase 3b: the linears' bias in cuBLASLt's epilogue (``nn/layers.py:
    linear``) at every linear shape of the benchmark's cells: the fused
    call against the fp64 product and the plain code (``linear_agreement``),
    the kernels each path launches (no elementwise add on the fused side),
    each timed by device time beside the product alone and its bound; then
    the engagement counts of a captured ViT-B/16 forward at bucket 32 and
    of one SegFormer-B5 forward at 1024^2. Returns the rows and counts."""
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.nn.layers import linear, linear_plain
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    rows, failed = [], []
    for shape in LINEAR_CASES:
        n, k, m = shape
        x, kernel, bias = linear_inputs(shape, gen)
        with torch.inference_mode():
            spans.reset()
            fused = linear(x, kernel, bias)
            torch.cuda.synchronize()
            counts = spans.counters()
            plain = linear_plain(x, kernel, bias)
            row = {"shape": list(shape),
                   "epilogue": counts.get("linear_epilogue", 0),
                   "plain": counts.get("linear_plain", 0)}
            row.update(linear_agreement(x, kernel, bias, fused, plain))
            del fused, plain
            # The operands in bf16 already, as the next casts would leave
            # them: each side's own kernels, the casts apart.
            kb, bb = kernel.to(x.dtype), bias.to(x.dtype)

            def fused_call():
                return linear(x, kb, bb)

            def plain_call():
                return linear_plain(x, kb, bb)

            def product():
                return torch.matmul(x, kb)

            row["fused_kernels"] = _kernel_names(fused_call)
            row["plain_kernels"] = _kernel_names(plain_call)
            row.update(fused_ms=device_ms(fused_call),
                       plain_ms=device_ms(plain_call),
                       product_ms=device_ms(product))
        bound = bound_ms(peaks, (n * k + k * m + n * m + m) * 2,
                         2 * n * k * m, "bf16")
        row.update(bound_ms=bound[0], bound_by=bound[1],
                   fused_over_plain=row["fused_ms"] / row["plain_ms"])
        row["ok"] = (row["ok"] and row["epilogue"] == 1 and not row["plain"]
                     and not any("elementwise" in name
                                 for name in row["fused_kernels"]))
        emit("linear", **row)
        rows.append(row)
        if not row["ok"]:
            failed.append(row)
        del x, kernel, bias, kb, bb
        torch.cuda.empty_cache()
    # ViT-B/16 at bucket 32 through the runner's CUDA graphs: the eager
    # pass and the capture, 25 biased linears each (the patch embedding,
    # 12 qkv, 12 mlp_in), all in the epilogue; replays call nothing.
    spans.reset()
    runner = ModelRunner({"model_family": "vitseg",
                          "config_name": "P16H768A12", "num_classes": 17,
                          "input_size": 224}, device="cuda", buckets=(32,))
    runner.warmup()
    warm = spans.counters()
    runner.predict(np.zeros((32, 224, 224, 3), np.uint8))
    after = spans.counters()
    graphed = {"warmup_epilogue": warm.get("linear_epilogue", 0),
               "warmup_plain": warm.get("linear_plain", 0),
               "replay_epilogue": after.get("linear_epilogue", 0)
               - warm.get("linear_epilogue", 0),
               "captures": warm.get("serve.graph_captures", 0)}
    emit("linear_graphed", **graphed)
    del runner
    torch.cuda.empty_cache()
    if (graphed["captures"] != 1 or graphed["warmup_epilogue"] != 2 * 25
            or graphed["warmup_plain"] or graphed["replay_epilogue"]):
        failed.append(graphed)
    # One bf16 SegFormer-B5 forward at the cell's crop: each of the 52
    # blocks' q, k, v, proj, fc1 and fc2 in the epilogue.
    _, model = resolve_model("segformer", "mit_b5", num_classes=19,
                             input_size=1024, device="cuda")
    spans.reset()
    with torch.inference_mode():
        model(torch.rand(1, 1024, 1024, 3, generator=gen,
                         device="cuda")).argmax(-1)
    torch.cuda.synchronize()
    b5 = {k: spans.counters().get(k, 0)
          for k in ("linear_epilogue", "linear_plain")}
    emit("linear_mit_b5", **b5)
    del model
    torch.cuda.empty_cache()
    if b5 != {"linear_epilogue": 6 * 52, "linear_plain": 0}:
        failed.append(b5)
    if failed:
        raise AssertionError(f"linear: {failed}")
    return {"rows": rows, "graphed": graphed, "mit_b5": b5}

def phase_model(gen):
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.models.vitseg import (
        vitseg_head_logits,
        vitseg_predict,
    )
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm

    batch, size, compute = 32, 512, 224
    cfg, model = resolve_model("vitseg", "P16H768A12", num_classes=17,
                               input_size=compute, compute_dtype="float32",
                               device="cuda")
    mean = torch.tensor(MEAN, device="cuda")
    std = torch.tensor(STD, device="cuda")
    raw = torch.rand(batch, size, size, 3, generator=gen, device="cuda")

    def preprocess(images):
        x = resize_bilinear_mm(images, (compute, compute))
        return (x - mean) / std

    def serve_step(kernels: bool):
        return vitseg_predict(
            model, preprocess(raw), out_size=(size, size),
            attn_impl="flash" if kernels else "eager",
            epilogue="kernel" if kernels else "plain",
            mask_dtype=torch.uint8)

    result = {"config": "P16H768A12", "classes": 17, "batch": batch,
              "in": size, "compute": compute}
    masks = {}
    with torch.inference_mode():
        x = preprocess(raw)
        for dtype in ("float32", "bfloat16"):
            model.cfg = dataclasses.replace(cfg, compute_dtype=dtype)
            spans.reset()
            got = serve_step(True)
            torch.cuda.synchronize()
            launches = (_launches("flash_attention"),
                        _launches("upsample_argmax"))
            if launches != (cfg.vit.num_hidden_layers, 1):
                raise AssertionError(f"{dtype}: launches per forward "
                                     f"{launches}, expected (12, 1)")
            parent = vitseg_predict(model, x, out_size=(size, size),
                                    attn_impl="flash", epilogue="kernel")
            if got.dtype != torch.uint8 or not torch.equal(
                    got, parent.to(torch.uint8)):
                raise AssertionError(f"{dtype}: uint8 masks differ from the "
                                     f"int32 kernel route cast to uint8")
            want = serve_step(False)
            grid_k = vitseg_head_logits(model, x, attn_impl="flash").float()
            grid_p = vitseg_head_logits(model, x, attn_impl="eager").float()
            row = {"launches_per_forward": {"flash_attention": launches[0],
                                            "upsample_argmax": launches[1]}}
            if dtype == "float32":
                ok, err = close(grid_k, grid_p, *LOGITS_TOL)
                # Upsampling is a convex combination, so the two paths'
                # upsampled logits differ by at most err: a flip must sit on
                # a plain-path gap of at most 2 * err (+ rounding).
                flips, worst = ties_explained(
                    resize_bilinear_mm(grid_p, (size, size)), got, want,
                    2 * err + UPSAMPLE_TIE_TOL)
                row.update(logits_max_abs_err=err, logits_tol=LOGITS_TOL,
                           mask_flips=flips, flip_max_logit_gap=worst)
                if not ok:
                    raise AssertionError(f"fp32 seg logits disagree: {err}")
            else:
                row["logits_max_abs_err"] = float((grid_k - grid_p).abs().max())
            row["agreement_vs_plain"] = float((got == want).float().mean())
            if dtype == "bfloat16":
                row["agreement_vs_fp32_plain"] = float(
                    (got == masks["float32"]).float().mean())
            masks[dtype] = want
            # Host clock around 10 steps ending in the masks' readback;
            # best of 3 rounds, kernels and plain paths in turns.
            for kernels, key in ((True, "masks_per_s"),
                                 (False, "plain_masks_per_s"),
                                 (True, "masks_per_s"),
                                 (False, "plain_masks_per_s")):
                serve_step(kernels).cpu()
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(10):
                        out = serve_step(kernels)
                    out.cpu()
                    rate = batch * 10 / (time.perf_counter() - t0)
                    row[key] = max(row.get(key, 0.0), rate)
            result[dtype] = row
            emit("model_" + dtype, **row)
        emit("profile", **profile_steps(lambda: serve_step(True), batch))
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit("model", peak_mem_gb=result["peak_mem_gb"])
    model.to("cpu")
    return result


def _device_work(event) -> bool:
    """A kernel, copy or memset on the card; not the profiler's device-side
    mirror of a host range (the program's spans, ``utils/spans.py``)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def profile_steps(step, batch: int, steps: int = 5, top: int = 12):
    """Device time by kernel name over a few steps (torch.profiler), and
    the device's busy share of the host-clock window."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if _device_work(e)]
    device_us = {}
    for e in device:
        device_us[e.name] = (device_us.get(e.name, 0.0)
                             + e.time_range.elapsed_us())
    busy_ms = sum(device_us.values()) / 1e3
    ranked = sorted(device_us.items(), key=lambda kv: -kv[1])[:top]
    # The port's own kernels (compiled into anonymous namespaces), whatever
    # their rank.
    mark = "(anonymous namespace)::"
    own = {k.split(mark)[1].split("(")[0]: us / 1e3 / steps
           for k, us in device_us.items() if mark in k}
    kernels = sum(1 for e in device
                  if not e.name.startswith(("Memcpy", "Memset")))
    return {"steps": steps, "batch": batch, "own_kernels_ms_per_step": own,
            "device_kernels_per_step": kernels / steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / wall_ms,
            "top": [{"name": k[:90], "ms_per_step": us / 1e3 / steps,
                     "share": us / 1e3 / busy_ms} for k, us in ranked]}


# (B, H, N, d) of the flash_train checks: the main shapes, then the edges of
# the backward kernels' 64-row tiles.
TRAIN_CASES = [(4, 12, 197, 64), (32, 12, 197, 64), (4, 12, 785, 64),
               (4, 12, 1025, 64), (2, 12, 3137, 64), (8, 16, 257, 80),
               (2, 4, 130, 16), (2, 4, 130, 32), (2, 4, 130, 128)]
TRAIN_EDGE_NS = (1, 63, 64, 65, 127, 129, 255, 256, 257)
# (B*H, N) timed, bf16, d = 64, each with and without dropout.
TRAIN_TIMED = ((48, 197), (48, 785), (48, 1025), (24, 3137))


def check_train_kernels(gen, shape, dtype, rate: float):
    """Kernels 2-4 (and dQ with Δ in its prologue) against their plain
    versions on one random (B, H, N, d) case with strided Q, K, V and a
    transposed dO, as the model hands them over. Returns (row, the inputs
    of ``_time_train_kernels``); raises with the row where one disagrees."""
    from visiontransformer_tpu_torch.ops.flash_attention import (
        attention_delta_plain,
        backward_path,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_delta,
        flash_attention_bwd_dq_plain,
        flash_attention_train,
        flash_attention_train_plain,
        forward_path,
    )

    b, h, n, d = shape
    qkv = torch.randn(b, n, 3, h, d, generator=gen, device="cuda")
    qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    # dO as autograd hands it over: a transposed view.
    do = torch.randn(b, n, h, d, generator=gen, device="cuda")
    do = do.to(dtype).transpose(1, 2)
    seed = torch.randint(0, 2 ** 31, (), generator=gen, device="cuda")
    out, lse = flash_attention_train(q, k, v, rate, seed)
    p_out, p_lse = flash_attention_train_plain(q, k, v, rate, seed)
    delta = attention_delta_plain(do, p_out)
    bwd = (q, k, v, do, p_lse, delta, rate, seed)
    p_dq = flash_attention_bwd_dq_plain(*bwd)
    p_dk, p_dv = flash_attention_bwd_dkv_plain(*bwd)
    checks = {"out": flash_agrees(out, p_out)}
    ok, err = close(lse, p_lse, LSE_ATOL, 0.0)
    checks["lse"] = (ok, {"max_abs_err": err, "atol": LSE_ATOL})
    dq = flash_attention_bwd_dq(*bwd)
    dq_d, delta_k = flash_attention_bwd_dq_delta(
        q, k, v, do, p_lse, p_out, rate, seed)
    dk, dv = flash_attention_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    for key, got, want in (("dq", dq, p_dq),
                           ("dq_delta", dq_d, p_dq),
                           ("dk", dk, p_dk), ("dv", dv, p_dv)):
        ok, fields = grad_agrees(got, want)
        if not ok and n == 1 and key != "dv":
            # Zero by construction: hold both to zero.
            worst = float(torch.maximum(got.float().abs().max(),
                                        want.float().abs().max()))
            ok, fields = worst <= ZERO_GRAD_ATOL, {
                "max_abs_err": worst, "atol": ZERO_GRAD_ATOL}
        checks[key] = (ok, fields)
    ok, err = close(delta_k, delta, *DELTA_TOL)
    checks["delta"] = (ok, {"max_abs_err": err, "atol": DELTA_TOL[0]})
    row = {"shape": [b, h, n, d], "dtype": str(dtype)[6:], "rate": rate,
           "path": backward_path(n, d, dtype),
           "fwd_path": forward_path(n, d, dtype),
           **{name: fields for name, (_, fields) in checks.items()}}
    failed = [name for name, (ok, _) in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training kernels {failed} disagree: {row}")
    return row, (q, k, v, do, out, lse, rate, seed)


def phase_flash_train(peaks, gen):
    """Kernels 2-4 vs their plain versions; returns the timed rows by
    (B*H, N, rate), bf16, d = 64."""
    # Tile edges: all of them on the d = 64 instantiation; 63 to 129 on the
    # other head dims' with two chains a warp (32) and one (128), at the
    # micro-batch's 48 heads: where one large dS rounds to the other bf16
    # neighbour, a whole row of dQ or dK moves with it, which six heads
    # of 65 rows do not average out (error norm 4.40e-4 at (2, 3, 65, 32),
    # the same error against an fp64 reference as the plain version's).
    # (N = 1 with dropout leaves dQ and dK the rounding of O, one value a
    # head: at d = 128 the order of a 128-term sum decides it.)
    cases = TRAIN_CASES + [(2, 3, n, 64) for n in TRAIN_EDGE_NS] + [
        (4, 12, n, d) for d in (32, 128) for n in TRAIN_EDGE_NS[1:6]]
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, n, d in cases:
            for rate in (0.0, 0.1):
                row, inputs = check_train_kernels(gen, (b, h, n, d), dtype,
                                                  rate)
                if (dtype == torch.bfloat16 and d == 64
                        and (b * h, n) in TRAIN_TIMED):
                    row["timing"] = _time_train_kernels(peaks, *inputs)
                    timed[(b * h, n, rate)] = row
                emit("flash_train", **row)
    return timed


def _time_train_kernels(peaks, q, k, v, do, out, lse, rate, seed):
    """ms, library ms (device time, ``device_ms``) and bound of kernels 2,
    3 and 4 on these inputs (and kernel 1's ms without dropout), and
    call_ms and plain_ms, the time per call back to back (CUDA events, host
    overhead included). Kernel 3 is
    timed as the training path launches it, with delta = rowsum(dO * O)
    computed in its prologue from ``out`` (so it reads O too: 6 tensors of
    B*H*N*d, lse, and writes delta), against the plain delta and dQ;
    given_delta_ms: the launch that reads a given delta; delta_ms: the
    difference; delta_torch_ms: the same reduction as PyTorch operations.
    Library: F.scaled_dot_product_attention with the same dropout rate,
    forward for kernel 2 and backward (forward + backward minus forward)
    for kernels 3 and 4 together; bwd_sum_ms is dQ + dK/dV beside it."""
    from visiontransformer_tpu_torch.ops.flash_attention import (
        attention_delta_plain,
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_delta,
        flash_attention_bwd_dq_plain,
        flash_attention_train,
        flash_attention_train_plain,
    )

    b, h, n, d = q.shape
    bh, elt = b * h, q.element_size()
    delta = attention_delta_plain(do, out)
    bwd = (q, k, v, do, lse, delta, rate, seed)
    # The plain versions draw the dropout mask with int64 tensor ops; a few
    # calls time them.
    plain_iters = 2 if n > 1024 else 5
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(*leaves, dropout_p=rate)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves, dropout_p=rate).backward(do)

    sdpa_fwd_ms = device_ms(sdpa_fwd)
    sdpa_bwd_ms = device_ms(sdpa_fwd_bwd) - sdpa_fwd_ms
    rows = {}
    for name, fn, plain, n_bytes, n_ops, library in (
            ("fwd_train", lambda: flash_attention_train(q, k, v, rate, seed),
             lambda: flash_attention_train_plain(q, k, v, rate, seed),
             4 * bh * n * d * elt + 4 * bh * n, 4 * bh * n * n * d,
             sdpa_fwd_ms),
            ("bwd_dq", lambda: flash_attention_bwd_dq_delta(
                q, k, v, do, lse, out, rate, seed),
             lambda: flash_attention_bwd_dq_plain(
                 q, k, v, do, lse, attention_delta_plain(do, out), rate, seed),
             6 * bh * n * d * elt + 8 * bh * n, 6 * bh * n * n * d,
             sdpa_bwd_ms),
            ("bwd_dkv", lambda: flash_attention_bwd_dkv(*bwd),
             lambda: flash_attention_bwd_dkv_plain(*bwd),
             6 * bh * n * d * elt + 8 * bh * n, 8 * bh * n * n * d,
             sdpa_bwd_ms)):
        row = {"ms": device_ms(fn), "call_ms": time_ms(fn),
               "plain_ms": time_ms(plain, plain_iters, 1),
               "library_ms": library}
        row["bound_ms"], row["bound_by"] = bound_ms(peaks, n_bytes, n_ops,
                                                    "bf16")
        rows[name] = row
    given = device_ms(lambda: flash_attention_bwd_dq(*bwd))
    rows["bwd_dq"]["given_delta_ms"] = given
    rows["bwd_dq"]["delta_ms"] = rows["bwd_dq"]["ms"] - given
    rows["bwd_dq"]["delta_torch_ms"] = device_ms(
        lambda: attention_delta_plain(do, out))
    rows["bwd_sum_ms"] = rows["bwd_dq"]["ms"] + rows["bwd_dkv"]["ms"]
    rows["sdpa_bwd_ms"] = sdpa_bwd_ms
    if rate == 0.0:  # kernel 1 on the same inputs, for the flash_forward line
        rows["fwd_infer_ms"] = device_ms(lambda: flash_attention(q, k, v))
    rows["library_note"] = ("SDPA forward with dropout; SDPA backward "
                            "(fwd+bwd minus fwd) covers bwd_dq and bwd_dkv "
                            "together; bwd_sum_ms = dQ (delta in its "
                            "prologue) + dK/dV")
    return rows


def _synthetic_ce_set(root: str, n_samples: int):
    """The port's copy of generate_multiclass at 224^2, as a CE dataset."""
    from visiontransformer_tpu_torch.data import CESegmentationDataset
    from visiontransformer_tpu_torch.data.synthetic import generate_multiclass

    generate_multiclass(root, n_samples=n_samples, image_size=224)
    return CESegmentationDataset(f"{root}/image_png", f"{root}/mask_png",
                                 image_size=224, cache=True)


def _launches(kernel: str) -> int:
    """Launches of a kernel since the last ``spans.reset()``: the port
    counts each under the kernel's name (``utils/spans.py``)."""
    return spans.counters().get(kernel, 0)


def _train_launches():
    names = {"flash_attention_fwd": "flash_attention",
             "flash_attention_fwd_train": "flash_attention_train",
             "flash_attention_bwd_dq": "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv": "flash_attention_bwd_dkv"}
    return spans.reset, lambda: {key: _launches(kernel)
                                 for key, kernel in names.items()}


def phase_train():
    """The port's Trainer on ViT-B/16 with the CE defaults (bf16)."""
    import csv

    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.data.pipeline import batch_iterator
    from visiontransformer_tpu_torch.models.registry import vitseg_config
    from visiontransformer_tpu_torch.train.trainer import Trainer
    from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

    cfg = vitseg_config("P16H768A12", num_classes=17,
                        compute_dtype="bfloat16")
    tcfg = dataclasses.replace(CE_TRAIN_DEFAULTS, max_epochs=1,
                               log_every_n_steps=1)
    layers, accum = cfg.vit.num_hidden_layers, tcfg.accumulate_grad_batches
    reset, read = _train_launches()
    result = {"config": "P16H768A12", "classes": 17, "dtype": "bfloat16",
              "batch": tcfg.batch_size, "accumulate": accum,
              "dropout": [cfg.vit.hidden_dropout_prob,
                          cfg.vit.attention_probs_dropout_prob]}
    with tempfile.TemporaryDirectory() as tmp:
        data = _synthetic_ce_set(f"{tmp}/data", 3 * tcfg.batch_size)
        trainer = Trainer(cfg, tcfg, device="cuda",
                          logger=CSVLogger(f"{tmp}/logs"))
        reset()
        t0 = time.perf_counter()
        state = trainer.fit(data)
        torch.cuda.synchronize()
        result["fit_s"] = time.perf_counter() - t0
        launches = read()
        with open(trainer.logger.path) as f:
            losses = [float(r["train_loss_step"]) for r in csv.DictReader(f)
                      if r["train_loss_step"]]
        result.update(steps=state.step, losses=losses, launches=launches)
        per_step = layers * accum * state.step
        want = {"flash_attention_fwd": 0, "flash_attention_fwd_train":
                per_step, "flash_attention_bwd_dq": per_step,
                "flash_attention_bwd_dkv": per_step}
        if state.step < 3 or launches != want:
            raise AssertionError(f"train launches {launches} over "
                                 f"{state.step} steps, expected {want}")
        if len(losses) != state.step or not all(
                np.isfinite(x) for x in losses):
            raise AssertionError(f"train losses {losses}")

        reset()
        metrics = trainer.evaluate(data, state.model)
        launches = read()
        batches = len(data) // tcfg.batch_size
        if (launches["flash_attention_fwd"] != layers * batches
                or any(v for k, v in launches.items()
                       if k != "flash_attention_fwd")
                or not np.isfinite(metrics["loss"])):
            raise AssertionError(f"evaluate launches {launches}, {metrics}")
        result.update(eval_loss=metrics["loss"], eval_launches=launches)

        # Throughput on batches already on the card (no host decode).
        for batch_size, accumulate, key in ((tcfg.batch_size, accum,
                                             "reference"),
                                            (32, 1, "batch32")):
            trainer.train_cfg = dataclasses.replace(
                tcfg, batch_size=batch_size,
                accumulate_grad_batches=accumulate)
            batches = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
                       for b in batch_iterator(data, batch_size, shuffle=True,
                                               seed=1)]
            step = _train_step_fn(trainer, state, batches)
            step()
            torch.cuda.synchronize()
            if key == "reference":
                torch.cuda.reset_peak_memory_stats()
            best = 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(5):
                    step()
                torch.cuda.synchronize()
                best = max(best, 5 / (time.perf_counter() - t0))
            result[key] = {"batch": batch_size, "accumulate": accumulate,
                           "steps_per_s": best,
                           "images_per_s": best * batch_size}
            if key == "reference":
                result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            result[key]["profile"] = profile_steps(step, batch_size, steps=3)
        trainer.train_cfg = tcfg
    emit("train", **result)
    return result


def _train_step_fn(trainer, state, batches):
    count = [0]

    def step():
        trainer.train_step(state, batches[count[0] % len(batches)], count[0])
        count[0] += 1

    return step


def phase_train_fp32_step():
    """One fp32 optimizer step, dropout off, kernels vs eager attention on
    the same weights and batch."""
    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.models.registry import vitseg_config

    cfg = vitseg_config("P16H768A12", num_classes=17, compute_dtype="float32")
    tcfg = CE_TRAIN_DEFAULTS
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((tcfg.batch_size, 224, 224, 3), np.float32),
             "mask": rng.integers(0, 17, (tcfg.batch_size, 256, 256),
                                  dtype=np.int32)}
    return _fp32_step_vs_eager(cfg, tcfg, "ce", batch, "train_fp32_step")


def _fp32_step_vs_eager(cfg, tcfg, task: str, batch, line: str):
    """One fp32 optimizer step of ``task`` with dropout off, through the
    kernels and through eager attention on the same weights and batch: the
    loss within LOSS_RTOL, every gradient within GRAD_TOL[fp32], and
    kernel 4 launched layers x micro-batches times. Prints ``line``."""
    from visiontransformer_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    reset, read = _train_launches()
    runs = {}
    for impl in ("flash", "eager"):
        trainer = Trainer(cfg, tcfg, task=task, device="cuda",
                          attn_impl=impl)
        state = trainer.init_state()
        reset()
        _, metrics = trainer.train_step(state, batch, seed=0)
        runs[impl] = (float(metrics["loss"]), read(),
                      {name: p.grad.detach() for name, p in
                       state.model.named_parameters()})
        del state
    (loss_k, launches, grads_k), (loss_e, _, grads_e) = (runs["flash"],
                                                         runs["eager"])
    checks = {name: close(grads_k[name], grads_e[name],
                          *GRAD_TOL[torch.float32]) for name in grads_k}
    bad = [name for name, (ok, _) in checks.items() if not ok]
    worst = max(checks, key=lambda name: checks[name][1])
    per_step = cfg.vit.num_hidden_layers * tcfg.accumulate_grad_batches
    result = {"loss_kernels": loss_k, "loss_eager": loss_e,
              "loss_rel_diff": abs(loss_k - loss_e) / abs(loss_e),
              "grads": len(grads_k), "grads_failed": bad,
              "worst_grad": {"name": worst,
                             "max_abs_err": checks[worst][1]},
              "grad_tol": GRAD_TOL[torch.float32], "launches": launches}
    emit(line, **result)
    if (result["loss_rel_diff"] > LOSS_RTOL or bad
            or launches["flash_attention_bwd_dkv"] != per_step):
        raise AssertionError(f"fp32 {task} train step: kernels vs eager "
                             f"{result}")
    return result


def step_grads_agree(got: dict, want: dict):
    """(failed names, error norms, elementwise checks) of one optimizer
    step's per-parameter gradients against the plain versions': GRAD_TOL's
    bf16 elementwise form, and the error's norm within STEP_GRAD_REL_NORM
    of the plain gradient's."""
    atol, rtol = GRAD_TOL[torch.bfloat16]
    checks, norms = {}, {}
    for name, grad in want.items():
        checks[name] = close(got[name], grad,
                             atol * float(grad.abs().max()), rtol)
        norms[name] = float((got[name] - grad).norm() / grad.norm())
    bad = [name for name, (ok, _) in checks.items() if not ok]
    bad += [name for name, x in norms.items()
            if not x <= STEP_GRAD_REL_NORM and name not in bad]
    return bad, norms, checks


def _plain_training_kernels():
    """Context manager: ``FlashAttention`` runs the plain versions of
    kernels 2, 3 and 4 (on whatever device the tensors are)."""
    import contextlib

    from visiontransformer_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def patched():
        saved = (fa.flash_attention_train, fa.flash_attention_bwd_dq_delta,
                 fa.flash_attention_bwd_dkv)

        def dq_delta(q, k, v, do, lse, out, rate=0.0, seed=None):
            delta = fa.attention_delta_plain(do, out)
            return fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                   rate, seed), delta

        fa.flash_attention_train = fa.flash_attention_train_plain
        fa.flash_attention_bwd_dq_delta = dq_delta
        fa.flash_attention_bwd_dkv = fa.flash_attention_bwd_dkv_plain
        try:
            yield
        finally:
            (fa.flash_attention_train, fa.flash_attention_bwd_dq_delta,
             fa.flash_attention_bwd_dkv) = saved

    return patched()


def phase_train_bf16_dropout_step():
    """One bf16 optimizer step with the CE defaults' dropout 0.1, through
    the kernels and through their plain versions on the card, on the same
    weights, batch and seeds."""
    import contextlib

    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.models.registry import vitseg_config
    from visiontransformer_tpu_torch.train.trainer import Trainer

    cfg = vitseg_config("P16H768A12", num_classes=17,
                        compute_dtype="bfloat16")
    tcfg = CE_TRAIN_DEFAULTS
    rng = np.random.default_rng(1)
    batch = {"image": rng.random((tcfg.batch_size, 224, 224, 3), np.float32),
             "mask": rng.integers(0, 17, (tcfg.batch_size, 256, 256),
                                  dtype=np.int32)}
    reset, read = _train_launches()
    runs = {}
    for impl, context in (("kernels", contextlib.nullcontext()),
                          ("plain", _plain_training_kernels())):
        trainer = Trainer(cfg, tcfg, device="cuda")
        state = trainer.init_state()
        reset()
        with context:
            _, metrics = trainer.train_step(state, batch, seed=0)
        runs[impl] = (float(metrics["loss"]), read(),
                      {name: p.grad.detach() for name, p in
                       state.model.named_parameters()})
        del state
    (loss_k, launches, grads_k), (loss_p, launches_p, grads_p) = (
        runs["kernels"], runs["plain"])
    atol, rtol = GRAD_TOL[torch.bfloat16]
    bad, norms, checks = step_grads_agree(grads_k, grads_p)
    worst = max(norms, key=norms.get)
    per_step = cfg.vit.num_hidden_layers * tcfg.accumulate_grad_batches
    result = {"loss_kernels": loss_k, "loss_plain": loss_p,
              "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
              "dropout": [cfg.vit.hidden_dropout_prob,
                          cfg.vit.attention_probs_dropout_prob],
              "grads": len(grads_k), "grads_failed": bad,
              "worst_grad": {"name": worst, "rel_err_norm": norms[worst],
                             "max_abs_err": checks[worst][1]},
              "grad_tol": [atol, rtol, STEP_GRAD_REL_NORM],
              "launches": launches, "launches_plain": launches_p}
    emit("train_bf16_dropout_step", **result)
    if (result["loss_rel_diff"] > STEP_LOSS_RTOL or bad
            or cfg.vit.attention_probs_dropout_prob <= 0.0
            or launches["flash_attention_bwd_dkv"] != per_step
            or launches["flash_attention_bwd_dq"] != per_step
            or launches["flash_attention_fwd_train"] != per_step
            or any(launches_p.values())):
        raise AssertionError(f"bf16 dropout step: kernels vs plain {result}")
    return result


class _Client:
    def __init__(self, base):
        self.base, self.cookies = base, {}

    def request(self, method, path, body=None, content_type=None,
                headers=None):
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        if content_type:
            req.add_header("Content-Type", content_type)
        if self.cookies:
            req.add_header("Cookie", "; ".join(
                f"{k}={v}" for k, v in self.cookies.items()))
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            resp = urllib.request.urlopen(req, timeout=120)
            status = resp.status
        except urllib.error.HTTPError as e:
            resp, status = e, e.code
        for header in resp.headers.get_all("Set-Cookie") or []:
            k, v = header.split(";")[0].split("=", 1)
            if v:
                self.cookies[k] = v
        raw = resp.read()
        try:
            return status, json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return status, raw

    def post_json(self, path, payload):
        return self.request("POST", path, json.dumps(payload).encode(),
                            "application/json")


def _multipart(fields, files):
    boundary = "chipsmokeboundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
             f'\r\n\r\n{v}\r\n'.encode() for k, v in fields.items()]
    for k, (fname, content) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\nContent-Type: '
                     f'image/png\r\n\r\n'.encode() + content + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _kernels_after_epilogue(runner, images):
    """Names of the device kernels that one ModelRunner.predict launches
    after kernel 5 (torch.profiler): none when the masks it copies to the
    host are kernel 5's own output, with no cast between."""
    from torch.profiler import ProfilerActivity, profile

    runner.predict(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.predict(images)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events()
         if _device_work(e) and not e.name.startswith(("Memcpy", "Memset"))),
        key=lambda e: e.time_range.start)]
    last = [i for i, n in enumerate(names) if "upsample_argmax_kernel" in n]
    if not last:
        raise AssertionError(f"the profiler saw no epilogue kernel in "
                             f"ModelRunner.predict: {names}")
    return names[last[-1] + 1:]


def _job_pngs(n_jobs: int, seed: int):
    from PIL import Image

    rng = np.random.default_rng(seed)
    pngs = []
    for _ in range(n_jobs):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (256, 256, 3), np.uint8)).save(
            buf, format="PNG")
        pngs.append(buf.getvalue())
    return pngs


def _decoded(png: bytes, size: int = 224) -> np.ndarray:
    """A job's image as the worker feeds it to the model (uint8)."""
    from PIL import Image

    img = Image.open(io.BytesIO(png)).convert("RGB").resize(
        (size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


@contextlib.contextmanager
def _http_server(store, buckets, **runner):
    """The port's HTTP server with an InferenceWorker on cuda (``runner``:
    its serving mesh), a user registered and logged in: yields (client,
    CSRF header, startup s)."""
    from visiontransformer_tpu_torch.serve.server import create_server
    from visiontransformer_tpu_torch.serve.worker import InferenceWorker

    t0 = time.perf_counter()
    worker = InferenceWorker(store, device="cuda", buckets=buckets, **runner)
    worker.start()
    server, _ = create_server(store, worker=worker)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    startup_s = time.perf_counter() - t0
    try:
        client = _Client(f"http://127.0.0.1:{server.server_address[1]}")
        assert client.post_json("/api/users/register/", {
            "username": "smoke", "password": "smoke-pass"})[0] == 201
        assert client.post_json("/api/users/login/", {
            "username": "smoke", "password": "smoke-pass"})[0] == 200
        client.request("GET", "/api/csrf/")
        yield client, {"X-CSRFToken": client.cookies["csrftoken"]}, startup_s
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()


def _run_jobs(client, csrf, model_id, pngs):
    """POST one job per PNG and poll until all are DONE or FAILED: (job
    ids, details by id, seconds)."""
    t0 = time.perf_counter()
    jobs = []
    for i, png in enumerate(pngs):
        body, ctype = _multipart({"vision_model": str(model_id)},
                                 {"input_image": (f"{i}.png", png)})
        status, job = client.request("POST", "/api/inference-jobs/",
                                     body, ctype, headers=csrf)
        assert status == 201, job
        jobs.append(job["id"])
    done = {}
    deadline = time.time() + 300
    while len(done) < len(pngs) and time.time() < deadline:
        for job_id in jobs:
            if job_id not in done:
                _, detail = client.request(
                    "GET", f"/api/inference-jobs/{job_id}/?wait=5")
                if detail["status"] in ("DONE", "FAILED"):
                    done[job_id] = detail
    elapsed = time.perf_counter() - t0
    failed = [d for d in done.values() if d["status"] != "DONE"]
    if len(done) < len(pngs) or failed:
        raise AssertionError(f"jobs not DONE: {failed or done}")
    return jobs, done, elapsed


def _served_masks(client, jobs, done):
    from PIL import Image

    return [np.asarray(Image.open(io.BytesIO(client.request(
        "GET", done[job_id]["mask_image"])[1]))) for job_id in jobs]


def graphed_runner_check(config: str, buckets=(1, 2, 4, 8, 16, 32),
                         row_extra=None, **mesh) -> dict:
    """ModelRunner on cuda serves through CUDA graphs: after warmup, its
    masks at every bucket equal, bit for bit, on the same rows (each
    replica's rows alone on a mesh), both vitseg_predict of the runner's
    model(s) (the one masks forward, run eagerly) and the per-block
    forward (vitseg_head_logits, whose residual adds and LayerNorms run
    apart, then kernel 5); one capture a bucket and replica; every
    dispatch served by replays; kernel 1 launched once a block and
    replica, kernel 5 once a replica."""
    from visiontransformer_tpu_torch.models.vitseg import (
        vitseg_head_logits,
        vitseg_predict,
    )
    from visiontransformer_tpu_torch.ops.upsample_argmax import (
        upsample_argmax,
    )
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    row = {"model_family": "vitseg", "config_name": config,
           "num_classes": 17, "input_size": 224, **(row_extra or {})}
    spans.reset()
    t0 = time.perf_counter()
    runner = ModelRunner(row, device="cuda", buckets=buckets, **mesh)
    runner.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    replicas = len(runner.replicas)
    layers = runner.cfg.vit.num_hidden_layers
    captures = spans.counters().get("serve.graph_captures", 0)
    rng = np.random.default_rng(5)
    equal, equal_per_block, launches = {}, {}, {}
    spans.reset()
    for b in buckets:
        images = rng.integers(0, 256, (b, 224, 224, 3), np.uint8)
        before = {k: _launches(k) for k in ("flash_attention",
                                            "upsample_argmax")}
        got = runner.predict(images)
        launches[b] = {k: _launches(k) - v for k, v in before.items()}
        per = b // replicas
        want, per_block = [], []
        with torch.inference_mode():
            for i, (_, forward, stream) in enumerate(runner.replicas):
                with torch.cuda.stream(stream or torch.cuda.current_stream()):
                    x = torch.from_numpy(images[i * per:(i + 1) * per])
                    x = x.cuda().float() / 255.0
                    want.append(vitseg_predict(
                        forward.model, x, out_size=(224, 224),
                        mask_dtype=runner.mask_dtype).cpu())
                    per_block.append(upsample_argmax(
                        vitseg_head_logits(forward.model, x).contiguous(),
                        (224, 224), out_dtype=runner.mask_dtype).cpu())
        torch.cuda.synchronize()
        equal[b] = bool(np.array_equal(got, torch.cat(want).numpy()))
        equal_per_block[b] = bool(np.array_equal(
            got, torch.cat(per_block).numpy()))
    counters = spans.counters()
    out = {"config": config, "row": row_extra or {}, "replicas": replicas,
           "graphed": runner.graphed, "captures": captures,
           "warmup_s": warm_s, "equal": equal,
           "equal_per_block": equal_per_block,
           "batches": counters.get("serve.batches", 0),
           "graphed_batches": counters.get("serve.graphed_batches", 0),
           "launches": launches}
    emit("graphed_runner", **out)
    want_launches = {"flash_attention": layers * replicas,
                     "upsample_argmax": replicas}
    if (not runner.graphed or captures != len(buckets) * replicas
            or not all(equal.values()) or not all(equal_per_block.values())
            or not out["graphed_batches"] == out["batches"] == len(buckets)
            or any(v != want_launches for v in launches.values())):
        raise AssertionError(f"graphed runner: {out}")
    del runner
    torch.cuda.empty_cache()
    return out


def phase_serving(n_jobs: int = 8):
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    pngs = _job_pngs(n_jobs, seed=0)
    # One bucket: every forward has batch 8, so the check below repeats
    # each job's forward at the same shape (per-row results of a fixed
    # shape do not depend on the other rows).
    buckets = (n_jobs,)
    with tempfile.TemporaryDirectory() as media:
        store = JobStore(":memory:", media_root=media)
        model_id = store.register_model("vit-b16-damage", num_classes=17,
                                        config_name="P16H768A12")
        with _http_server(store, buckets) as (client, csrf, startup_s):
            spans.reset()
            jobs, done, elapsed = _run_jobs(client, csrf, model_id, pngs)
            launches = {"flash_attention": _launches("flash_attention"),
                        "upsample_argmax": _launches("upsample_argmax")}
            if (launches["upsample_argmax"] < 1 or launches["flash_attention"]
                    != 12 * launches["upsample_argmax"]):
                raise AssertionError(f"serving launches {launches}")

            runner = ModelRunner(store.get_model(model_id), device="cuda",
                                 buckets=buckets)
            equal = 0
            for mask, png in zip(_served_masks(client, jobs, done), pngs):
                want = runner.predict(_decoded(png)[None])[0]
                equal += int(np.array_equal(mask, want))
            if equal != n_jobs:
                raise AssertionError(f"{n_jobs - equal} job masks differ from "
                                     f"ModelRunner.predict")
            after = _kernels_after_epilogue(runner, _decoded(pngs[-1])[None])
            if after:
                raise AssertionError(f"ModelRunner.dispatch launched {after} "
                                     f"after the epilogue kernel")
    graphed = [graphed_runner_check("P16H768A12"),
               graphed_runner_check("P4H768A12"),
               graphed_runner_check("P16H768A12", buckets=(2, 4, 8, 16, 32),
                                    mesh_shape=(2,),
                                    devices=["cuda:0", "cuda:0"])]
    result = {"jobs": n_jobs, "jobs_per_s": n_jobs / elapsed,
              "seconds": elapsed, "startup_s": startup_s,
              "masks_equal_runner": equal, "launches": launches,
              "kernels_after_epilogue": len(after),
              "detections_job0": len(done[jobs[0]]["detections"]),
              "graphed_equal": [g["equal"] for g in graphed]}
    emit("serving", **result)
    return result


def _model_diffs(a, b) -> list:
    """Names of the parameters, Adam state entries and hyperparameters
    (learning rate included) in which two TrainStates differ, bit for bit,
    and the step if it differs."""
    diffs = [name for (name, x), (_, y) in zip(
        a.model.state_dict().items(), b.model.state_dict().items())
        if not torch.equal(x, y)]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sa["param_groups"] != sb["param_groups"]:
        diffs.append("param_groups")
    if sorted(sa["state"]) != sorted(sb["state"]):
        diffs.append("optimizer state keys")
    for index, entries in sa["state"].items():
        for key, value in entries.items():
            other = sb["state"].get(index, {}).get(key)
            if other is None or not torch.equal(value, other):
                diffs.append(f"state {index} {key}")
    if a.step != b.step:
        diffs.append(f"step {a.step} vs {b.step}")
    return diffs


def _max_abs_diff(a, b) -> float:
    """Largest difference over the parameters and Adam moments."""
    worst = 0.0
    for (_, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    sb = b.optimizer.state_dict()["state"]
    for index, entries in a.optimizer.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            worst = max(worst, float(
                (entries[key] - sb[index][key]).abs().max()))
    return worst


def host_ms(fn, iters: int = 10, rounds: int = 3) -> float:
    """Host clock per call of fn(), over iters calls ending in a
    synchronize, best of rounds (the host's pace, where it sets it)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def phase_checkpoint():
    """Train -> save -> resume -> register -> serve -> .ckpt -> export, on
    ViT-B/16 (17 classes, bf16, 224^2) with the CE defaults."""
    from visiontransformer_tpu_torch.ckpt.export import (
        export_serving,
        load_serving,
    )
    from visiontransformer_tpu_torch.ckpt.io import (
        get_latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from visiontransformer_tpu_torch.ckpt.torch_convert import (
        save_lightning_checkpoint,
    )
    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.models.registry import (
        resolve_model,
        vitseg_config,
    )
    from visiontransformer_tpu_torch.models.vitseg import vitseg_predict
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.train.trainer import Trainer

    cfg = vitseg_config("P16H768A12", num_classes=17,
                        compute_dtype="bfloat16")
    tcfg = CE_TRAIN_DEFAULTS
    layers, accum = cfg.vit.num_hidden_layers, tcfg.accumulate_grad_batches
    reset, read = _train_launches()
    gen = torch.Generator(device="cuda").manual_seed(7)
    failures = []
    path_launches = {}
    seconds, marks = {}, [time.perf_counter()]

    def lap(step: str):
        """Host seconds of a step of the phase, since the last lap."""
        marks.append(time.perf_counter())
        seconds[step] = marks[-1] - marks[-2]

    def take(on_path: bool = True):
        """Launches of kernels 1-5 since the last take(), added to the
        path's unless they were timing runs; the counts start again from
        0."""
        got = {**read(), "upsample_argmax": _launches("upsample_argmax")}
        reset()
        for k, v in got.items():
            path_launches[k] = path_launches.get(k, 0) + v * on_path
        return got
    result = {"config": "P16H768A12", "classes": 17, "dtype": "bfloat16",
              "batch": tcfg.batch_size, "accumulate": accum,
              "dropout": [cfg.vit.hidden_dropout_prob,
                          cfg.vit.attention_probs_dropout_prob]}

    def trainer():
        return Trainer(cfg, tcfg, device="cuda")

    with tempfile.TemporaryDirectory() as tmp:
        data = _synthetic_ce_set(f"{tmp}/data", 2 * tcfg.batch_size)
        ckpt_dir = f"{tmp}/ckpts"
        take()
        path_launches.clear()
        # 1. One epoch with checkpoints; a fresh Trainer resumes from them.
        trained = trainer().fit(data, max_epochs=1, checkpoint_dir=ckpt_dir)
        path = get_latest_checkpoint(ckpt_dir)
        resumed = trainer().fit(data, resume_from=ckpt_dir, max_epochs=1)
        diffs = _model_diffs(trained, resumed)
        moments = [v for entries in trained.optimizer.state_dict()[
            "state"].values() for k, v in entries.items()
            if k.startswith("exp_avg")]
        nonzero = sum(bool(v.abs().sum()) for v in moments)
        result.update(checkpoint=os.path.basename(path), steps=trained.step,
                      restored_diffs=diffs, moments=len(moments),
                      moments_nonzero=nonzero,
                      lr=trained.optimizer.param_groups[0]["lr"])
        if diffs or nonzero != len(moments):
            raise AssertionError(f"restored state differs from the saved "
                                 f"one: {diffs}; {nonzero} of "
                                 f"{len(moments)} moments non-zero")
        del resumed
        lap("train_resume")

        # 2. A resumed second epoch against two uninterrupted epochs.
        take()
        continued = trainer().fit(data, resume_from=ckpt_dir, max_epochs=2)
        resumed_launches = take()
        whole = trainer().fit(data, max_epochs=2)
        cont_diffs = _model_diffs(continued, whole)
        result["continuity"] = {
            "steps": [continued.step, whole.step],
            "bitwise_equal": not cont_diffs, "differing": len(cont_diffs),
            "first_differing": cont_diffs[:4],
            "max_abs_diff": _max_abs_diff(continued, whole),
            "resumed_epoch_launches": resumed_launches,
            "per_step": layers * accum}
        per_epoch = layers * accum * (continued.step - trained.step)
        if any(resumed_launches[k] != per_epoch for k in (
                "flash_attention_fwd_train", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")):
            failures.append(f"resumed epoch launches {resumed_launches}, "
                            f"expected {per_epoch} of kernels 2-4")
        # Bit for bit: kernels 2-4 sum in a fixed order (no atomics), and
        # cuBLAS and cuDNN repeat their order at one shape on one card
        # (measured equal on an H100, PERF.md), so the restored step,
        # moments, learning rate and the epoch-seeded shuffle leave
        # nothing to differ.
        if cont_diffs:
            failures.append(f"resumed run differs from the uninterrupted "
                            f"one: {result['continuity']}")
        del continued, whole
        lap("continuity")

        # 3. The checkpoint registered and served over HTTP.
        model = trained.model.eval()
        pngs = _job_pngs(8, seed=1)
        x8 = torch.from_numpy(np.stack([_decoded(p) for p in pngs])).to(
            "cuda").float() / 255.0
        with torch.inference_mode():
            want = vitseg_predict(model, x8, mask_dtype=torch.uint8)
        want_np = want.cpu().numpy()
        store = JobStore(":memory:", media_root=f"{tmp}/media")
        model_id = store.register_model("vit-b16-trained", num_classes=17,
                                        config_name="P16H768A12",
                                        checkpoint_path=path)
        with _http_server(store, (8,)) as (client, csrf, startup_s):
            take()
            jobs, done, elapsed = _run_jobs(client, csrf, model_id, pngs)
            got = take()
            served_launches = (got["flash_attention_fwd"],
                               got["upsample_argmax"])
            served = _served_masks(client, jobs, done)
        served_equal = sum(int(np.array_equal(a, b))
                           for a, b in zip(served, want_np))
        result["serving"] = {"jobs": len(pngs), "masks_equal": served_equal,
                             "launches": served_launches,
                             "startup_s": startup_s, "seconds": elapsed}
        if served_equal != len(pngs):
            failures.append(f"{len(pngs) - served_equal} served masks differ "
                            f"from the trained model's")
        if (served_launches[1] < 1
                or served_launches[0] != layers * served_launches[1]):
            failures.append(f"serving launches {served_launches}")
        lap("serving")

        # 4. The reference .ckpt round trip.
        lightning = f"{tmp}/trained.ckpt"
        save_lightning_checkpoint(lightning, model.state_dict(), cfg,
                                  epoch=0, global_step=trained.step)
        _, from_ckpt = resolve_model("vitseg", "P16H768A12", num_classes=17,
                                     checkpoint_path=lightning, device="cuda")
        with torch.inference_mode():
            got = vitseg_predict(from_ckpt, x8, mask_dtype=torch.uint8)
        result["lightning_masks_equal"] = bool(torch.equal(got, want))
        if not result["lightning_masks_equal"]:
            failures.append("masks of the .ckpt round trip differ")
        del from_ckpt
        lap("lightning")

        # 5. The exported serving program at batch 8 and 32, beside the
        # eager forward: one device_ms reading (one call: two forwards hold
        # more launches than the device's queue, so the host could not
        # queue them ahead) and one host_ms reading each.
        x32 = torch.rand(32, 224, 224, 3, generator=gen, device="cuda")
        result["export"], times = {}, {}
        for batch, x in ((8, x8), (32, x32)):
            art_path = f"{tmp}/serving_b{batch}.pt2"
            t0 = time.perf_counter()
            export_serving(model, cfg, out_path=art_path, batch_size=batch)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            art = load_serving(art_path)
            load_s = time.perf_counter() - t0
            targets = [str(n.target) for n in art.program.graph.nodes
                       if n.op == "call_function"]
            nodes = (targets.count("vt.flash_attention_fwd.default"),
                     targets.count("vt.upsample_argmax.default"))
            # Neither kernel's plain version (softmax, argmax) is traced.
            plain = [t for t in targets if t.startswith("aten.")
                     and ("softmax" in t or "argmax" in t)]
            take()
            got = art.call(x)
            torch.cuda.synchronize()
            counts = take()
            call_launches = (counts["flash_attention_fwd"],
                             counts["upsample_argmax"])

            def eager(x=x):
                with torch.inference_mode():
                    return vitseg_predict(model, x, mask_dtype=torch.uint8)

            row = {"graph_op_nodes": nodes, "plain_nodes": plain,
                   "launches_per_call": call_launches,
                   "masks_equal_eager": bool(torch.equal(got, eager())),
                   "bytes": os.path.getsize(art_path),
                   "export_s": export_s, "load_s": load_s}
            if (nodes != (layers, 1) or plain or call_launches != (layers, 1)
                    or not row["masks_equal_eager"]):
                failures.append(f"exported program at batch {batch}: {row}")
            result["export"][batch] = row
            take()
            times[f"export_batch{batch}"] = {
                "artifact_ms": device_ms(lambda: art.call(x), iters=1),
                "eager_ms": device_ms(eager, iters=1),
                "artifact_host_ms": host_ms(lambda: art.call(x)),
                "eager_host_ms": host_ms(eager)}
            take(on_path=False)
            del art
        lap("export")

        # 6. Save and restore times, checkpoint bytes.
        tree = {"params": model.state_dict(),
                "opt_state": trained.optimizer.state_dict(),
                "step": trained.step}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = save_checkpoint(f"{tmp}/timed", tree, epoch=0,
                                step=trained.step)
        save_s = time.perf_counter() - t0
        fresh = trainer().init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(timed, {"params": fresh.model.state_dict(),
                                   "opt_state": fresh.optimizer, "step": 0})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if _model_diffs(trained, fresh) != [f"step {trained.step} vs 0"]:
            failures.append("timed restore differs from the saved state")
        times["save"] = {"seconds": save_s, "restore_seconds": restore_s,
                         "bytes": os.path.getsize(os.path.join(
                             timed, "checkpoint.pt"))}
        del fresh, trained, model
        lap("save")
    result.update(path_launches=dict(path_launches), seconds=seconds)
    emit("checkpoint", **result)
    emit("checkpoint_times", **times)
    missing = [k for k, v in path_launches.items() if not v]
    if missing:
        failures.append(f"kernels not launched on the path: {missing}")
    result.update(times)
    if failures:
        raise AssertionError(f"checkpoint phase: {failures}")
    return result


# EDT on the card (phase 11): against scipy at the TPU package's own
# tolerances (tests/test_edt.py:19,39); a mask without foreground and one
# without background, where the port saturates at _BIG as the TPU package
# does and scipy does not, against the port's CPU result, which equals the
# TPU package's bit for bit (tests/test_torch_paed.py), so within the same
# 1e-6 on the card.
EDT_ATOL = 1e-4
SDF_ATOL = 1e-5
EDT_CPU_ATOL = 1e-6
EDT_SIZES = (224, 512)
# Phase 12: configs whose sweep CSV and confusion are held against the
# direct forward, one per token count (197, 785, 3137).
SWEEP_MASK_CHECKS = ("P16H768A12", "P8H512A8", "P4H1024A16")


def _crack_set(root: str, n_samples: int, size: int):
    """The port's copy of generate_binary at size^2, as a PAED dataset."""
    from visiontransformer_tpu_torch.data import PAEDBinaryDataset
    from visiontransformer_tpu_torch.data.synthetic import generate_binary

    generate_binary(root, n_samples=n_samples, image_size=size)
    return PAEDBinaryDataset(f"{root}/image_png", f"{root}/mask_png",
                             image_size=size, cache=True)


def _edt_on_card(tmp: str):
    """compute_sdf_batch on the card at (4, size, size) crack masks: the
    EDTs and SDFs against scipy, the degenerate masks against the CPU,
    device ms and the peak memory above what was allocated before."""
    from scipy import ndimage

    from visiontransformer_tpu_torch.losses.sdf import compute_sdf_batch
    from visiontransformer_tpu_torch.ops.edt import edt

    rows, failures = {}, []
    for size in EDT_SIZES:
        data = _crack_set(f"{tmp}/edt{size}", 4, size)
        masks_np = np.stack([data[i][1] for i in range(4)]) > 0.5
        masks = torch.from_numpy(masks_np).to("cuda")
        edt_err = sdf_err = 0.0
        sdfs = [t.cpu().numpy() for t in compute_sdf_batch(masks)]
        for m, got, sdf in ((~masks, edt(~masks), sdfs[0]),
                            (masks, edt(masks), sdfs[1])):
            for i in range(4):
                want = ndimage.distance_transform_edt(m[i].cpu().numpy())
                edt_err = max(edt_err, float(np.abs(
                    got[i].cpu().numpy() - want).max()))
                want = want.astype(np.float32)
                want = want / want.max() if want.max() > 0 else want
                sdf_err = max(sdf_err, float(np.abs(sdf[i] - want).max()))
        flat = torch.stack([torch.zeros(size, size, dtype=torch.bool),
                            torch.ones(size, size, dtype=torch.bool)])
        cpu_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            (*compute_sdf_batch(flat.to("cuda")), edt(flat.to("cuda"))),
            (*compute_sdf_batch(flat), edt(flat))))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        compute_sdf_batch(masks)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        rows[size] = {"shape": [4, size, size], "edt_max_abs_err": edt_err,
                      "sdf_max_abs_err": sdf_err,
                      "degenerate_vs_cpu_max_abs_err": cpu_err,
                      "foreground_share": float(masks_np.mean()),
                      "ms": device_ms(lambda: compute_sdf_batch(masks)),
                      "peak_bytes": peak}
        if edt_err > EDT_ATOL or sdf_err > SDF_ATOL or cpu_err > EDT_CPU_ATOL:
            failures.append(f"EDT at {size}^2: {rows[size]}")
    return rows, failures


def phase_paed(tmp: str):
    """Phase 11: the binary crack task (paed_binary) on ViT-B/16 with
    PAED_TRAIN_DEFAULTS, bf16, 224^2. Returns (result, what phase 12
    evaluates: the trained model, its checkpoint root and the data)."""
    import csv

    from visiontransformer_tpu_torch.configs import (
        CE_TRAIN_DEFAULTS,
        PAED_TRAIN_DEFAULTS,
    )
    from visiontransformer_tpu_torch.data.pipeline import batch_iterator
    from visiontransformer_tpu_torch.models.registry import vitseg_config
    from visiontransformer_tpu_torch.train.trainer import Trainer
    from visiontransformer_tpu_torch.utils.csvlog import CSVLogger

    cfg = vitseg_config("P16H768A12", num_classes=1, input_size=224,
                        compute_dtype="bfloat16")
    ce_cfg = vitseg_config("P16H768A12", num_classes=17, input_size=224,
                           compute_dtype="bfloat16")
    tcfg = dataclasses.replace(PAED_TRAIN_DEFAULTS, max_epochs=2,
                               log_every_n_steps=1)
    layers, accum = cfg.vit.num_hidden_layers, tcfg.accumulate_grad_batches
    per_step = layers * accum
    reset, read = _train_launches()
    seconds, marks = {}, [time.perf_counter()]

    def lap(step: str):
        marks.append(time.perf_counter())
        seconds[step] = marks[-1] - marks[-2]

    result = {"config": "P16H768A12", "classes": 1, "dtype": "bfloat16",
              "batch": tcfg.batch_size, "accumulate": accum,
              "optimizer": tcfg.optimizer, "lr": tcfg.learning_rate,
              "dropout": [cfg.vit.hidden_dropout_prob,
                          cfg.vit.attention_probs_dropout_prob]}
    result["edt"], failures = _edt_on_card(tmp)
    lap("edt")

    # 1. Trainer.fit: two epochs of two steps, validation, checkpoints.
    data = _crack_set(f"{tmp}/cracks", 2 * tcfg.batch_size, 224)
    ckpt_root = f"{tmp}/paed_ckpts"
    trainer = Trainer(cfg, tcfg, task="paed_binary", device="cuda",
                      logger=CSVLogger(f"{tmp}/paed_logs"))
    epochs = []
    reset()
    state = trainer.fit(data, val_dataset=data,
                        checkpoint_dir=f"{ckpt_root}/P16H768A12",
                        on_epoch_end=lambda epoch, m: epochs.append(m))
    torch.cuda.synchronize()
    path_launches = {**read(), "upsample_argmax": _launches("upsample_argmax")}
    with open(trainer.logger.path) as f:
        losses = [float(r["train_loss_step"]) for r in csv.DictReader(f)
                  if r["train_loss_step"]]
    val_batches = len(data) // tcfg.batch_size
    want = {"flash_attention_fwd": layers * val_batches * len(epochs),
            "flash_attention_fwd_train": per_step * state.step,
            "flash_attention_bwd_dq": per_step * state.step,
            "flash_attention_bwd_dkv": per_step * state.step,
            "upsample_argmax": 0}
    monitors = (tcfg.plateau_monitor, tcfg.early_stopping_monitor)
    result["fit"] = {
        "steps": state.step, "losses": losses, "launches": path_launches,
        "expected_launches": want, "monitors": monitors,
        "epochs": [{k: v for k, v in m.items()
                    if k.startswith(("val_", "valid_")) or k == "train_loss"}
                   for m in epochs],
        "checkpoints": sorted(os.listdir(f"{ckpt_root}/P16H768A12"))}
    if (state.step != 4 or path_launches != want or len(losses) != 4
            or not all(np.isfinite(x) for x in losses)
            or len(result["fit"]["checkpoints"]) != 2
            or any(not all(k in m for k in monitors)
                   or any(k.startswith("valid_") for k in m)
                   for m in epochs)):
        failures.append(f"paed_binary fit: {result['fit']}")
    lap("fit")

    # 2. images/s and step seconds of a paed_binary step beside a CE step,
    # in turns in this process, on batches already on the card (fresh
    # states: the trained one is phase 12's reference).
    rng = np.random.default_rng(2)
    ce_trainer = Trainer(ce_cfg, CE_TRAIN_DEFAULTS, device="cuda")
    ce_state = ce_trainer.init_state()
    on_card = lambda b: {k: torch.from_numpy(v).to("cuda")
                         for k, v in b.items()}
    paed_batches = [on_card(b) for b in batch_iterator(
        data, tcfg.batch_size, shuffle=True, seed=1)]
    ce_batches = [on_card({
        "image": rng.random((tcfg.batch_size, 224, 224, 3), np.float32),
        "mask": rng.integers(0, 17, (tcfg.batch_size, 256, 256),
                             dtype=np.int32)}) for _ in range(2)]
    steps = {"paed_binary": _train_step_fn(trainer, trainer.init_state(),
                                           paed_batches),
             "ce": _train_step_fn(ce_trainer, ce_state, ce_batches)}
    timing = {name: {"batch": tcfg.batch_size, "accumulate": accum,
                     "steps_per_s": 0.0} for name in steps}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        reset()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        timing[name].update(launches_per_step=read(), peak_mem_gb=(
            torch.cuda.max_memory_allocated() / 1e9))
    for _ in range(3):
        for name, step in steps.items():
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            timing[name]["steps_per_s"] = max(
                timing[name]["steps_per_s"], 3 / (time.perf_counter() - t0))
    for name, step in steps.items():
        row = timing[name]
        row.update(images_per_s=row["steps_per_s"] * tcfg.batch_size,
                   step_s=1.0 / row["steps_per_s"],
                   profile=profile_steps(step, tcfg.batch_size, steps=1))
        if row["launches_per_step"] != {
                "flash_attention_fwd": 0, "flash_attention_fwd_train":
                per_step, "flash_attention_bwd_dq": per_step,
                "flash_attention_bwd_dkv": per_step}:
            failures.append(f"{name} step launches {row}")
    result["throughput"] = timing
    del ce_trainer, ce_state, steps, paed_batches, ce_batches
    lap("throughput")

    # 3. One fp32 paed_binary step, dropout off, kernels vs eager attention.
    batch = next(batch_iterator(data, tcfg.batch_size))
    fp32 = vitseg_config("P16H768A12", num_classes=1, input_size=224,
                         compute_dtype="float32")
    result["fp32_step"] = _fp32_step_vs_eager(fp32, PAED_TRAIN_DEFAULTS,
                                              "paed_binary", batch,
                                              "paed_fp32_step")
    lap("fp32_step")

    # 4. One bf16 step of each multiclass PAED task on the CE set.
    ce_data = _synthetic_ce_set(f"{tmp}/paed_ce", tcfg.batch_size)
    batch = next(batch_iterator(ce_data, tcfg.batch_size))
    result["multiclass_steps"] = {}
    for task in ("paed_multiclass", "paed_anchored"):
        task_trainer = Trainer(ce_cfg, dataclasses.replace(
            CE_TRAIN_DEFAULTS, learning_rate=1e-4), task=task, device="cuda")
        task_state = task_trainer.init_state()
        reset()
        _, metrics = task_trainer.train_step(task_state, batch, seed=0)
        row = {"metrics": {k: float(v) for k, v in metrics.items()},
               "launches": read()}
        result["multiclass_steps"][task] = row
        if (not all(np.isfinite(v) for v in row["metrics"].values())
                or row["launches"]["flash_attention_fwd"]
                or any(row["launches"][k] != per_step for k in (
                    "flash_attention_fwd_train", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv"))):
            failures.append(f"{task} step: {row}")
        del task_trainer, task_state
    lap("multiclass_steps")
    result.update(path_launches=path_launches, seconds=seconds)
    emit("paed", **result)
    missing = [k for k in ("flash_attention_fwd_train",
                           "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
               if not path_launches[k]]
    if missing:
        failures.append(f"kernels not launched on the path: {missing}")
    if failures:
        raise AssertionError(f"paed phase: {failures}")
    return result, {"model": state.model, "ckpt_root": ckpt_root,
                    "data": f"{tmp}/cracks"}


def phase_eval_sweep(tmp: str, trained):
    """Phase 12: the eval-sweep command over the 9 sweep configs (CE, 17
    classes, seeded weights) and over phase 11's checkpoint (paed_binary),
    at 224^2, batch 4, 2 batches."""
    import csv

    from visiontransformer_tpu_torch.cli import main as cli_main
    from visiontransformer_tpu_torch.configs import SWEEP_CONFIGS, sweep_by_name
    from visiontransformer_tpu_torch.data import PAEDBinaryDataset
    from visiontransformer_tpu_torch.data.pipeline import batch_iterator
    from visiontransformer_tpu_torch.evaluation.evaluate import (
        CSV_HEADER,
        sweep_model,
    )
    from visiontransformer_tpu_torch.models.vitseg import vitseg_apply
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        forward_path,
    )
    from visiontransformer_tpu_torch.ops.resize import resize_nearest_pil

    reset, read = _train_launches()
    batch, batches = 4, 2
    n_images = batch * batches
    failures, path_launches, configs = [], {}, {}
    seconds, marks = {}, [time.perf_counter()]

    def lap(step: str):
        marks.append(time.perf_counter())
        seconds[step] = marks[-1] - marks[-2]

    # Kernel 1 against its plain version at the shapes the sweep gives it,
    # (batch, heads, N, 64) bf16 strided views of a fused QKV, as the model
    # passes them; device ms beside SDPA's. Outside the counted sweeps.
    gen = torch.Generator(device="cuda").manual_seed(12)
    kernel1 = {}
    for heads, n in sorted({(e.attention_heads,
                             (224 // e.patch_size) ** 2 + 1)
                            for e in SWEEP_CONFIGS}):
        qkv = torch.randn(batch, n, 3, heads, 64, generator=gen,
                          device="cuda").to(torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        ok, fields = flash_agrees(flash_attention(q, k, v),
                                  flash_attention_plain(q, k, v))
        fields.update(ok=ok, path=forward_path(n, 64, torch.bfloat16),
                      ms=device_ms(lambda: flash_attention(q, k, v)),
                      sdpa_ms=device_ms(
                          lambda: F.scaled_dot_product_attention(q, k, v)))
        kernel1[f"{batch}x{heads}x{n}x64"] = fields
        if not ok:
            failures.append(f"kernel 1 at {[batch, heads, n, 64]}: {fields}")
    lap("kernel1_checks")

    def sweep(args):
        """One eval-sweep command; (CSV rows, confusion, launches, s)."""
        reset()
        t0 = time.perf_counter()
        if cli_main(["eval-sweep", "--batch-size", str(batch),
                     "--num-batches", str(batches), "--no-split",
                     "--image-size", "224", "--device", "cuda", *args]) != 0:
            raise AssertionError(f"eval-sweep {args} returned non-zero")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {**read(), "upsample_argmax": _launches("upsample_argmax")}
        for k, v in launches.items():
            path_launches[k] = path_launches.get(k, 0) + v
        name = args[args.index("--configs") + 1]
        out = args[args.index("--out") + 1]
        with open(f"{out}/{name}/{name}_metrics.csv", newline="") as f:
            rows = list(csv.reader(f))
        confusion = np.load(f"{out}/{name}/{name}_pixel_confusion.npy")
        return rows, confusion, launches, elapsed

    def expected(layers: int):
        """A sweep's launches: kernel 1 once a layer a batch, no other."""
        return {"flash_attention_fwd": layers * batches,
                "flash_attention_fwd_train": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0, "upsample_argmax": 0}

    def direct(model, data, binary: bool):
        """The command's 8 images, in its batches, through ``model``
        called directly: per image the accuracy (%) and the predicted
        classes as the CSV writes them, and the pixel confusion, counted
        with numpy from the masks."""
        k = 2 if binary else data.num_classes
        accuracy, classes, confusion = [], [], np.zeros((k, k), np.int64)
        for _, b in zip(range(batches), batch_iterator(data, batch,
                                                       drop_last=False)):
            with torch.no_grad():
                logits = vitseg_apply(model, torch.from_numpy(
                    b["image"]).to("cuda"))
            pred = (torch.sigmoid(logits[..., 0]) > 0.5 if binary
                    else torch.argmax(logits, dim=-1)).int().cpu().numpy()
            gt = resize_nearest_pil(torch.from_numpy(b["mask"]),
                                    (224, 224)).int().numpy()
            accuracy += (100.0 * (gt == pred).mean(axis=(1, 2))).tolist()
            classes += ["|".join(map(str, np.unique(m).tolist()))
                        for m in pred]
            confusion += np.bincount((gt * k + pred).ravel(),
                                     minlength=k * k).reshape(k, k)
        return accuracy, classes, confusion

    def against_direct(rows, confusion, want):
        """The command's CSV and confusion .npy against ``direct``'s."""
        accuracy, classes, want_confusion = want
        col_acc = CSV_HEADER.index("Accuracy")
        col_pred = CSV_HEADER.index("Pred_Classes")
        return {"confusion_equal_direct": bool(np.array_equal(
                    confusion, want_confusion)),
                "accuracy_max_abs_err": max(
                    abs(float(r[col_acc]) - a)
                    for r, a in zip(rows[1:], accuracy)),
                "pred_classes_equal_direct": [
                    r[col_pred] for r in rows[1:]] == classes}

    def agrees(row) -> bool:
        return (row["confusion_equal_direct"]
                and row["accuracy_max_abs_err"] < 1e-3
                and row["pred_classes_equal_direct"])

    # 16 images, so that their masks hold all 17 classes most likely (the
    # command counts the classes the data holds); 8 of them are evaluated.
    ce_root = f"{tmp}/sweep_ce"
    ce_data = _synthetic_ce_set(ce_root, 16)
    time_col = CSV_HEADER.index("Inference_Time")
    for entry in SWEEP_CONFIGS:
        rows, confusion, launches, elapsed = sweep(
            ["--data", ce_root, "--configs", entry.name,
             "--out", f"{tmp}/sweep_out"])
        times = [float(r[time_col]) for r in rows[1:]]
        row = {"tokens": (224 // entry.patch_size) ** 2 + 1,
               "layers": entry.hidden_layers, "heads": entry.attention_heads,
               "rows": len(rows) - 1, "launches": launches,
               "command_s": elapsed,
               "images_per_s": n_images / sum(times),
               "images_per_s_batch2": batch / sum(times[batch:]),
               "confusion_sum": int(confusion.sum())}
        if (rows[0] != CSV_HEADER or len(rows) != 1 + n_images
                or launches != expected(entry.hidden_layers)
                or confusion.sum() != n_images * 224 * 224):
            failures.append(f"sweep {entry.name}: {row}")
        if entry.name in SWEEP_MASK_CHECKS:
            # The same seeded weights, built outside the command.
            _, model = sweep_model(entry, num_classes=ce_data.num_classes,
                                   image_size=224, device="cuda")
            row.update(against_direct(rows, confusion,
                                      direct(model, ce_data, False)))
            if not agrees(row):
                failures.append(f"sweep {entry.name} masks: {row}")
            del model
        configs[entry.name] = row
    lap("ce_sweep")

    # The crack model of phase 11, restored from its checkpoint.
    out = f"{tmp}/sweep_binary"
    rows, confusion, launches, elapsed = sweep(
        ["--task", "paed_binary", "--data", trained["data"], "--ckpt-root",
         trained["ckpt_root"], "--configs", "P16H768A12", "--out", out])
    # The command's CSV and confusion against the trained in-memory
    # model's sigmoid > 0.5 masks over the same 8 images.
    crack_data = PAEDBinaryDataset(f"{trained['data']}/image_png",
                                   f"{trained['data']}/mask_png",
                                   image_size=224)
    binary = {"rows": len(rows) - 1, "launches": launches,
              "command_s": elapsed, "confusion": confusion.tolist(),
              **against_direct(rows, confusion,
                               direct(trained["model"], crack_data, True))}
    # Four steps leave the crack model predicting little or no crack, so
    # the masks alone could agree by being empty: the model the command
    # restores must also give the trained one's logits bit for bit.
    cfg, model = sweep_model(sweep_by_name("P16H768A12"), num_classes=1,
                             checkpoint_root=trained["ckpt_root"],
                             image_size=224, device="cuda")
    images = torch.from_numpy(next(batch_iterator(
        crack_data, batch))["image"]).to("cuda")
    with torch.no_grad():
        binary["logits_equal_trained"] = bool(torch.equal(
            vitseg_apply(model, images),
            vitseg_apply(trained["model"], images)))
    if (rows[0] != CSV_HEADER or len(rows) != 1 + n_images
            or launches != expected(cfg.vit.num_hidden_layers)
            or not agrees(binary) or not binary["logits_equal_trained"]
            or confusion.sum() != n_images * 224 * 224):
        failures.append(f"binary sweep: {binary}")
    del model
    lap("binary_sweep")
    result = {"batch": batch, "batches": batches,
              "classes": ce_data.num_classes, "kernel1": kernel1,
              "configs": configs,
              "binary": binary, "path_launches": path_launches,
              "seconds": seconds}
    emit("eval_sweep", **result)
    if not path_launches["flash_attention_fwd"]:
        failures.append("kernel 1 not launched on the sweep")
    if failures:
        raise AssertionError(f"eval_sweep phase: {failures}")
    return result


# ------------------------------------------------- phase 13: the opt-ins
OPTIN_RS = (8, 16)
# The fused forward against the unfused one on the same raw images, fp32:
# the JAX package's bar (tests/test_fused_preproc.py:94-95).
FUSED_MIN_AGREEMENT = 0.999


def _merged_lengths(n: int, r: int, layers: int) -> list:
    """The token count each encoder layer runs at under ToMe merging
    (ops/token_merge.py: r_eff = min(r, sources - 1) after each layer)."""
    out = []
    for _ in range(layers):
        out.append(n)
        sources = n // 2  # (body + 1) // 2 with body = n - 1
        n -= max(min(r, sources - 1), 0)
    return out


@contextlib.contextmanager
def _kernel1_lengths():
    """The sequence length of every kernel-1 call the model makes, through
    a pass-through wrapper around ops/attention.py's flash_attention (the
    launches are still counted by the kernel's own wrapper only)."""
    from visiontransformer_tpu_torch.ops import attention

    seen, original = [], attention.flash_attention

    def spy(q, k, v, **kwargs):
        seen.append(q.shape[2])
        return original(q, k, v, **kwargs)

    attention.flash_attention = spy
    try:
        yield seen
    finally:
        attention.flash_attention = original


@contextlib.contextmanager
def _merge_calls():
    """Every merge_step call the model makes, as (tokens, state, r, the new
    assign), through a pass-through wrapper around models/vit.py's name."""
    from visiontransformer_tpu_torch.models import vit

    calls, original = [], vit.merge_step

    def spy(x, state, r):
        x_new, new = original(x, state, r)
        calls.append((x, state, r, new.assign))
        return x_new, new

    vit.merge_step = spy
    try:
        yield calls
    finally:
        vit.merge_step = original


def _assign_agreement(calls) -> dict:
    """Share of equal ``assign`` entries between each merge_step the card
    ran and the same call (same tokens and state) on the CPU, per layer:
    near-ties of the bf16 similarity may rank differently on the two."""
    from visiontransformer_tpu_torch.ops.token_merge import (
        MergeState,
        merge_step,
    )

    shares = []
    for x, state, r, assign in calls:
        _, cpu = merge_step(x.cpu(), MergeState(*(t.cpu() for t in state)),
                            r)
        shares.append(float((cpu.assign == assign.cpu()).float().mean()))
    return {"shape": list(calls[0][0].shape), "dtype": str(
        calls[0][0].dtype)[6:], "per_layer": shares, "min": min(shares),
        "layers_equal": sum(share == 1.0 for share in shares)}


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms(True) for the block: cuDNN and
    the other libraries take their deterministic algorithms; an op without
    one warns instead of raising, and the block yields those warnings."""
    import warnings

    before = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(before)


def _serve_timing(fns: dict, batch: int) -> dict:
    """masks/s (best of 3 rounds of 10 forwards ending in the masks'
    readback, the variants in turns, then in the reverse order), host ms
    (host_ms) and the profiler's device ms, busy share and device kernels
    of one forward, per variant."""
    rows = {name: {"masks_per_s": 0.0} for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fns[name]().cpu()
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(10):
                    out = fns[name]()
                out.cpu()
                rows[name]["masks_per_s"] = max(
                    rows[name]["masks_per_s"],
                    batch * 10 / (time.perf_counter() - t0))
    for name, fn in fns.items():
        prof = profile_steps(fn, batch, steps=3, top=4)
        rows[name].update(
            host_ms=host_ms(fn, iters=10, rounds=3),
            device_ms=prof["device_ms_per_step"],
            device_busy_share=prof["device_busy_share"],
            device_kernels_per_forward=prof["device_kernels_per_step"],
            own_kernels_ms=prof["own_kernels_ms_per_step"])
    return rows


def phase_optin(gen):
    """Phase 13: ToMe token merging, W8A8 int8, the fused preprocessing, a
    served opt-in row, and training with merging and with remat, on
    ViT-B/16 (17 classes, bf16, seeded weights)."""
    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.models.registry import (
        resolve_model,
        vitseg_config,
    )
    from visiontransformer_tpu_torch.models.vitseg import (
        set_token_merge_r,
        vitseg_apply,
        vitseg_build_fused_preproc,
        vitseg_predict,
        vitseg_predict_fused,
    )
    from visiontransformer_tpu_torch.nn.layers import (
        int8_matmul,
        int8_matmul_plain,
        quantize_per_token,
    )
    from visiontransformer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        forward_path,
    )
    from visiontransformer_tpu_torch.ops.quant import (
        QUANTIZED_LAYER_KEYS,
        quantize_vitseg,
    )
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import ModelRunner
    from visiontransformer_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    batch, size, compute = 32, 512, 224
    cfg, model = resolve_model("vitseg", "P16H768A12", num_classes=17,
                               input_size=compute, compute_dtype="bfloat16",
                               device="cuda")
    layers, heads = cfg.vit.num_hidden_layers, cfg.vit.num_attention_heads
    n0 = cfg.vit.seq_len
    lengths = {r: _merged_lengths(n0, r, layers) for r in OPTIN_RS}
    merged_ns = sorted({n for ns in lengths.values() for n in ns})
    reset, read = _train_launches()
    path_launches = {}

    def take(on_path: bool = True):
        """Launches of kernels 1-5 since the last take(), added to the
        path's unless they were comparisons or timing runs."""
        got = {**read(), "upsample_argmax": _launches("upsample_argmax")}
        reset()
        for k, v in got.items():
            path_launches[k] = path_launches.get(k, 0) + v * on_path
        return got

    def forward_launches(got, what):
        if (got["flash_attention_fwd"], got["upsample_argmax"]) != (
                layers, 1) or any(got[k] for k in got if k not in (
                    "flash_attention_fwd", "upsample_argmax")):
            raise AssertionError(f"{what}: launches {got}, expected "
                                 f"{layers} of kernel 1 and 1 of kernel 5")

    mean = torch.tensor(MEAN, device="cuda")
    std = torch.tensor(STD, device="cuda")
    raw = torch.rand(batch, size, size, 3, generator=gen, device="cuda")
    raw_u8 = torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)

    def serve(m, images=raw):
        x = (resize_bilinear_mm(images, (compute, compute)) - mean) / std
        return vitseg_predict(m, x, out_size=(size, size),
                              mask_dtype=torch.uint8)

    result = {"config": "P16H768A12", "classes": 17, "dtype": "bfloat16",
              "batch": batch, "in": size, "compute": compute,
              "kernel1_lengths": lengths}
    qmodel = quantize_vitseg(model)
    with torch.inference_mode():
        # 1. Kernel 1 at every merged length against its plain version.
        take(False)
        rows = []
        for n in merged_ns:
            q, k, v = (torch.randn(batch, heads, n, 64, generator=gen,
                                   device="cuda", dtype=torch.bfloat16)
                       for _ in range(3))
            ok, fields = flash_agrees(flash_attention(q, k, v),
                                      flash_attention_plain(q, k, v))
            rows.append({"n": n, "path": forward_path(n, 64, torch.bfloat16),
                         **fields})
            if not ok:
                raise AssertionError(f"kernel 1 at the merged shape "
                                     f"({batch * heads}, {n}, 64): {fields}")
        result["flash_merged"] = {
            "shapes": [[batch * heads, r["n"], 64] for r in rows],
            "paths": sorted({r["path"] for r in rows}),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err_norm": max(r["rel_err_norm"] for r in rows)}
        take(False)

        # 2. The merged forwards: kernel 1 at the 12 lengths, kernel 5
        # once; r = 0 again after merging gives the plain masks.
        masks, assign = {}, {}
        for r in (0, *OPTIN_RS, 0):
            set_token_merge_r(model, r)
            with _kernel1_lengths() as seen, _merge_calls() as merges:
                got = serve(model)
            forward_launches(take(), f"r = {r}")
            if r:
                # The card's merge choices against the CPU's, same inputs.
                assign[r] = _assign_agreement(merges)
            if seen != lengths.get(r, [n0] * layers):
                raise AssertionError(f"r = {r}: kernel 1 ran at N = {seen}")
            if r in masks and not torch.equal(got, masks[r]):
                raise AssertionError("r = 0 after merging differs from the "
                                     "plain forward's masks")
            masks[r] = got
        for r in OPTIN_RS:
            result[f"r{r}"] = {"agreement_vs_r0": float(
                (masks[r] == masks[0]).float().mean()),
                "assign_vs_cpu": assign[r]}

        # 3. int8: the forward, then layer 0's four products at the
        # serving shape on the card against the plain int32 product on
        # the CPU, and the masks against the CPU's for one image.
        inputs = {}

        def keep_input(key):
            def hook(_module, args):
                inputs[key] = args[0]
            return hook

        hooks = [getattr(qmodel.backbone.layers[0], key)
                 .register_forward_pre_hook(keep_input(key))
                 for key in QUANTIZED_LAYER_KEYS]
        masks["int8"] = serve(qmodel)
        for hook in hooks:
            hook.remove()
        forward_launches(take(), "int8")
        products = {}
        for key in QUANTIZED_LAYER_KEYS:
            weight = getattr(qmodel.backbone.layers[0], key).kernel_q
            xq = quantize_per_token(inputs[key])[0].reshape(
                -1, weight.shape[0])
            acc = int8_matmul(xq, weight)
            t0 = time.perf_counter()
            want = int8_matmul_plain(xq.cpu(), weight.cpu())
            cpu_s = time.perf_counter() - t0
            xb = inputs[key].reshape(xq.shape)
            wb = getattr(model.backbone.layers[0], key).kernel.to(xb.dtype)
            products[key] = {
                "shape": [*xq.shape, weight.shape[1]],
                "equal": torch.equal(acc.cpu(), want),
                "max_abs_acc": int(want.abs().max()),
                "int_mm_ms": device_ms(lambda: int8_matmul(xq, weight)),
                "bf16_matmul_ms": device_ms(lambda: xb @ wb),
                "cpu_s": cpu_s}
            if not products[key]["equal"]:
                raise AssertionError(f"int8 product of layer 0 {key}: the "
                                     f"card's accumulators differ from the "
                                     f"CPU's")
        cpu_model = copy.deepcopy(qmodel).to("cpu")
        x_cpu = ((resize_bilinear_mm(raw[:1], (compute, compute)) - mean)
                 / std).cpu()
        t0 = time.perf_counter()
        cpu_masks = vitseg_predict(cpu_model, x_cpu, out_size=(size, size),
                                   mask_dtype=torch.uint8)
        del cpu_model
        result["int8"] = {
            "products": products,
            "agreement_vs_cpu": float(
                (masks["int8"][:1].cpu() == cpu_masks).float().mean()),
            "cpu_forward_s": time.perf_counter() - t0,
            "agreement_vs_bf16": float(
                (masks["int8"] == masks[0]).float().mean())}
        take(False)

        # 4. The fused preprocessing: fp32 compute against the unfused
        # forward on the same raw images, fp32 and uint8 forms; then bf16.
        fused = {}
        for dtype in ("float32", "bfloat16"):
            model.cfg = dataclasses.replace(model.cfg, compute_dtype=dtype)
            for form, images in (("float32", raw), ("uint8", raw_u8)):
                u8 = form == "uint8"
                consts = vitseg_build_fused_preproc(
                    model, in_size=size, mean=MEAN, std=STD,
                    input_scale=1.0 / 255.0 if u8 else 1.0)
                got = vitseg_predict_fused(model, consts, images,
                                           out_size=(size, size),
                                           mask_dtype=torch.uint8)
                forward_launches(take(), f"fused {dtype} {form}")
                unfused = serve(model, images.float() / 255.0 if u8
                                else images)
                take()
                agreement = float((got == unfused).float().mean())
                fused[f"{dtype}_{form}"] = agreement
                if dtype == "float32" and agreement < FUSED_MIN_AGREEMENT:
                    raise AssertionError(
                        f"fused forward ({form} input) agrees with the "
                        f"unfused one on {agreement:.5f} of the pixels, "
                        f"below {FUSED_MIN_AGREEMENT}")
        result["fused_agreement"] = fused

    # 5. A row registered with token_merge_r=16 and quantize="int8", served
    # over HTTP: every DONE mask equals ModelRunner.predict.
    pngs = _job_pngs(8, seed=3)
    with tempfile.TemporaryDirectory() as media:
        store = JobStore(":memory:", media_root=media)
        model_id = store.register_model(
            "vit-b16-tome16-int8", num_classes=17, config_name="P16H768A12",
            token_merge_r=16, quantize="int8")
        with _http_server(store, (8,)) as (client, csrf, _):
            jobs, done, elapsed = _run_jobs(client, csrf, model_id, pngs)
            served = _served_masks(client, jobs, done)
        serving = take()
        runner = ModelRunner(store.get_model(model_id), device="cuda",
                             buckets=(8,))
        equal = sum(int(np.array_equal(mask, runner.predict(
            _decoded(png)[None])[0])) for mask, png in zip(served, pngs))
        take(False)
        del runner
    result["serving"] = {"jobs": len(pngs), "masks_equal_runner": equal,
                         "jobs_per_s": len(pngs) / elapsed,
                         "launches": serving}
    # The opt-ins served through the runner's CUDA graphs.
    result["graphed"] = {
        name: graphed_runner_check("P16H768A12", buckets=(8, 32),
                                   row_extra=extra)["equal"]
        for name, extra in (("tome16", {"token_merge_r": 16}),
                            ("int8", {"quantize": "int8"}),
                            ("tome16_int8", {"token_merge_r": 16,
                                             "quantize": "int8"}))}
    take(False)
    if equal != len(pngs) or not serving["flash_attention_fwd"]:
        raise AssertionError(f"opt-in row served {equal} of {len(pngs)} "
                             f"masks equal to ModelRunner.predict, "
                             f"launches {serving}")

    # 6. Training, CE defaults (batch 16 as 4 x 4, dropout 0.1, bf16):
    # kernels 2-4 against their plain versions at every merged length of
    # the micro-batch, (4, 12, N, 64) without and with dropout; one step at
    # r = 16; then one step without and with remat from the same weights
    # and seed, under deterministic algorithms, equal bit for bit.
    tcfg = CE_TRAIN_DEFAULTS
    accum, per_step = tcfg.accumulate_grad_batches, (
        layers * tcfg.accumulate_grad_batches)
    take(False)
    rows = [check_train_kernels(gen, (tcfg.batch_size // accum, heads, n, 64),
                                torch.bfloat16, rate)[0]
            for n in merged_ns for rate in (0.0, 0.1)]
    take(False)
    keys = ("out", "lse", "dq", "dq_delta", "dk", "dv", "delta")
    result["flash_train_merged"] = {
        "shapes": [r["shape"] for r in rows[::2]], "rates": [0.0, 0.1],
        "paths": sorted({r["path"] for r in rows}),
        "max_abs_err": {k: max(r[k]["max_abs_err"] for r in rows)
                        for k in keys},
        "max_rel_err_norm": {k: max(r[k]["rel_err_norm"] for r in rows)
                             for k in keys if "rel_err_norm" in rows[0][k]}}
    rng = np.random.default_rng(0)
    tbatch = {"image": rng.random((tcfg.batch_size, compute, compute, 3),
                                  np.float32),
              "mask": rng.integers(0, 17, (tcfg.batch_size, 256, 256),
                                   dtype=np.int32)}
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_train": per_step,
            "flash_attention_bwd_dq": per_step,
            "flash_attention_bwd_dkv": per_step, "upsample_argmax": 0}
    train_cfg = vitseg_config("P16H768A12", num_classes=17,
                              input_size=compute, compute_dtype="bfloat16")
    trainer = Trainer(dataclasses.replace(train_cfg, vit=dataclasses.replace(
        train_cfg.vit, token_merge_r=16)), tcfg, device="cuda")
    state = trainer.init_state()
    _, metrics = trainer.train_step(state, tbatch, seed=0)
    merged_loss = float(metrics["loss"])
    launches = take()
    if launches != want or not np.isfinite(merged_loss):
        raise AssertionError(f"merged train step: loss {merged_loss}, "
                             f"launches {launches}, expected {want}")
    result["train_r16"] = {"loss": merged_loss, "launches": launches}
    del trainer, state

    def one_step(remat: bool):
        trainer = Trainer(train_cfg, dataclasses.replace(tcfg, remat=remat),
                          device="cuda")
        state = trainer.init_state()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, metrics = trainer.train_step(state, tbatch, seed=0)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - resident
        grads = {n: p.grad.clone() for n, p in
                 state.model.named_parameters()}
        # One more forward and backward, the whole batch as one
        # micro-batch, with an explicit generator: its state at the end,
        # and the peak memory above the weights, gradients and Adam state
        # (the step's own peak is the optimizer's, after the activations
        # are freed).
        g = torch.Generator(device="cuda").manual_seed(11)
        images = torch.from_numpy(tbatch["image"]).cuda()
        state.model.zero_grad(set_to_none=False)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vitseg_apply(state.model, images, deterministic=False,
                     generator=g).float().square().mean().backward()
        torch.cuda.synchronize()
        activation_peak = torch.cuda.max_memory_allocated() - resident
        extra = {n: p.grad.clone() for n, p in
                 state.model.named_parameters()}
        return {"loss": metrics["loss"], "grads": grads, "extra": extra,
                "gen_state": g.get_state(), "step_peak": step_peak,
                "activation_peak": activation_peak, "trainer": trainer,
                "state": state, "launches": take()}

    def same(a, b) -> list:
        """Names of what differs between two runs of one_step."""
        diff = [] if torch.equal(a["loss"], b["loss"]) else ["loss"]
        diff += [n for n in a["grads"]
                 if not torch.equal(a["grads"][n], b["grads"][n])]
        diff += [f"extra:{n}" for n in a["extra"]
                 if not torch.equal(a["extra"][n], b["extra"][n])]
        return diff + ([] if torch.equal(a["gen_state"], b["gen_state"])
                       else ["generator state"])

    with _deterministic() as caught:
        plain, again = one_step(False), one_step(False)
        remat = one_step(True)
    if same(plain, again):
        raise AssertionError(f"two plain steps differ under deterministic "
                             f"algorithms: {same(plain, again)[:5]}")
    differs = same(plain, remat)
    if differs:
        raise AssertionError(f"the remat step differs from the plain step: "
                             f"{differs[:5]}")
    # The step's micro-batches and the extra backward: kernels 3 and 4 once
    # a layer each, kernel 2 once a layer, twice under remat (recompute).
    once = per_step + layers
    want_plain = dict(want, flash_attention_fwd_train=once,
                      flash_attention_bwd_dq=once,
                      flash_attention_bwd_dkv=once)
    want_remat = dict(want_plain, flash_attention_fwd_train=2 * once)
    if (plain["launches"] != want_plain
            or remat["launches"] != want_remat):
        raise AssertionError(f"plain / remat step launches "
                             f"{plain['launches']} / {remat['launches']}, "
                             f"expected {want_plain} / {want_remat}")
    train = {"loss": float(plain["loss"]), "bit_for_bit": True,
             "deterministic_warnings": sorted({str(w.message)[:120]
                                               for w in caught})}
    for name, run in (("plain", plain), ("remat", remat)):
        step = _train_step_fn(run["trainer"], run["state"], [tbatch])
        prof = profile_steps(step, tcfg.batch_size, steps=2, top=4)
        train[name] = {"step_peak_bytes_above_resident": run["step_peak"],
                       "forward_backward_peak_bytes_batch16":
                           run["activation_peak"],
                       "device_ms": prof["device_ms_per_step"],
                       "wall_ms": prof["wall_ms_per_step"],
                       "launches": run["launches"]}
        take(False)
    result["train"] = train
    del plain, again, remat

    # 7. Speed of the serving variants, in turns in one process.
    with torch.inference_mode():
        set_token_merge_r(model, 0)
        consts = {form: vitseg_build_fused_preproc(
            model, in_size=size, mean=MEAN, std=STD,
            input_scale=1.0 / 255.0 if form == "uint8" else 1.0)
            for form in ("float32", "uint8")}

        def merged(r):
            def fn():
                set_token_merge_r(model, r)
                try:
                    return serve(model)
                finally:
                    set_token_merge_r(model, 0)
            return fn

        result["timing"] = _serve_timing({
            "exact": lambda: serve(model), "r8": merged(8),
            "r16": merged(16), "int8": lambda: serve(qmodel),
            "fused": lambda: vitseg_predict_fused(
                model, consts["float32"], raw, out_size=(size, size),
                mask_dtype=torch.uint8),
            "fused_uint8": lambda: vitseg_predict_fused(
                model, consts["uint8"], raw_u8, out_size=(size, size),
                mask_dtype=torch.uint8)}, batch)
        take(False)
    result.update(path_launches=dict(path_launches),
                  seconds=time.perf_counter() - t_phase)
    emit("optin", **result)
    missing = [k for k, v in path_launches.items() if not v]
    if missing:
        raise AssertionError(f"phase 13 never launched {missing}")
    model.to("cpu")
    return result


# Phase 14. The conv families: (family, encoder preset) checked on the card
# against the plain CPU forward of the same weights; every family at
# resnet34, unet at the other real presets.
CONV_OTHER_PRESETS = ("resnet18", "resnet50", "mobilenetv2", "efficientnet_b0")
CONV_CLASSES = 17
CONV_SIZE = 224
CONV_BATCH = 32          # the timed bf16 forwards
CONV_CHECK_BATCH = 2     # the card against the CPU
# fp32 logits, the card (TF32 off) against the CPU: the CPU parity tests'
# seg-logit atol (tests/conv_parity.py).
CONV_LOGITS_ATOL = 5e-5
CONV_TRAIN_STEPS = 5


def _kernel_launch_counts():
    """(reset, read) of the launch counts of kernels 1-9."""
    reset, read_train = _train_launches()
    return reset, lambda: {**read_train(),
                           **{k: _launches(k) for k in (
                               "upsample_argmax", *VARIANT_KERNELS)}}


@contextlib.contextmanager
def _no_tf32():
    """fp32 convolutions and products at fp32 on the card (PyTorch lets
    cuDNN take TF32 for fp32 convolutions by default)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _forward_ms(fn) -> dict:
    """Device ms of one forward queued behind the spin (``device_ms``), or,
    where the forward launches more kernels than the device's queue holds
    (mit_b2's 1,462; an int8 forward's quantize passes), the device time
    the profiler sums over its kernels (the gaps between them left out),
    named as such."""
    try:
        return {"device_ms": device_ms(fn, iters=1), "timed_by": "queued"}
    except RuntimeError:
        prof = profile_steps(fn, 0, steps=3, top=1)
        return {"device_ms": prof["device_ms_per_step"],
                "timed_by": "profiler"}


def _conv_check(family: str, encoder: str, images: torch.Tensor,
                timed: torch.Tensor) -> dict:
    """One (family, encoder) at full width, seeded weights: the card's
    fp32 logits (TF32 off) against the plain CPU forward of the same
    weights, the bf16 argmax's agreement with the fp32 one, and, given
    ``timed``, device ms and host ms of one bf16 forward of it."""
    from visiontransformer_tpu_torch.models.registry import (
        get_model_family,
        model_config,
    )

    cfg = model_config(family, encoder, num_classes=CONV_CLASSES,
                       compute_dtype="float32")
    model = get_model_family(family).init(torch.Generator().manual_seed(0),
                                          cfg).eval()
    row = {"family": family, "encoder": encoder,
           "params": sum(p.numel() for p in model.parameters())}
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = model(images)
        row["cpu_forward_s"] = time.perf_counter() - t0
        model.to("cuda")
        with _no_tf32():
            got = model(images.cuda()).cpu()
        row["max_abs_err"] = float((got - want).abs().max())
        row["max_abs_logit"] = float(want.abs().max())
        row["fp32_argmax_agreement_cpu"] = float(
            (got.argmax(-1) == want.argmax(-1)).float().mean())
        model.cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        bf16 = model(images.cuda()).argmax(-1).cpu()
        row["bf16_argmax_agreement_fp32"] = float(
            (bf16 == got.argmax(-1)).float().mean())
        if timed is not None:
            fn = lambda: model(timed)  # noqa: E731
            # One forward queued behind the spin: a conv forward launches
            # 560-920 kernels, and the device's queue does not hold two.
            row.update(batch=timed.shape[0], size=timed.shape[1],
                       **_forward_ms(fn),
                       host_ms=host_ms(fn, iters=5, rounds=3))
            prof = profile_steps(fn, timed.shape[0], steps=2, top=4)
            row.update(device_kernels_per_forward=prof[
                "device_kernels_per_step"],
                profiler_device_ms=prof["device_ms_per_step"],
                device_busy_share=prof["device_busy_share"],
                top=prof["top"])
            row["masks_per_s"] = timed.shape[0] / row["host_ms"] * 1e3
    row["ok"] = row["max_abs_err"] <= CONV_LOGITS_ATOL
    model.to("cpu")
    return row


def _conv_batches(tcfg, seed: int = 2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [{"image": torch.rand(tcfg.batch_size, CONV_SIZE, CONV_SIZE, 3,
                                 generator=gen, device="cuda"),
             "mask": torch.randint(0, CONV_CLASSES, (tcfg.batch_size,
                                                     CONV_SIZE, CONV_SIZE),
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)}
            for _ in range(2)]


def _timed_training(family: str, encoder: str, tmp: str = None) -> tuple:
    """Trainer(model=family) on encoder at the CE defaults (bf16, batch 16
    as 4 x 4) for CONV_TRAIN_STEPS steps on the card. Returns (the line's
    fields, the trained weights' checkpoint path under tmp, or None)."""
    from visiontransformer_tpu_torch.ckpt.io import save_checkpoint
    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.models.registry import model_config
    from visiontransformer_tpu_torch.train.trainer import Trainer

    tcfg = CE_TRAIN_DEFAULTS
    cfg = model_config(family, encoder, num_classes=CONV_CLASSES,
                       compute_dtype="bfloat16")
    batches = _conv_batches(tcfg)
    trainer = Trainer(cfg, tcfg, model=family, device="cuda")
    state = trainer.init_state()
    step = _train_step_fn(trainer, state, batches)
    step()  # first step: cuDNN's and the allocator's set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(CONV_TRAIN_STEPS):
        _, metrics = trainer.train_step(state, batches[i % 2], i)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    prof = profile_steps(step, tcfg.batch_size, steps=2, top=6)
    out = {"config": f"{family}/{encoder}", "classes": CONV_CLASSES,
           "dtype": "bfloat16", "batch": tcfg.batch_size,
           "accumulate": tcfg.accumulate_grad_batches,
           "timed_steps": CONV_TRAIN_STEPS, "losses": losses,
           "images_per_s": CONV_TRAIN_STEPS * tcfg.batch_size / seconds,
           "step_ms": seconds / CONV_TRAIN_STEPS * 1e3,
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "device_kernels_per_step": prof["device_kernels_per_step"],
           "top": prof["top"], "finite": all(np.isfinite(losses))}
    path = None if tmp is None else save_checkpoint(
        f"{tmp}/ckpt", {"params": state.model.state_dict(),
                        "step": state.step}, epoch=0, step=state.step)
    return out, path


def _fp32_step(family: str, encoder: str) -> dict:
    """One fp32 CE step (TF32 off) at the CE defaults, the card against the
    CPU from the same seeded weights and batch: the loss and every
    gradient."""
    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.models.registry import model_config
    from visiontransformer_tpu_torch.train.trainer import Trainer

    tcfg = CE_TRAIN_DEFAULTS
    cfg32 = model_config(family, encoder, num_classes=CONV_CLASSES,
                         compute_dtype="float32")
    batch = {k: v.cpu().numpy() for k, v in _conv_batches(tcfg)[0].items()}
    steps = {}
    for device in ("cpu", "cuda"):
        trainer = Trainer(cfg32, tcfg, model=family, device=device)
        st = trainer.init_state()
        with _no_tf32():
            _, metrics = trainer.train_step(st, batch, seed=0)
        steps[device] = (float(metrics["loss"]),
                         {n: p.grad.detach().cpu()
                          for n, p in st.model.named_parameters()})
        del st, trainer
    (loss_c, grads_c), (loss_g, grads_g) = steps["cpu"], steps["cuda"]
    checks = {n: close(grads_g[n], grads_c[n], *GRAD_TOL[torch.float32])
              for n in grads_c}
    worst = max(checks, key=lambda n: checks[n][1])
    return {"config": f"{family}/{encoder}",
            "loss_card": loss_g, "loss_cpu": loss_c,
            "loss_rel_diff": abs(loss_g - loss_c) / abs(loss_c),
            "grads": len(checks), "grad_tol": GRAD_TOL[torch.float32],
            "grads_failed": [n for n, (ok, _) in checks.items() if not ok],
            "worst_grad": {"name": worst, "max_abs_err": checks[worst][1]}}


def _conv_train(tmp: str) -> tuple:
    """Trainer(model="unet") on resnet34 (``_timed_training``), its weights
    saved, and its fp32 step against the CPU's (``_fp32_step``)."""
    out, path = _timed_training("unet", "resnet34", tmp)
    out["fp32_step"] = _fp32_step("unet", "resnet34")
    return out, path


def _conv_http(tmp: str, path: str) -> dict:
    """register-model --family unet --config resnet34 --ckpt path, then one
    HTTP job, whose mask must equal ModelRunner.predict's."""
    from visiontransformer_tpu_torch import cli
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    db, media = f"{tmp}/serving.db", f"{tmp}/media"
    rc = cli.main(["register-model", "--db", db, "--media-root", media,
                   "--name", "unet-r34", "--family", "unet", "--config",
                   "resnet34", "--num-classes", str(CONV_CLASSES), "--ckpt",
                   path])
    if rc:
        raise AssertionError(f"register-model --family unet exited {rc}")
    store = JobStore(db, media_root=media)
    (row,) = store.list_models()
    pngs = _job_pngs(1, seed=3)
    with _http_server(store, (1,)) as (client, csrf, startup_s):
        jobs, done, elapsed = _run_jobs(client, csrf, row["id"], pngs)
        (mask,) = _served_masks(client, jobs, done)
    runner = ModelRunner(store.get_model(row["id"]), device="cuda",
                         buckets=(1,))
    want = runner.predict(_decoded(pngs[0])[None])
    return {"family": row["model_family"], "config": row["config_name"],
            "job_s": elapsed, "startup_s": startup_s,
            "mask_equals_runner": bool(np.array_equal(mask, want[0])),
            "classes_in_mask": int(len(np.unique(mask)))}


def phase_conv_families():
    """Phase 14: the ten conv families on the card at full width (17
    classes, 224^2): logits against the CPU, bf16 forwards timed, unet
    trained and served. No kernel of the port lies on this path."""
    from visiontransformer_tpu_torch.models.registry import CONV_FAMILIES

    t_phase = time.perf_counter()
    reset, read = _kernel_launch_counts()
    reset()
    images = torch.rand(CONV_CHECK_BATCH, CONV_SIZE, CONV_SIZE, 3,
                        generator=torch.Generator().manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(1)
    timed = torch.rand(CONV_BATCH, CONV_SIZE, CONV_SIZE, 3, generator=gen,
                       device="cuda")
    rows = []
    for family in CONV_FAMILIES:
        rows.append(_conv_check(family, "resnet34", images, timed))
        emit("conv_family", **rows[-1])
    for encoder in CONV_OTHER_PRESETS:
        rows.append(_conv_check("unet", encoder, images, None))
        emit("conv_family", **rows[-1])
    del timed
    large = torch.rand(CONV_BATCH, 512, 512, 3, generator=gen, device="cuda")
    rows.append(_conv_check("unet", "resnet34", images, large))
    emit("conv_family", **rows[-1])
    del large
    with tempfile.TemporaryDirectory() as tmp:
        train, path = _conv_train(tmp)
        emit("conv_train", **train)
        http = _conv_http(tmp, path)
    launches = read()
    result = {"models": len(rows), "train": {
        k: train[k] for k in ("images_per_s", "step_ms",
                              "device_ms_per_step", "fp32_step")},
        "http": http, "launches": launches,
        "seconds": time.perf_counter() - t_phase}
    emit("conv_families", **result)
    bad = [(r["family"], r["encoder"], r["max_abs_err"]) for r in rows
           if not r["ok"]]
    step32 = train["fp32_step"]
    failed = {
        "logits": bad,
        "train_losses": not train["finite"],
        "fp32_step": (step32["loss_rel_diff"] > LOSS_RTOL
                      or bool(step32["grads_failed"])),
        "http": not http["mask_equals_runner"],
        "kernel_launches": {k: v for k, v in launches.items() if v},
    }
    if any(failed.values()):
        raise AssertionError(f"phase 14 (conv_families) failed: {failed}")
    return result


# Phase 15: segformer at full width (17 classes, 224^2, decode width 256,
# the registry's default), export-serving --family, W8A8 for conv and
# segformer rows.
SEG_ENCODERS = ("mit_b0", "mit_b2", "resnet34")  # mit_b2: SegFormer-B2's
SEG_EXPORTS = (("unet", "resnet34"), ("segformer", "mit_b2"))
SEG_INT8 = (("unet", "resnet34"), ("segformer", "mit_b0"))
EXPORT_BATCH = 8


@contextlib.contextmanager
def _w8a8_calls(record):
    """Within: every W8A8 conv and linear of the tree helpers
    (models/unet.py) appends (kind, x, layer's int8 tensors, options) to
    ``record`` as it runs."""
    from visiontransformer_tpu_torch.models import unet

    conv, linear = unet.conv2d_w8a8, unet._linear_w8a8

    def conv_rec(x, kq, ks, bias=None, **kw):
        record.append(("conv", x, kq, kw))
        return conv(x, kq, ks, bias, **kw)

    def linear_rec(x, kq, ks, bias=None, **kw):
        record.append(("linear", x, kq, kw))
        return linear(x, kq, ks, bias, **kw)

    unet.conv2d_w8a8, unet._linear_w8a8 = conv_rec, linear_rec
    try:
        yield record
    finally:
        unet.conv2d_w8a8, unet._linear_w8a8 = conv, linear


def _int8_check(family: str, encoder: str, images: torch.Tensor,
                timed: torch.Tensor) -> dict:
    """An int8 model of (family, encoder) at full width: every W8A8 layer of
    one forward of ``images`` (the card's activations) quantized and
    multiplied on the card (cuBLASLt ``_int_mm``, im2col for convs) and on
    the CPU (plain int32 product, float64 conv): int8 activations, scales
    and int32 accumulators equal; then the int8 forward of ``timed``
    against the bf16 one of the same weights (mask agreement, device ms)."""
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.nn.layers import (
        int8_conv,
        int8_matmul,
        quantize_per_sample,
        quantize_per_token,
    )
    from visiontransformer_tpu_torch.ops.quant import quantize_conv_model_

    _, model = resolve_model(family, encoder, num_classes=CONV_CLASSES,
                             device="cuda")
    row = {"family": family, "encoder": encoder}
    with torch.inference_mode():
        bf16_masks = model(timed).argmax(-1)
        fn = lambda: model(timed)  # noqa: E731
        row["bf16"] = _forward_ms(fn)
        quantize_conv_model_(model)
        with _w8a8_calls([]) as calls:
            model(images)
        layers, bad = {"conv": 0, "linear": 0}, []
        for kind, x, kq, kw in calls:
            layers[kind] += 1
            quantize = quantize_per_sample if kind == "conv" \
                else quantize_per_token
            forms = []
            for t, w in ((x, kq), (x.cpu(), kq.cpu())):
                xq, s_x = quantize(t)
                acc = (int8_conv(xq, w, **kw) if kind == "conv" else
                       int8_matmul(xq.reshape(-1, xq.shape[-1]), w))
                forms.append((xq.cpu(), s_x.cpu(), acc.cpu()))
            (a, b) = forms
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                bad.append({"kind": kind, "x": list(x.shape),
                            "kernel_q": list(kq.shape), **kw})
        row.update(layers=layers, layers_not_equal=bad)
        int8_masks = model(timed).argmax(-1)
        row["int8"] = _forward_ms(fn)
        row["int8_over_bf16_device_ms"] = (row["int8"]["device_ms"]
                                           / row["bf16"]["device_ms"])
        row["int8_mask_agreement_bf16"] = float(
            (int8_masks == bf16_masks).float().mean())
    row["batch"], row["size"] = timed.shape[0], timed.shape[1]
    return row


def _export_check(family: str, encoder: str, tmp: str) -> dict:
    """export-serving --family at CONV_SIZE, batch EXPORT_BATCH, seeded
    weights, bf16 on the card: the program's masks against
    ModelRunner.predict's on the same uint8 images, bit for bit."""
    from visiontransformer_tpu_torch import cli
    from visiontransformer_tpu_torch.ckpt.export import load_serving
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    out = f"{tmp}/{family}-{encoder}.pt2"
    t0 = time.perf_counter()
    rc = cli.main(["export-serving", "--family", family, "--config",
                   encoder, "--num-classes", str(CONV_CLASSES),
                   "--input-size", str(CONV_SIZE), "--batch",
                   str(EXPORT_BATCH), "--device", "cuda", "--out", out])
    if rc:
        raise AssertionError(f"export-serving --family {family} exited {rc}")
    export_s = time.perf_counter() - t0
    art = load_serving(out, device="cuda")
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (EXPORT_BATCH, CONV_SIZE, CONV_SIZE, 3),
                          dtype=np.uint8)
    x = torch.from_numpy(images).cuda().float() / 255.0
    got = art.call(x).cpu().numpy()
    runner = ModelRunner({"input_size": CONV_SIZE, "config_name": encoder,
                          "num_classes": CONV_CLASSES,
                          "model_family": family},
                         buckets=(EXPORT_BATCH,), device="cuda")
    want = runner.predict(images)
    with torch.inference_mode():
        program_ms = host_ms(lambda: art.call(x), iters=5, rounds=2)
        eager_ms = host_ms(lambda: runner.model(x).argmax(-1), iters=5,
                           rounds=2)
    return {"family": family, "encoder": encoder,
            "header": {k: art.meta[k] for k in (
                "family", "input_size", "batch_size", "platforms")},
            "export_s": export_s, "bytes": os.path.getsize(out),
            "masks_equal_runner": bool(np.array_equal(got, want)),
            "program_host_ms": program_ms, "eager_host_ms": eager_ms}


def _segformer_http(tmp: str) -> dict:
    """A segformer/mit_b2 row and the int8 rows of SEG_INT8 registered with
    register-model and served over HTTP: each job's mask equals its row's
    ModelRunner.predict."""
    from visiontransformer_tpu_torch import cli
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    db, media = f"{tmp}/serving.db", f"{tmp}/media"
    rows = [("segformer", "mit_b2", "")] + [(f, e, "int8")
                                            for f, e in SEG_INT8]
    for family, encoder, quantize in rows:
        args = ["register-model", "--db", db, "--media-root", media,
                "--name", f"{family}-{encoder}-{quantize or 'bf16'}",
                "--family", family, "--config", encoder,
                "--num-classes", str(CONV_CLASSES)]
        if cli.main(args + (["--quantize", quantize] if quantize else [])):
            raise AssertionError(f"register-model {family} {encoder} "
                                 f"{quantize} failed")
    store = JobStore(db, media_root=media)
    pngs = _job_pngs(1, seed=4)
    out = {}
    with _http_server(store, (1,)) as (client, csrf, startup_s):
        for row in store.list_models():
            jobs, done, elapsed = _run_jobs(client, csrf, row["id"], pngs)
            (mask,) = _served_masks(client, jobs, done)
            runner = ModelRunner(store.get_model(row["id"]), device="cuda",
                                 buckets=(1,))
            want = runner.predict(_decoded(pngs[0])[None])
            out[row["name"]] = {
                "job_s": elapsed,
                "mask_equals_runner": bool(np.array_equal(mask, want[0]))}
        out["startup_s"] = startup_s
    return out


def phase_segformer_export_int8():
    """Phase 15: segformer on the card at full width, export-serving
    --family and W8A8 for conv and segformer rows. Of the port's kernels
    only kernel 1 lies on these paths, in the MiT rows' attention (no
    gradient; their training step stays eager)."""
    t_phase = time.perf_counter()
    reset, read = _kernel_launch_counts()
    reset()
    images = torch.rand(CONV_CHECK_BATCH, CONV_SIZE, CONV_SIZE, 3,
                        generator=torch.Generator().manual_seed(1))
    gen = torch.Generator(device="cuda").manual_seed(1)
    timed = torch.rand(CONV_BATCH, CONV_SIZE, CONV_SIZE, 3, generator=gen,
                       device="cuda")
    rows = []
    for encoder in SEG_ENCODERS:
        rows.append(_conv_check("segformer", encoder, images, timed))
        emit("segformer", **rows[-1])
    large = torch.rand(CONV_BATCH, 512, 512, 3, generator=gen, device="cuda")
    rows.append(_conv_check("segformer", "mit_b2", images, large))
    emit("segformer", **rows[-1])
    del large
    fp32_step = _fp32_step("segformer", "mit_b0")
    emit("segformer_fp32_step", **fp32_step)
    train, _ = _timed_training("segformer", "mit_b2")
    emit("segformer_train", **train)
    int8 = [_int8_check(f, e, images.cuda(), timed) for f, e in SEG_INT8]
    for row in int8:
        emit("int8", **row)
    del timed
    with tempfile.TemporaryDirectory() as tmp:
        exports = [_export_check(f, e, tmp) for f, e in SEG_EXPORTS]
        for row in exports:
            emit("export_serving", **row)
        http = _segformer_http(tmp)
    launches = read()
    result = {"models": len(rows), "train": {
        k: train[k] for k in ("images_per_s", "step_ms",
                              "device_ms_per_step", "device_busy_share")},
        "http": http, "launches": launches,
        "seconds": time.perf_counter() - t_phase}
    emit("segformer_export_int8", **result)
    failed = {
        "logits": [(r["encoder"], r["max_abs_err"]) for r in rows
                   if not r["ok"]],
        "fp32_argmax": [r["encoder"] for r in rows
                        if r["fp32_argmax_agreement_cpu"] != 1.0],
        "train_losses": not train["finite"],
        "fp32_step": (fp32_step["loss_rel_diff"] > LOSS_RTOL
                      or bool(fp32_step["grads_failed"])),
        "int8_layers": [(r["family"], r["layers_not_equal"]) for r in int8
                        if r["layers_not_equal"]],
        "exports": [r["family"] for r in exports
                    if not r["masks_equal_runner"]
                    or r["header"]["family"] != r["family"]],
        "http": [k for k, v in http.items()
                 if isinstance(v, dict) and not v["mask_equals_runner"]],
        "kernel_launches": {k: v for k, v in launches.items()
                            if v and k != "flash_attention_fwd"},
        "mit_attention_off_kernel_1": not launches["flash_attention_fwd"],
    }
    if any(failed.values()):
        raise AssertionError(f"phase 15 (segformer_export_int8) failed: "
                             f"{failed}")
    return result


# Phase 16: the CE defaults' epoch (16 images a step), long enough for
# the trace of steps 2-5 and untraced steps after it.
REPORTS_STEPS = 10
REPORTS_CONFIG = "P16H768A12"
# Kernels 2-4 in the profiler's trace, by the names the card gives them:
# the training forward is fwd_*_kernel<..., true> (kTrain), kernel 1 the
# same with false.
TRACE_KERNELS = {
    "flash_attention_fwd": r"fwd_\w*kernel<[^>]*false>",
    "flash_attention_fwd_train": r"fwd_\w*kernel<[^>]*true>",
    "flash_attention_bwd_dq": r"dq_\w*kernel",
    "flash_attention_bwd_dkv": r"dkv_\w*kernel",
}
# fp32 logits on the card (TF32 off) and on the CPU each sit within the
# seg-logit tolerance (5e-5) of the true value: an argmax may flip between
# them only where the two top logits are within twice that.
DEMO_TIE_TOL = 2 * LOGITS_TOL[0]


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _proto_fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: varints
    and fixed64/32 as raw bytes or ints, length-delimited as bytes."""
    pos = 0

    def varint():
        nonlocal pos
        shift = value = 0
        while True:
            b = buf[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return value

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            yield field, wire, varint()
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 2:
            n = varint()
            yield field, wire, buf[pos:pos + n]
            pos += n
        else:
            raise AssertionError(f"protobuf wire type {wire}")


def read_tfevents(path: str) -> list:
    """(tag, step, value) of each scalar of a tfevents file, every record's
    masked CRC-32C of its length and payload checked (TFRecord framing;
    Event.step 2, Event.summary 5, Summary.value 1, Value.tag 1,
    Value.simple_value 2)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    out, pos, records = [], 0, 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        payload = data[pos + 12:pos + 12 + n]
        if (struct.unpack("<I", data[pos + 8:pos + 12])[0]
                != _masked(_crc32c(header))
                or struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0]
                != _masked(_crc32c(payload))):
            raise AssertionError(f"{path}: record {records} has a bad CRC")
        pos, records = pos + 16 + n, records + 1
        fields = list(_proto_fields(payload))
        step = next((v for f, w, v in fields if f == 2 and w == 0), 0)
        for summary in (v for f, w, v in fields if f == 5 and w == 2):
            for value in (v for f, w, v in _proto_fields(summary) if f == 1):
                vf = {f: v for f, w, v in _proto_fields(value)}
                out.append((vf[1].decode(), step,
                            struct.unpack("<f", vf[2])[0]))
    return out


def _trace_kernels(profile_dir: str) -> tuple:
    """(launches of kernels 1-4 by their names in the trace, the traced
    step ranges' host ms, the distinct kernel names matched)."""
    import glob
    import re

    (path,) = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {name: 0 for name in TRACE_KERNELS}
    matched = set()
    steps = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") == "kernel":
            for kernel, pattern in TRACE_KERNELS.items():
                if re.search(pattern, name):
                    counts[kernel] += 1
                    matched.add(name[:120])
        elif (name.startswith("train_step_")
              and e.get("cat") == "user_annotation"):
            steps[int(name.rsplit("_", 1)[1])] = e["dur"] / 1e3
    return counts, steps, sorted(matched), os.path.getsize(path)


def phase_reports_tools():
    """Phase 16: the train command with --profile-dir (the trace and the
    tfevents log), doctor, demo and eval-sweep --visualize on ViT-B/16."""
    import csv
    import glob
    import importlib.util

    from visiontransformer_tpu_torch.cli import main as cli_main
    from visiontransformer_tpu_torch.configs import (
        CE_TRAIN_DEFAULTS,
        sweep_by_name,
    )
    from visiontransformer_tpu_torch.evaluation.demo import (
        load_image,
        make_predict_fn,
        predict_image,
    )
    from visiontransformer_tpu_torch.evaluation.evaluate import sweep_model
    from visiontransformer_tpu_torch.models.vitseg import vitseg_apply
    from visiontransformer_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    rendering = importlib.util.find_spec("matplotlib") is not None
    entry = sweep_by_name(REPORTS_CONFIG)
    layers = entry.hidden_layers
    tcfg = CE_TRAIN_DEFAULTS
    batch, accum = tcfg.batch_size, tcfg.accumulate_grad_batches
    reset, read = _kernel_launch_counts()
    result = {"config": REPORTS_CONFIG, "classes": 17, "batch": batch,
              "accumulate": accum, "steps": REPORTS_STEPS,
              "rendering": "matplotlib" if rendering
              else "matplotlib absent"}
    with tempfile.TemporaryDirectory() as tmp:
        data = f"{tmp}/data"
        _synthetic_ce_set(data, REPORTS_STEPS * batch)
        ckpt_root, prof, logs = f"{tmp}/ckpts", f"{tmp}/prof", f"{tmp}/logs"

        # ---- 1. train --profile-dir, at the CE defaults
        host_ms = []
        step_fn = Trainer.train_step

        def timed_step(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = step_fn(self, *args, **kwargs)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        Trainer.train_step = timed_step
        reset()
        try:
            rc = cli_main([
                "train", "--data", data, "--config", REPORTS_CONFIG,
                "--no-split", "--batch-size", str(batch), "--accumulate",
                str(accum), "--max-epochs", "1", "--logs", logs,
                "--ckpt-dir", f"{ckpt_root}/{REPORTS_CONFIG}",
                "--profile-dir", prof, "--cache-data", "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            Trainer.train_step = step_fn
        launches = read()
        per_step = layers * accum
        want = {k: 0 for k in launches}
        # --no-split: validation runs over the same images, one inference
        # forward a batch.
        want.update(flash_attention_fwd=layers * REPORTS_STEPS,
                    flash_attention_fwd_train=per_step * REPORTS_STEPS,
                    flash_attention_bwd_dq=per_step * REPORTS_STEPS,
                    flash_attention_bwd_dkv=per_step * REPORTS_STEPS)
        if rc != 0 or launches != want or len(host_ms) != REPORTS_STEPS:
            raise AssertionError(f"train: rc {rc}, launches {launches}, "
                                 f"expected {want}, {len(host_ms)} steps")
        traced, trace_steps, names, trace_bytes = _trace_kernels(prof)
        want_traced = {"flash_attention_fwd": 0,
                       **{k: per_step * 4 for k in TRACE_KERNELS
                          if k != "flash_attention_fwd"}}
        if traced != want_traced or sorted(trace_steps) != [2, 3, 4, 5]:
            raise AssertionError(f"trace: kernels {traced} (expected "
                                 f"{want_traced}, names {names}), steps "
                                 f"{sorted(trace_steps)}")
        (metrics_csv,) = glob.glob(f"{logs}/*/version_0/metrics.csv")
        with open(metrics_csv) as f:
            rows = [r for r in csv.DictReader(f) if r["train_loss"]]
        csv_pairs = sorted((k, int(r["step"])) for r in rows
                           for k, v in r.items()
                           if v and k not in ("epoch", "step"))
        (events,) = glob.glob(os.path.join(os.path.dirname(metrics_csv),
                                           "events.out.tfevents.*"))
        scalars = read_tfevents(events)
        if sorted((t, s) for t, s, _ in scalars) != csv_pairs:
            raise AssertionError(f"tfevents {scalars} against the CSV's "
                                 f"epoch rows {csv_pairs}")
        untraced = host_ms[6:]
        result["train"] = {
            "launches": launches, "trace_launches": traced,
            "trace_kernel_names": names, "trace_bytes": trace_bytes,
            "trace_step_range_ms": trace_steps,
            "step_host_ms": host_ms,
            "traced_step_host_ms": float(np.median(host_ms[2:6])),
            "untraced_step_host_ms": float(np.median(untraced)),
            "tfevents_scalars": len(scalars),
            "losses": [float(r["train_loss"]) for r in rows]}

        # ---- 2. doctor
        proc = subprocess.run(
            [sys.executable, "-m", "visiontransformer_tpu_torch", "doctor"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        report = json.loads(proc.stdout) if proc.returncode == 0 else {}
        if (proc.returncode != 0
                or report.get("device") != torch.cuda.get_device_name(0)
                or set(report["kernels"].values()) != {"built"}
                or len(report["kernels"]) != 10):
            raise AssertionError(f"doctor: rc {proc.returncode}\n"
                                 f"{proc.stdout}\n{proc.stderr[-2000:]}")
        result["doctor"] = {k: report[k] for k in (
            "device", "device_count", "torch", "cuda_runtime", "nvcc",
            "native_lib", "device_check")}

        # ---- 3. demo from the checkpoint just written
        image_path = sorted(glob.glob(f"{data}/image_png/*.png"))[0]
        demo_out = f"{tmp}/demo"
        if rendering:
            reset()
            rc = cli_main(["demo", "--image", image_path, "--configs",
                           REPORTS_CONFIG, "--ckpt-root", ckpt_root,
                           "--out", demo_out, "--device", "cuda"])
            demo_launches = read()
            if rc != 0 or not os.path.exists(
                    f"{demo_out}/demo_{REPORTS_CONFIG}.png"):
                raise AssertionError(f"demo: rc {rc}")
        image = load_image(image_path)
        cfg16, model16 = sweep_model(entry, num_classes=17,
                                     checkpoint_root=ckpt_root,
                                     device="cuda")
        if not rendering:
            reset()
            predict_image(model16, cfg16, image)
            demo_launches = read()
        want = {k: 0 for k in demo_launches}
        want["flash_attention_fwd"] = layers
        if demo_launches != want:
            raise AssertionError(f"demo launches {demo_launches}, "
                                 f"expected {want}")
        x = torch.from_numpy(image[None]).cuda()
        predict = make_predict_fn(cfg16)
        demo = {"launches": demo_launches,
                "bf16_forward": _forward_ms(lambda: predict(model16, x))}
        del model16
        with _no_tf32():
            masks = {}
            for device in ("cuda", "cpu"):
                cfg32, model32 = sweep_model(
                    entry, num_classes=17, checkpoint_root=ckpt_root,
                    compute_dtype="float32", device=device)
                masks[device] = predict_image(model32, cfg32, image)
            with torch.no_grad():
                cpu_logits = vitseg_apply(model32, torch.from_numpy(
                    image[None]))[0]
            got = torch.from_numpy(masks["cuda"]["mask"])
            want_mask = torch.from_numpy(masks["cpu"]["mask"])
            flips, gap = ties_explained(cpu_logits, got, want_mask,
                                        DEMO_TIE_TOL)
            if not flips and (masks["cuda"]["detections"]
                              != masks["cpu"]["detections"]):
                raise AssertionError("demo: equal masks, unequal "
                                     "detections")
        demo.update(fp32_flips=flips, fp32_flip_gap=gap,
                    classes=masks["cuda"]["classes"],
                    detections=len(masks["cuda"]["detections"]))
        result["demo"] = demo

        # ---- 4. eval-sweep --visualize, one config, two batches
        out = f"{tmp}/sweep"
        reset()
        if rendering:
            rc = cli_main(["eval-sweep", "--data", data, "--no-split",
                           "--configs", REPORTS_CONFIG, "--ckpt-root",
                           ckpt_root, "--num-batches", "2", "--visualize",
                           "--out", out, "--device", "cuda"])
        else:
            from visiontransformer_tpu_torch.data import (
                CESegmentationDataset,
            )
            from visiontransformer_tpu_torch.evaluation import run_sweep

            rc = 0 if run_sweep(
                CESegmentationDataset(f"{data}/image_png",
                                      f"{data}/mask_png"),
                output_dir=out, num_classes=17, checkpoint_root=ckpt_root,
                entries=[entry], num_batches=2, device="cuda") else 1
        sweep_launches = read()
        pngs = sorted(os.listdir(f"{out}/{REPORTS_CONFIG}"))
        want_pngs = ([f"result_batch{b}_img{i}.png" for b in (0, 1)
                      for i in range(4)] if rendering else [])
        want = {k: 0 for k in sweep_launches}
        want["flash_attention_fwd"] = 2 * layers
        if (rc != 0 or sweep_launches != want
                or [p for p in pngs if p.endswith(".png")] != want_pngs):
            raise AssertionError(f"eval-sweep: rc {rc}, launches "
                                 f"{sweep_launches}, files {pngs}")
        result["eval_sweep"] = {"launches": sweep_launches,
                                "panels": len(want_pngs)}
    result["launches"] = {k: result["train"]["launches"][k]
                          + result["demo"]["launches"][k]
                          + result["eval_sweep"]["launches"][k]
                          for k in result["train"]["launches"]}
    result["seconds"] = time.perf_counter() - t_phase
    emit("reports_tools", **result)
    return result


# ------------------------------------------------------------- parallel
PARALLEL_MODES = (
    ("dp", {"mesh_shape": (2,)}),
    ("tp", {"mesh_shape": (1, 2)}),
    ("fsdp", {"mesh_shape": (2,), "fsdp": True}),
    ("seq_parallel", {"mesh_shape": (1, 2), "seq_parallel": True}),
    ("pipeline", {"mesh_shape": (1, 2), "pipeline_stages": 2,
                  "pipeline_microbatches": 2}),
)
PARALLEL_PARAM_TOL = (2e-6, 2e-5)  # atol, rtol (tests/test_multihost.py)
PARALLEL_CHECKPOINTS = ("fsdp", "pipeline")
PARALLEL_TIMED_STEPS = 1


def _parallel_batch(seed: int, n: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, 224, 224, 3), np.float32),
            "mask": rng.integers(0, 17, (n, 256, 256), dtype=np.int32)}


def _parallel_cfg(dtype: str, dropout: bool):
    from visiontransformer_tpu_torch.models.registry import vitseg_config

    cfg = vitseg_config("P16H768A12", num_classes=17, compute_dtype=dtype)
    if dropout:
        return cfg
    return dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))


def _parallel_reference(path: str) -> dict:
    """The single-rank fp32 step (dropout off) of phase 17 on the card:
    loss, gradients and updated parameters, saved to ``path``."""
    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_parallel_cfg("float32", False), CE_TRAIN_DEFAULTS,
                      device="cuda")
    state = trainer.init_state()
    _, metrics = trainer.train_step(state, _parallel_batch(0), seed=0)
    ref = {"loss": float(metrics["loss"]),
           "grads": {n: p.grad.detach().cpu()
                     for n, p in state.model.named_parameters()},
           "params": {n: p.detach().cpu()
                      for n, p in state.model.named_parameters()}}
    torch.save(ref, path)
    return ref


def _parallel_mode_fp32(name, mode, ref, out_dir, images):
    """One mode's fp32 step against the single-rank step (rank 0 checks);
    FSDP and the pipeline also write a checkpoint and the sharded forward's
    logits."""
    import torch.distributed as dist

    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.train.trainer import Trainer

    tcfg = dataclasses.replace(CE_TRAIN_DEFAULTS, **mode)
    trainer = Trainer(_parallel_cfg("float32", False), tcfg, device="cuda")
    state = trainer.init_state()
    _, metrics = trainer.train_step(state, _parallel_batch(0), seed=0)
    loss = float(metrics["loss"])
    grads = trainer.plan.gathered(state.model, lambda p: p.grad)
    params = (trainer.plan.gathered(state.model, lambda p: p)
              if name in ("dp", "fsdp") else None)
    row = {}
    if name in PARALLEL_CHECKPOINTS:
        row["checkpoint"] = trainer.save(state, f"{out_dir}/{name}",
                                         epoch=0)
        state.model.eval()
        with torch.no_grad():
            logits = state.model(images.cuda(), attn_impl="flash")
        if dist.get_rank() == 0:
            torch.save(logits.cpu(), f"{out_dir}/{name}_logits.pt")
    if ref is None:
        return None
    checks = {n: close(grads[n], ref["grads"][n], *GRAD_TOL[torch.float32])
              for n in ref["grads"]}
    bad = [n for n, (ok, _) in checks.items() if not ok]
    worst = max(checks, key=lambda n: checks[n][1])
    norm_bad, norms, _ = step_grads_agree(grads, ref["grads"])
    row.update(loss=loss, loss_ref=ref["loss"],
               loss_rel_diff=abs(loss - ref["loss"]) / abs(ref["loss"]),
               grads=len(grads), grads_failed=bad + norm_bad,
               worst_grad={"name": worst, "max_abs_err": checks[worst][1],
                           "rel_err_norm": norms[worst]})
    if params is not None:
        pchecks = {n: close(params[n], ref["params"][n], *PARALLEL_PARAM_TOL)
                   for n in ref["params"]}
        row["params_failed"] = [n for n, (ok, _) in pchecks.items() if not ok]
        row["params_max_abs_err"] = max(e for _, e in pchecks.values())
    return row


def _parallel_mode_bf16(name, mode, reset_read):
    """One mode's bf16 step with the CE defaults' dropout: its launches of
    kernels 2-4 a rank, then images/s and the device-busy share."""
    import torch.distributed as dist

    from visiontransformer_tpu_torch.configs import CE_TRAIN_DEFAULTS
    from visiontransformer_tpu_torch.train.trainer import Trainer

    _, read = reset_read
    tcfg = dataclasses.replace(CE_TRAIN_DEFAULTS, **mode)
    trainer = Trainer(_parallel_cfg("bfloat16", True), tcfg, device="cuda")
    state = trainer.init_state()
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _parallel_batch(1).items()}
    before = read()
    _, metrics = trainer.train_step(state, batch, seed=0)
    after = read()
    launches = {k: after[k] - before[k] for k in after}
    loss = float(metrics["loss"])
    count = [1]

    def step():
        trainer.train_step(state, batch, seed=count[0])
        count[0] += 1

    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(PARALLEL_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    images_per_s = (PARALLEL_TIMED_STEPS * tcfg.batch_size
                    / (time.perf_counter() - t0))
    prof = profile_steps(step, tcfg.batch_size, steps=1, top=3)
    return {"loss": loss, "launches": launches,
            "images_per_s": images_per_s,
            "device_busy_share": prof["device_busy_share"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "plan": trainer.plan.describe()}


def _parallel_rank(ref_path: str, out_dir: str) -> dict:
    """One rank of phase 17: every mode in turn; rank 0 returns the
    rows."""
    import torch.distributed as dist

    from visiontransformer_tpu_torch.parallel import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    ref = torch.load(ref_path, weights_only=True) if rank == 0 else None
    images = torch.from_numpy(_parallel_batch(2, n=2)["image"])
    reset, read = _kernel_launch_counts()
    reset()
    rows = {}
    for name, mode in PARALLEL_MODES:
        t0 = time.perf_counter()
        staged = launch.staged_transfers()
        row = {"fp32": _parallel_mode_fp32(name, mode, ref, out_dir, images),
               "bf16": _parallel_mode_bf16(name, mode, (reset, read)),
               "backend": dist.get_backend()}
        # "gloo-host" where this mode's transfers went through host memory.
        staged = launch.staged_transfers() - staged
        row.update(transport=launch.transport() if staged
                   else dist.get_backend(), host_staged_transfers=staged,
                   seconds=time.perf_counter() - t0)
        rows[name] = row
    return {"rank": rank, "rows": rows, "launches": read()}


def _mesh_bench_masks(runner, raw: torch.Tensor, compute: int,
                      attn_impl: str = "flash") -> torch.Tensor:
    """The bench workload over a ModelRunner's replicas, split as its
    dispatch splits a bucket: each replica's rows of the raw (B, S, S, 3)
    fp32 batch resized to compute^2 and ImageNet-normalized on the card
    (phase 4's front end), then predicted at S^2 in uint8 on the replica's
    own stream; the masks gathered in row order."""
    from visiontransformer_tpu_torch.models.vitseg import vitseg_predict
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm

    size = raw.shape[1]
    mean = torch.tensor(MEAN, device=raw.device)
    std = torch.tensor(STD, device=raw.device)
    per = raw.shape[0] // len(runner.replicas)
    torch.cuda.synchronize()
    parts = []
    with torch.inference_mode():
        for i, (_, forward, stream) in enumerate(runner.replicas):
            with torch.cuda.stream(stream or torch.cuda.current_stream()):
                x = resize_bilinear_mm(raw[i * per:(i + 1) * per],
                                       (compute, compute))
                parts.append(vitseg_predict(
                    forward.model, (x - mean) / std, out_size=(size, size),
                    attn_impl=attn_impl, mask_dtype=torch.uint8))
        torch.cuda.synchronize()
    return torch.cat(parts)


def _parallel_serving(n_jobs: int = 8) -> tuple:
    """ModelRunner over a dp = 2 serving mesh whose replicas share the
    card, against one replica: ModelRunner.predict at the row's 224^2,
    then the bench workload (batch 32, 512^2 -> 224^2 -> 512^2); then jobs
    over HTTP through it."""
    from visiontransformer_tpu_torch.models.vitseg import vitseg_head_logits
    from visiontransformer_tpu_torch.ops.resize import resize_bilinear_mm
    from visiontransformer_tpu_torch.serve.store import JobStore
    from visiontransformer_tpu_torch.serve.worker import ModelRunner

    batch, compute, size = 32, 224, 512
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (batch, compute, compute, 3), np.uint8)
    gen = torch.Generator(device="cuda").manual_seed(3)
    raw = torch.rand(batch, size, size, 3, generator=gen, device="cuda")
    devices = [torch.device("cuda", 0)] * 2
    out = {"batch": batch, "size": compute, "bench_in_out": size,
           "replicas": 2}
    with tempfile.TemporaryDirectory() as media:
        store = JobStore(":memory:", media_root=media)
        model_id = store.register_model("vit-b16-damage", num_classes=17,
                                        config_name="P16H768A12")
        row = store.get_model(model_id)
        for dtype in ("float32", "bfloat16"):
            one = ModelRunner(row, compute_dtype=dtype, device="cuda",
                              buckets=(batch,))
            two = ModelRunner(row, compute_dtype=dtype, buckets=(batch,),
                              mesh_shape=(2,), devices=devices)
            with _no_tf32():
                got, want = two.predict(images), one.predict(images)
                bench = _mesh_bench_masks(two, raw, compute).cpu()
                bench_one = _mesh_bench_masks(one, raw, compute).cpu()
                if dtype == "float32":
                    x = torch.from_numpy(images).cuda().float() / 255.0
                    plain_x = resize_bilinear_mm(raw, (compute, compute))
                    plain_x = ((plain_x - torch.tensor(MEAN, device="cuda"))
                               / torch.tensor(STD, device="cuda"))
                    with torch.inference_mode():
                        plain = resize_bilinear_mm(vitseg_head_logits(
                            one.model, x, attn_impl="eager").float(),
                            (compute, compute))
                        plain_bench = resize_bilinear_mm(vitseg_head_logits(
                            one.model, plain_x, attn_impl="eager").float(),
                            (size, size))
                    flips, gap = ties_explained(
                        plain.cpu(), torch.from_numpy(got),
                        torch.from_numpy(want), DEMO_TIE_TOL)
                    bflips, bgap = ties_explained(
                        plain_bench.cpu(), bench, bench_one, DEMO_TIE_TOL)
                    del plain_bench
                    out["fp32"] = {"flips": flips, "flip_max_logit_gap": gap,
                                   "bench_flips": bflips,
                                   "bench_flip_max_logit_gap": bgap}
                else:
                    out["bf16_agreement"] = float((got == want).mean())
                    out["bf16_bench_agreement"] = float(
                        (bench == bench_one).float().mean())
            t0 = time.perf_counter()
            for _ in range(3):
                _mesh_bench_masks(two, raw, compute)
            out[f"{dtype}_bench_masks_per_s"] = 3 * batch / (
                time.perf_counter() - t0)
            del one, two
        pngs = _job_pngs(n_jobs, seed=4)
        with _http_server(store, (n_jobs,), mesh_shape=(2,),
                          devices=devices) as (client, csrf, _):
            jobs, done, elapsed = _run_jobs(client, csrf, model_id, pngs)
            # Each job's mask against the same mesh's predict of its image
            # alone (a replica's rows at the same shape).
            runner = ModelRunner(row, buckets=(n_jobs,), mesh_shape=(2,),
                                 devices=devices)
            equal = sum(int(np.array_equal(m, runner.predict(
                _decoded(p)[None])[0])) for m, p in zip(
                    _served_masks(client, jobs, done), pngs))
        out["http"] = {"jobs": n_jobs, "jobs_per_s": n_jobs / elapsed,
                       "masks_equal_runner": equal}
        if equal != n_jobs:
            raise AssertionError(f"serving mesh: {n_jobs - equal} job masks "
                                 f"differ from ModelRunner.predict")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _parallel_multihost(tmp: str) -> dict:
    """train --multihost as two OS processes on this host."""
    data = f"{tmp}/mh_data"
    _synthetic_ce_set(data, 32)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "visiontransformer_tpu_torch", "train",
         "--data", data, "--config", "P16H768A12", "--image-size", "224",
         "--batch-size", "16", "--accumulate", "4", "--max-epochs", "1",
         "--no-split", "--logs", f"{tmp}/mh_logs{pid}",
         "--ckpt-dir", f"{tmp}/mh_ckpt", "--multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    t0 = time.perf_counter()
    outs = []
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    csvs = [os.path.exists(f"{tmp}/mh_logs{pid}/vit-model/version_0/"
                           "metrics.csv") for pid in range(2)]
    result = {"returncodes": [p.returncode for p in procs],
              "metrics_csv": csvs, "seconds": time.perf_counter() - t0,
              "checkpoints": sorted(os.listdir(f"{tmp}/mh_ckpt"))
              if os.path.isdir(f"{tmp}/mh_ckpt") else []}
    if result["returncodes"] != [0, 0] or csvs != [True, False] \
            or not result["checkpoints"]:
        raise AssertionError(f"train --multihost: {result}\n"
                             + "\n".join(o[-3000:] for o in outs))
    return result


def phase_parallel():
    """Phase 17: every parallel mode on a 2-rank job, checkpoints, the
    serving mesh and multi-host training."""
    from visiontransformer_tpu_torch.models.registry import resolve_model
    from visiontransformer_tpu_torch.models.vitseg import vitseg_apply
    from visiontransformer_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    result = {"ranks": 2, "cards": cards, "share_card": cards < 2,
              "config": "P16H768A12", "classes": 17, "size": 224}
    with tempfile.TemporaryDirectory() as tmp, _no_tf32():
        ref = _parallel_reference(f"{tmp}/ref.pt")
        del ref["grads"], ref["params"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.spawn(_parallel_rank, 2, (f"{tmp}/ref.pt", tmp),
                             share_device=cards < 2, timeout=900)
        result["job_s"] = time.perf_counter() - t0
        rows = ranks[0]["rows"]
        stage1 = ranks[1]["rows"]["pipeline"]["bf16"]["launches"]
        failed = []
        for name, row in rows.items():
            fp32, bf16 = row["fp32"], row["bf16"]
            want = {"flash_attention_fwd_train": 48,
                    "flash_attention_bwd_dq": 48,
                    "flash_attention_bwd_dkv": 48}
            for rank in ranks:
                got = rank["rows"][name]["bf16"]["launches"]
                if any(got[k] != v for k, v in want.items()):
                    failed.append(f"{name}: rank {rank['rank']} launches "
                                  f"{got}")
            if (fp32["loss_rel_diff"] > LOSS_RTOL or fp32["grads_failed"]
                    or fp32.get("params_failed")
                    or not np.isfinite(bf16["loss"])):
                failed.append(f"{name}: {fp32} {bf16['loss']}")
            emit("parallel_mode", mode=name, **row)
        result["pipeline_stage1_launches"] = stage1
        # The checkpoints, restored on this one rank.
        images = torch.from_numpy(_parallel_batch(2, n=2)["image"]).cuda()
        restored = {}
        for name in PARALLEL_CHECKPOINTS:
            path = rows[name]["fp32"]["checkpoint"]
            _, model = resolve_model("vitseg", "P16H768A12",
                                     num_classes=17, input_size=224,
                                     compute_dtype="float32",
                                     checkpoint_path=path, device="cuda")
            with torch.no_grad():
                got = vitseg_apply(model, images, attn_impl="flash").cpu()
            want = torch.load(f"{tmp}/{name}_logits.pt", weights_only=True)
            ok, err = close(got, want, *LOGITS_TOL)
            restored[name] = {"path": os.path.basename(path),
                              "logits_max_abs_err": err}
            if not ok:
                failed.append(f"restored {name} checkpoint: logits {err}")
            del model
        result["checkpoints"] = restored
        reset, read = _kernel_launch_counts()
        reset()
        result["serving"] = _parallel_serving()
        serving_launches = read()
        result["multihost"] = _parallel_multihost(tmp)
    result["launches"] = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
                          + serving_launches[k] for k in serving_launches}
    result["seconds"] = time.perf_counter() - t_phase
    emit("parallel", **result)
    if failed:
        raise AssertionError(f"parallel: {failed}")
    return result


def _forward_lines(peaks, flash_timed, flash_train):
    """One line per timed bf16 d = 64 shape: kernel 1, kernel 2 at dropout
    0 and 0.1 and SDPA's forward at both rates (device time), the bounds and
    the ratios; from phase_flash's timing where it has the shape, else from
    flash_train's."""
    lines = {}
    for (bh, n), row in flash_timed.items():
        t = row["timing"]
        lines[(bh, n)] = {
            "shape": [bh, n, 64], "path": t["path"], "from": "flash",
            "fwd_ms": t["ms"], "fwd_call_ms": t["call_ms"],
            "sdpa_ms": t["library_ms"], "sdpa_call_ms": t["library_call_ms"],
            "fwd_bound_ms": t["bound_ms"], "fwd_ratio": t["ratio"],
            "train_ms": t["train_ms"], "sdpa_train_ms": t["sdpa_ms"],
            "train_bound_ms": t["train_bound_ms"],
            "train_ratio": t["train_ratio"]}
    for bh, n in TRAIN_TIMED:
        if (bh, n) in lines:
            continue
        rows = {rate: flash_train[(bh, n, rate)] for rate in (0.0, 0.1)}
        t0 = rows[0.0]["timing"]
        train = {rate: r["timing"]["fwd_train"] for rate, r in rows.items()}
        fwd_bound = bound_ms(peaks, 4 * bh * n * 64 * 2,
                             4 * bh * n * n * 64, "bf16")[0]
        lines[(bh, n)] = {
            "shape": [bh, n, 64], "path": rows[0.0]["fwd_path"],
            "from": "flash_train", "fwd_ms": t0["fwd_infer_ms"],
            "sdpa_ms": train[0.0]["library_ms"], "fwd_bound_ms": fwd_bound,
            "fwd_ratio": t0["fwd_infer_ms"] / train[0.0]["library_ms"],
            "train_ms": {rate: x["ms"] for rate, x in train.items()},
            "sdpa_train_ms": {rate: x["library_ms"]
                              for rate, x in train.items()},
            "train_bound_ms": train[0.0]["bound_ms"],
            "train_ratio": {rate: x["ms"] / x["library_ms"]
                            for rate, x in train.items()}}
    return list(lines.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    smi, peaks = phase_env()
    flash, flash_timed = phase_flash(peaks, gen)
    phase_flash_keys(peaks, gen)
    phase_flash_bias(peaks, gen)
    variants = phase_flash_variants(peaks, gen)
    upsample = phase_upsample(peaks, gen)
    layer_norm = phase_layer_norm(peaks, gen)
    phase_linear(peaks, gen)
    model = phase_model(gen)
    serving = phase_serving()
    flash_train = phase_flash_train(peaks, gen)
    train = phase_train()
    phase_train_fp32_step()
    phase_train_bf16_dropout_step()
    checkpoint = phase_checkpoint()
    with tempfile.TemporaryDirectory() as tmp:
        paed, trained = phase_paed(tmp)
        sweep = phase_eval_sweep(tmp, trained)
        del trained
    optin = phase_optin(gen)
    conv = phase_conv_families()
    seg = phase_segformer_export_int8()
    reports = phase_reports_tools()
    parallel = phase_parallel()
    emit("done", seconds=time.perf_counter() - t0,
         masks_per_s=model["bfloat16"]["masks_per_s"],
         jobs_per_s=serving["jobs_per_s"],
         train_images_per_s=train["reference"]["images_per_s"])

    src = "visiontransformer_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": src + "flash_attention_fwd.cu",
         "replaces": "visiontransformer_tpu/ops/flash_attention.py:92",
         "launches": serving["launches"]["flash_attention"],
         **{k: flash[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "call_ms",
                                  "library_call_ms", "path")},
         "shape": flash["shape"], "dtype": flash["dtype"]},
        {"name": "upsample_argmax", "route": "cuda",
         "source": src + "upsample_argmax.cu",
         "replaces": "visiontransformer_tpu/ops/upsample_argmax.py:54",
         "launches": serving["launches"]["upsample_argmax"],
         **{k: upsample[k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "call_ms", "library_pair_ms", "path",
             "instantiations", "shape", "out", "in_dtype", "out_dtype",
             "int32_fp32")}},
    ]
    main_row = flash_train[(48, 197, 0.1)]
    for name, key, line in (("flash_attention_fwd_train", "fwd_train", 92),
                            ("flash_attention_bwd_dq", "bwd_dq", 278),
                            ("flash_attention_bwd_dkv", "bwd_dkv", 315)):
        source = "flash_attention_fwd.cu" if key == "fwd_train" else (
            f"flash_attention_{key}.cu")
        errs = [main_row[k]["max_abs_err"] for k in (
            ("out",) if key == "fwd_train" else
            ("dq",) if key == "bwd_dq" else ("dk", "dv"))]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": f"visiontransformer_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": max(errs),
            **{k: main_row["timing"][key][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": main_row["shape"], "dtype": main_row["dtype"],
            "dropout": main_row["rate"], "path": main_row["path"],
            "n3137": flash_train[(24, 3137, 0.1)]["timing"][key]})
    for bh, n in TRAIN_TIMED:
        for rate in (0.0, 0.1):
            t = flash_train[(bh, n, rate)]["timing"]
            emit("flash_train_backward", shape=[bh, n, 64], rate=rate,
                 path=flash_train[(bh, n, rate)]["path"],
                 dq_ms=t["bwd_dq"]["ms"], dkv_ms=t["bwd_dkv"]["ms"],
                 dq_given_delta_ms=t["bwd_dq"]["given_delta_ms"],
                 delta_ms=t["bwd_dq"]["delta_ms"],
                 delta_torch_ms=t["bwd_dq"]["delta_torch_ms"],
                 bwd_sum_ms=t["bwd_sum_ms"], sdpa_bwd_ms=t["sdpa_bwd_ms"],
                 ratio=t["bwd_sum_ms"] / t["sdpa_bwd_ms"])
    for line in _forward_lines(peaks, flash_timed, flash_train):
        emit("flash_forward", **line)
    for row in kernels:  # kernels 1-5: their launches on phases 10-13
        row["checkpoint_launches"] = checkpoint["path_launches"][row["name"]]
        row["paed_launches"] = paed["path_launches"][row["name"]]
        row["eval_sweep_launches"] = sweep["path_launches"][row["name"]]
        row["optin_launches"] = optin["path_launches"][row["name"]]
    kernels += variants
    # Kernels 1-9 on the paths of phases 14 and 15: none, but kernel 1 in
    # phase 15's MiT rows.
    for row in kernels:
        row["conv_families_launches"] = conv["launches"][row["name"]]
        row["segformer_export_int8_launches"] = seg["launches"][row["name"]]
        row["reports_tools_launches"] = reports["launches"][row["name"]]
        row["parallel_launches"] = parallel["launches"][row["name"]]
    for row in variants:  # the sweeps' kernels stay off the parallel path
        if row["parallel_launches"]:
            raise AssertionError(f"{row['name']} launched on the parallel "
                                 f"path")
    kernels.append({"name": "layer_norm", "route": "cuda",
                    "source": src + "layer_norm.cu", "replaces": None,
                    **layer_norm})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
