#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (focoos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the repository root, on a machine with an H100
    python3 chip_smoke.py --only-export    # the build and the export phase (14) alone; no result line

Phases, each printing its own lines; any failure raises and the exit code is
non-zero:

1. device — asserts CUDA, prints the card and its power limit, turns TF32 off
   for cuDNN convolutions and matmuls (every number below is full fp32);
2. build  — compiles the four kernels from focoos_tpu_torch/csrc, one nvcc
   each, all started together;
3. msda   — the MSDA kernel against its plain PyTorch version at the main
   path's shapes (B=16, f32 and bf16 values, locations in [-0.2, 1.2]) and at
   two odd shapes (D=8: vector path, D=24: general path); errors, kernel and
   plain device times (``time_ms``), the bound from these inputs (value rows
   touched, counted on the card) and the share of it the kernel reaches;
   msda_backward — the MSDA backward kernel against the plain version's
   autograd, the same way (main shape; the training batch B=8; odd D=48,
   Lq=37, two unequal levels);
4. stem   — the fused stem kernel against its plain version at 640², B=1 and
   16, at an odd 641x479 B=3 and on inputs scaled x64 (131x67 B=2), each in
   f32 and bf16; errors and both times;
5. slice  — ModelManager.get("fai-detr-l-coco") at full width (ResNet-50,
   300 queries, 6 decoder layers) with seeded random weights, the MSDA
   sampling kernels and the BatchNorms perturbed so that they do work;
   answers infer() on three 480x640 images and model(batch) on 16 at 640²,
   checks each kernel ran 6x / 1x per forward, compares a B=2 forward against
   the same weights on the CPU (plain versions), times b1 and b16, and
   holds both MSDA kernels against their plain versions on the locations and
   weights its last decoder layer samples in the b16 forward;
   train  — fai-detr-l at full width (seeded weights perturbed as for the
   slice) on 32 seeded 640² images with 1-20 boxes each: first one training
   step on the card against the same step on the CPU at B=2 (every loss key,
   the gradient norm; the matcher's assignments compared first); then
   FocoosModel.train with B=8, AdamW + EMA, checking that both MSDA kernels
   ran once per decoder layer per step and every loss is finite; then step
   p50, images/s and peak memory over timed steps, one profiled step (device
   idle share, the MSDA kernels' share) and the auction timed alone;
6. nms    — the greedy NMS kernel against its plain version on clustered
   boxes (duplicates, zero-area boxes, a zero-score tail): B=16 K=300 thr
   0.65 (the main path's batch), B=1 K=300 (one infer() request), K=1024,
   an odd K=37, and boxes with NaN and infinite coordinates; keep masks must
   be equal; kernel/plain device times, the launch floor (``time_ms`` of an
   empty sleep kernel), the share of the bound beside the time above the
   floor, and the wrapper's host time per call;
7. rtmo   — ModelManager.get("rtmo-l-coco") at full width (CSPDarknet-L,
   hybrid neck, 512-wide head, 17 keypoints) with seeded random weights, the
   BatchNorms, the classifier/box biases and DCC's bin logits perturbed so
   that the 300 candidates are filled and overlap; answers infer() on three
   480x640 images and model(batch) on 16 at 640², checks the NMS kernel ran
   once per forward and suppressed something, compares a B=2 forward against
   the same weights on the CPU by anchor index, and times b1 and b16;
8. lifecycle — fai-detr-l's fine-tune-and-evaluate lifecycle at 640²:
   ``evaluate_dataset`` in fp32 and bf16 against pseudo-GT (the CPU's fp32
   top 80 detections of 4 seeded images together; the CPU's own evaluation
   beside it; an oracle scores 100), evaluation
   images/s over 64 images at batch 8 beside the b16 forward's, the card's
   idle share during evaluation; rtmo-l keypoint evaluation the same way;
   then FocoosModel.train (6 steps at B=8, an 8-image val_dataset,
   eval_period 3, checkpointer_period 3), a state loaded from its last
   checkpoint compared bit for bit with the saved one, a resumed trainer to
   9 steps, and FocoosModel.eval on the final weights; each run with its
   kernels' launch counts;
9. finetune_m — fai-detr-m (STDC, no AIFI layer, 3 decoder layers) at full
   width and depth, 640², fine-tuned from a dataset on disk: the host's
   cores and image libraries; a seeded Roboflow-COCO set written to local
   disk (64 train and 16 val JPEGs, 1-3 boxes of 3 classes); the val split
   through the loader with 4 worker processes and in process (bit-equal
   batches, in order); the train loader timed alone at B=16 with the fai
   detection augmentations; one fp32 step on the card against the CPU's
   step in fp64 on mapped train records; FocoosModel.train (B=16, 10 steps, validation every 5) in fp32
   and in bf16, each with step and data_time p50, peak memory, bbox/AP and
   three profiled steps after it; FocoosModel.eval; both MSDA kernels on
   the fine-tuned model's captured locations; b1 and b16 serving in fp32
   and bf16. Every counted run starts its MSDA counts at 0;
10. fai_mf — fai-mf-l-coco-ins at 1024² and fai-mf-l-ade at 640², served
   and evaluated in fp32 and bf16 (``phase_mf``); on the instance card's B=1
   forwards of a seeded image (the mask logits sharpened) ``panoptic_inference``
   on the card and on the CPU, the card's fp32 map scored by
   ``PanopticEvaluator`` against the CPU's (PQ ≥ 99; bf16 reported);
11. segm_train — mask-classification training at full width: one
   fai-mf-l-ade step (B=2 640²) on the card against the CPU's step in fp64
   on its attention masks, points and assignment, fp32 and bf16; then
   fai-mf-l-coco-ins fine-tuned at 1024² from a seeded instance set of
   640x480 JPEGs written to disk (the train loader alone; validation at the
   preset's 1024 raising the resized-record ValueError of ROADMAP Queue 3;
   FocoosModel.train at B=8 with validation at 480 in fp32 and bf16; a
   24-step loop without validation timed whole, its last steps profiled;
   the criterion alone; FocoosModel.eval); then bisenetformer-l-ade at 640² (infer(), card vs
   CPU forwards, b1/b16, evaluation against the CPU's own predictions, one
   step against the CPU, FocoosModel.train at B=16 from a semantic set on
   disk, fp32 and bf16). The stem's launches count from 0 before each
   counted run;
12. fai_cls — fai-cls-m-coco (STDC-small, 80 classes) at 224², full width,
   the classifier conditioned (``condition_cls``): infer() on three 480x640
   images, card vs CPU probabilities at B=2 (fp32 and bf16, the CPU's own
   bf16 beside), b1 and b128 forwards and a profiled b128, evaluate_dataset
   against the CPU's fp32 predictions (classification/f1), one step against
   the CPU's fp64 step on one dropout mask carried to both, the train loader
   alone and FocoosModel.train at B=64 from a seeded folder-per-class set on
   disk (fp32 and bf16, three profiled steps), FocoosModel.eval; no kernel
   of the port may launch;
13. rtmo_train — rtmo-s-coco at 640², full width (``perturb_rtmo``,
   ``condition_for_training``): one B=2 step on mapped records of a seeded
   COCO-keypoints set on disk, the card's SimOTA equal to the CPU's, then
   on the CPU's assignment against the CPU's fp64 step (every loss, the
   gradient norm, DCC's running statistics; bf16 too); the train loader and
   the criterion alone; FocoosModel.train at B=16 with keypoint validation
   at 480 (fp32 and bf16, profiled steps) and FocoosModel.eval, the NMS
   kernel counted from 0 before each run: one launch a validation forward;
   user_data — a user's own dataset through the port's data and training
   API, fai-detr-l-coco at full width (``phase_user_data``): a seeded
   Supervisely folder (32 + 8 JPEGs of 640x480) converted to the
   Roboflow-COCO layout by ``data/converters.py`` (one image and its mask
   resized too), the train split mapped through a user augmentation list
   (brightness, contrast, saturation, lighting, min-IoU crop, extent,
   resize-scale, fixed-size crop), then K=2 against K=1 (4 steps each from
   the same weights: each call's metrics against the mean of its two K=1
   steps, each inner step's LR and, under SGD, the parameters' distance
   against how far the steps moved them; two planted faults, a repeated
   batch and a skipped update, must fail that gate; AdamW's first call),
   FocoosModel.train at B=8 with ``steps_per_call=2`` for 12 steps
   (checkpoints every 5 named by JAX's rule, ``ProfilerHook`` over calls
   3–4 with its trace parsed by ``utils/profiling.py``, the TensorBoard
   writer where tensorboardX imports, validation at 480), a resume from
   model_0000005, ``retry_if_oom`` on the card and ``device_op_ms`` of a b8
   forward; every kernel counted from 0 before each run;
14. export — serving from exported directories (``focoos_tpu_torch/infer``):
   fai-detr-l-coco at 640² through ``FocoosModel.export`` and ``InferModel``
   in ``CUDA_FP32`` and ``CUDA_BF16`` (outputs against FocoosModel.forward
   of the same dtype, infer() against FocoosModel.infer), as a
   ``torch.export`` program at b1 with a 512² bucket (a fresh load against
   the eager forward, the bucket taken exactly, a batch of 3 padded and
   chunked; a bf16 program and its weight casts) and as ``CUDA_INT8``
   (``Quantizer`` with 8 seeded JPEGs for calibration; the card's int8
   forward against the CPU's on the CPU's query selection for three seeded
   images, the bf16 pair beside it; no stem launch); rtmo-l-coco's program
   with NMS inside; one bf16 request of fai-cls-m, bisenetformer-l,
   fai-mf-l-coco-ins and rtmo-s equal to FocoosModel.infer(); then b1 p50
   and b16 images/s of each runtime against FocoosModel's, in turns, with
   FocoosModel also run with its wrappers calling the kernels without their
   custom ops; the ops' host cost a call; end-to-end breakdowns;
15. distributed — training and evaluation across processes
   (``focoos_tpu_torch/parallel``), fai-detr-l-coco at full width, 640²,
   fp32, SGD at lr 1e-2 (``phase_distributed``): (a) ``FocoosModel.train``
   under ``dp`` in a launched NCCL world of 1 and (b) under ``fsdp``, 4 steps
   at B=8 each, against the same steps with no process group (and a second
   such run: the MSDA backward's atomics gap), fsdp's ``model_final.npz``
   keys and shapes against dp's; (c) one step on two gloo ranks of this card
   (4 images a rank) against one process at B=8 on its query selection and
   assignment, and two planted faults (each rank's own box count, its own
   BatchNorm statistics) that must fail that gate; (d) two ranks evaluating
   16 images at batch 8 split 9 and 7 against one process's
   ``evaluate_dataset`` (bbox/AP to 1e-9, one stem launch an eval forward
   on each rank).

Each model path runs again in bf16 compute (``ModelManager.get(...,
dtype="bfloat16")``, fp32 parameters), right after its fp32 run and with its
own launch counts: fai-detr-l serving (the requests, the kernels' launches,
card bf16 and card fp32 each against the CPU's fp32 result on the CPU's query
selection, b1 with and without the cast-weight cache, b16, a profiled b16
forward beside an fp32 one, both MSDA kernels on bf16 captured locations),
fai-detr-l training at B=8 (one step against the CPU's fp32 step on the CPU's
selection and assignment, FocoosModel.train, step p50, images/s, peak
memory, a profiled step) and rtmo-l serving (the requests, card bf16 against
the CPU's fp32 result by anchor index, b1, b16). The msda, msda_backward and
stem phases time the bf16 kernels beside the fp32 ones (MSDA backward also
at the training batch B=8), each with its bound and share.

The last three lines are the kernels' JSON record (``launches`` from the
serving and training main paths, ``launches_lifecycle``,
``launches_finetune_m``, ``launches_fai_mf``, ``launches_segm_train``,
``launches_fai_cls``, ``launches_rtmo_train``, ``launches_user_data``,
``launches_export`` and ``launches_distributed`` (every rank's) summed over
those phases' counted runs), the card's
name and power limit as
nvidia-smi reports them, and the result JSON.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

MSDA_SHAPES = ((20, 20), (40, 40), (80, 80))  # fai-detr-l at 640²: p5, p4, p3
# × max|ref|: fp32 sums in another order; bf16 output rounded once (2^-8) by the kernel
MSDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# (d value, d loc, d aw) × max|ref|. fp32: d value and d aw 1e-5 (sums in another
# order; the kernel's atomics add in a run-dependent order), d loc 1e-4 (a
# difference of corner values scaled by the map size). bf16 values: 2^-7 for
# all three (d value accumulates in fp32 and the kernel rounds it to bf16 once)
MSDA_BWD_TOL = {torch.float32: (1e-5, 1e-4, 1e-5), torch.bfloat16: (2.0**-7,) * 3}
# × max|ref|: f32 operands carried as bf16 hi + lo pairs on the tensor cores (~16
# bits, ~1e-5 over three convs); bf16 weights, y1, y2 and output rounded (~5e-3)
STEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
# card vs CPU on the whole model, fp32 both sides: ResNet-50 + 7 transformer
# layers of differently ordered sums; scores are sigmoids, boxes normalized
SLICE_TOL = 1e-3
# two queries whose selection scores differ by less than this (relative to
# the score spread) may swap between devices without either being wrong
NEAR_TIE = 1e-4
# rtmo-l card vs CPU, fp32 both sides: absolute on sigmoid scores and
# keypoint visibilities, × max|ref| on absolute-pixel boxes and keypoints
RTMO_TOL = 1e-3
# one training step, card vs CPU, fp32 both sides, TF32 off: each loss key
# (relative) and the global norm of the gradients (relative)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_BATCH = 8  # images per step in the timed training run
# card bf16 vs CPU fp32 (B=2) and vs CPU bf16 (B=1) on the CPU's query
# selection, fai-detr-l: abs on sigmoid scores and normalized boxes. A bf16
# model rounds each of ~110 layers' outputs to 8 bits (2^-8 relative); on a
# tiny ResNet-18 model the port's bf16 result lies 5e-3 from its fp32 one
SLICE_BF16_TOL = 5e-2
# rtmo-l in bf16, one image: the card's raw head outputs (every anchor) lie
# from the CPU's fp32 ones within twice as far as the CPU's own bf16 run does,
# plus one bf16 step of the output's scale (2^-8 × max|ref|). Two bf16 runs
# round in other orders, and perturb_rtmo's random CSPDarknet-L amplifies a
# rounding difference into logits: its keypoint visibilities differ by up to
# 0.24 after the sigmoid between the card's and the CPU's bf16 runs, so the
# detections are reported and not held to a fixed tolerance
# one bf16 training step on the card vs the CPU's fp32 step, both on the CPU's
# selection and assignment: each loss key within TRAIN_BF16_TOL of the total
# loss (a small VFL term moves 16% of itself from fp32 to bf16 on a tiny
# ResNet-18 model, 0.017% of the total), the total and the gradient norm
# relative (that model: 0.14% and 10%)
TRAIN_BF16_TOL = 1e-2
TRAIN_BF16_GRAD_NORM_RTOL = 0.25
# kernel names of cuDNN's convolutions (implicit GEMM, FFT, Winograd, their
# data and weight gradients) and of its layout transposes, for the profiles
CONV_KERNEL_MARKS = ("conv", "fprop", "dgrad", "wgrad", "fft", "winograd", "implicit")
TRANSPOSE_KERNEL_MARKS = ("nchwtonhwc", "nhwctonchw", "transpose")
SLEEP_CYCLES = 20_000_000  # ~11 ms of the card's clock: longer than the host takes to queue 20 kernel calls
LIFECYCLE_SIZE = 640  # the images of the lifecycle phase: the registry cards' size
LIFECYCLE_GT = 20  # pseudo-GT: the CPU's fp32 top 20 x images detections over all images together
# the pseudo-GT's cut moves past score gaps under this (card and CPU fp32 sigmoid scores agree to ~2e-6)
GT_SCORE_GAP = 1e-4
EVAL_IMAGES, EVAL_BATCH = 64, 8  # evaluation throughput
LIFECYCLE_BATCH = 8  # the fine-tune's batch and its val_dataset's size
# finetune_m: the seeded dataset's splits, the fine-tune's batch, steps and
# validation period, and the profiled steps after it
FT_TRAIN, FT_VAL = 64, 16
FT_BATCH, FT_STEPS, FT_EVAL_PERIOD, FT_PROFILED = 16, 10, 5, 3  # cut from 20 and 10: the script's time limit


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``calls`` calls queued behind a sleep kernel,
    so that the host's time in the wrapper (checks, allocation, the ctypes
    call) is hidden, between two CUDA events; the median of ``reps`` such
    runs. One call at a time between events measures the host instead
    wherever a kernel is shorter than its wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def host_ms(fn, calls: int = 1000) -> float:
    """Host time of one call: the host clock over ``calls`` calls with no
    sync in between (what a host-bound caller pays per call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    assert out.shape == ref.shape, f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)}"
    err = float((out.float() - ref.float()).abs().max())
    bound = tol * float(ref.float().abs().max())
    assert err <= bound, f"{what}: max_abs_err {err} > tolerance {bound}"
    return err


# ---------------------------------------------------------------------------
# least times of the card (NVIDIA's H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound(nbytes: float, ops: float, kind: str = "fp32") -> dict:
    """The least time for moving ``nbytes`` (each input read once, each output
    written once) and doing ``ops`` operations of ``kind``: the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def msda_rows_touched(value: torch.Tensor, ss, loc: torch.Tensor) -> int:
    """Distinct value rows (b, s, h) that a valid bilinear corner reads: the
    rows the kernels must read at least once for these locations."""
    b, s, hh, _ = value.shape
    bi = torch.arange(b, device=loc.device)[:, None, None, None]
    hi = torch.arange(hh, device=loc.device)[None, None, :, None]
    rows, start = [], 0
    for lid, (h, w) in enumerate(ss):
        x = torch.floor(loc[:, :, :, lid, :, 0] * w - 0.5)  # [B, Lq, Hh, P]
        y = torch.floor(loc[:, :, :, lid, :, 1] * h - 0.5)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x + dx, y + dy
                ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                pos = start + (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
                rows.append(((bi * s + pos) * hh + hi)[ok])
        start += h * w
    return int(torch.unique(torch.cat(rows)).numel())


def msda_bound(kernel: str, value: torch.Tensor, ss, loc: torch.Tensor, aw: torch.Tensor) -> dict:
    """Bound of the MSDA forward or backward on these inputs. Bytes: the value
    rows the samples touch (counted on the card), loc, aw, and the outputs —
    forward out [B, Lq, Hh*D]; backward the incoming gradient, d value
    (written whole, zeros included), d loc and d aw. Operations: 2 per corner
    and channel forward (one FMA), 4 backward (the dot's FMA, the scaled
    atomic add), fp32."""
    rows = msda_rows_touched(value, ss, loc)
    b, s, hh, d = value.shape
    e = value.element_size()
    out = b * loc.shape[1] * hh * d * e
    nbytes = rows * d * e + 4 * (loc.numel() + aw.numel()) + out
    corners = 4 * aw.numel() * d
    if kernel == "forward":
        res = bound(nbytes, 2 * corners)
    else:
        res = bound(nbytes + value.numel() * e + 4 * (loc.numel() + aw.numel()), 4 * corners)
    return {**res, "rows_touched": rows, "rows": b * s * hh}


def msda_case(g: torch.Generator, b, lq, hh, d, ss, dev, p: int = 4):
    """Seeded values in [-0.5, 0.5), uniform locations in [-0.2, 1.2] (some
    corners outside the map), softmaxed attention weights, a gradient."""
    s = sum(h * w for h, w in ss)
    v = (torch.rand(b, s, hh, d, generator=g) - 0.5).to(dev)
    loc = (torch.rand(b, lq, hh, len(ss), p, 2, generator=g) * 1.4 - 0.2).to(dev)
    aw = torch.softmax(torch.randn(b, lq, hh, len(ss) * p, generator=g), -1).reshape(b, lq, hh, len(ss), p).to(dev)
    return v, loc, aw, torch.randn(b, lq, hh * d, generator=g).to(dev)


def check_msda_forward(label: str, v, ss, loc, aw) -> dict:
    """The forward kernel against its plain version on these inputs: error,
    kernel and plain device times, bound and share."""
    from focoos_tpu_torch.ops.deformable import ms_deform_attn
    from focoos_tpu_torch.ops.msda import msda_forward, vector_path

    out = msda_forward(v, ss, loc, aw)
    torch.cuda.synchronize()
    err = max_err(out, ms_deform_attn(v.float(), ss, loc, aw), MSDA_TOL[v.dtype], f"msda {label} {v.dtype}")
    ms = time_ms(lambda: msda_forward(v, ss, loc, aw))
    plain_ms = time_ms(lambda: ms_deform_attn(v, ss, loc, aw))
    bd = msda_bound("forward", v, ss, loc, aw)
    path = "vector" if vector_path("forward", v) else "general"
    log(f"[msda] {label} {str(v.dtype)[6:]}: max_abs_err {err:.3e} (tol {MSDA_TOL[v.dtype]:.1e} x max|ref|)"
        f" | {path} path, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms | bound {bd['bound_ms']:.4f} ms"
        f" ({bd['bound_by']}; {bd['rows_touched']} of {bd['rows']} value rows touched), kernel at"
        f" {bd['bound_ms'] / ms:.1%} of it")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "path": path}


def check_msda_backward(label: str, v, ss, loc, aw, grad) -> dict:
    """The backward kernel against the plain version's autograd, as above."""
    from focoos_tpu_torch.ops.deformable import ms_deform_attn_backward_reference
    from focoos_tpu_torch.ops.msda import msda_backward, vector_path

    got = msda_backward(v, ss, loc, aw, grad)
    torch.cuda.synchronize()
    ref = ms_deform_attn_backward_reference(v.float(), ss, loc, aw, grad.float())
    tols = MSDA_BWD_TOL[v.dtype]
    errs = [max_err(o, r, tol, f"msda_backward {label} {v.dtype} {name}")
            for o, r, tol, name in zip(got, ref, tols, ("d value", "d loc", "d aw"))]
    ms = time_ms(lambda: msda_backward(v, ss, loc, aw, grad))
    plain_ms = time_ms(lambda: ms_deform_attn_backward_reference(v, ss, loc, aw, grad))
    bd = msda_bound("backward", v, ss, loc, aw)
    path = "vector" if vector_path("backward", v, grad.to(v.dtype)) else "general"
    ulps = errs[0] / (2.0**-8 * float(ref[0].abs().max()))
    log(f"[msda_backward] {label} {str(v.dtype)[6:]}: max_abs_err d value {errs[0]:.3e} ({ulps:.2f} x 2^-8 max|ref|),"
        f" d loc {errs[1]:.3e}, d aw {errs[2]:.3e} (tol {' / '.join(f'{t:.1e}' for t in tols)} x max|ref|) | {path} path, kernel"
        f" {ms:.4f} ms (with the zero fill of d value), plain (autograd) {plain_ms:.4f} ms | bound"
        f" {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {bd['rows_touched']} of {bd['rows']} value rows touched),"
        f" kernel at {bd['bound_ms'] / ms:.1%} of it")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "path": path}


MSDA_MAIN = (16, 300, 8, 32, MSDA_SHAPES)  # B, Lq, Hh, D, levels: fai-detr-l at 640², b16
MSDA_MAIN_LABEL = "main path B=16 Lq=300 Hh=8 D=32 levels 20²,40²,80² P=4, uniform locations"


def phase_msda(dev) -> dict:
    """→ {dtype: the main path's record at B=16}."""
    g = torch.Generator().manual_seed(0)
    record = {}
    for (b, lq, hh, d, ss), label in (
        (MSDA_MAIN, MSDA_MAIN_LABEL),
        ((2, 37, 3, 8, ((9, 11), (5, 6), (3, 2))), "odd B=2 Lq=37 Hh=3 D=8 levels 9x11,5x6,3x2 P=4"),
        ((2, 37, 3, 24, ((9, 11), (5, 6), (3, 2))), "odd B=2 Lq=37 Hh=3 D=24 levels 9x11,5x6,3x2 P=4"),
    ):
        v32, loc, aw, _ = msda_case(g, b, lq, hh, d, ss, dev)
        for dtype in (torch.float32, torch.bfloat16):
            rec = check_msda_forward(label, v32.to(dtype), ss, loc, aw)
            if b == 16:
                record[dtype] = rec
    return record


def phase_msda_backward(dev) -> dict:
    """→ {dtype: the main path's record at B=16}."""
    g = torch.Generator().manual_seed(5)
    record = {}
    for (b, lq, hh, d, ss), dtypes, label in (
        (MSDA_MAIN, (torch.float32, torch.bfloat16), MSDA_MAIN_LABEL),
        ((8, 300, 8, 32, MSDA_SHAPES), (torch.float32, torch.bfloat16),
         "training batch B=8 Lq=300 Hh=8 D=32, uniform locations"),
        ((2, 37, 3, 48, ((9, 11), (5, 6))), (torch.float32, torch.bfloat16), "odd B=2 Lq=37 Hh=3 D=48 levels 9x11,5x6 P=4"),
    ):
        v32, loc, aw, grad32 = msda_case(g, b, lq, hh, d, ss, dev)
        for dtype in dtypes:
            rec = check_msda_backward(label, v32.to(dtype), ss, loc, aw, grad32.to(dtype))
            if b == 16:
                record[dtype] = rec
    return record


def capture_msda_inputs(module, x: torch.Tensor, layer: int) -> tuple:
    """(value, spatial shapes, loc, aw) that decoder layer ``layer`` hands the
    MSDA forward in one inference forward of ``module`` on ``x``."""
    import focoos_tpu_torch.models.fai_detr.modelling as modelling

    calls, real = [], modelling.msda_forward

    def spy(v, ss, loc, aw):
        calls.append((v, [tuple(hw) for hw in ss], loc, aw))
        return real(v, ss, loc, aw)

    modelling.msda_forward = spy
    try:
        with torch.inference_mode():
            module(x)
    finally:
        modelling.msda_forward = real
    v, ss, loc, aw = calls[layer]
    return v.clone(), ss, loc.clone(), aw.clone()  # clones outside inference mode: ordinary tensors


def phase_stem(dev) -> dict:
    """→ {dtype: the record at 640² B=16, "1024": {(B, dtype): the records at 1024² B=1 and B=8}}."""
    from focoos_tpu_torch.ops.stem import fused_resnet_stem, resnet_stem_reference

    g = torch.Generator().manual_seed(1)
    params = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        params += [
            (torch.randn(3, 3, cin, cout, generator=g) * (2.0 / (9 * cin)) ** 0.5).to(dev),
            (1 + 0.1 * torch.randn(cout, generator=g)).to(dev),
            (0.1 * torch.randn(cout, generator=g)).to(dev),
        ]
    record = {"1024": {}}
    for b, h, w, scale, label in (
        (1, 640, 640, 1.0, "640x640 B=1"),
        (16, 640, 640, 1.0, "640x640 B=16"),
        (1, 1024, 1024, 1.0, "1024x1024 B=1"),
        (8, 1024, 1024, 1.0, "1024x1024 B=8"),
        (3, 641, 479, 1.0, "odd 641x479 B=3"),
        (2, 131, 67, 64.0, "131x67 B=2 inputs x64"),
    ):
        x32 = (torch.randn(b, h, w, 3, generator=g) * scale).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            out = fused_resnet_stem(x, *params)
            torch.cuda.synchronize()
            err = max_err(out, resnet_stem_reference(x.float(), *params), STEM_TOL[dtype], f"stem {label} {dtype}")
            ms = time_ms(lambda: fused_resnet_stem(x, *params))
            plain_ms = time_ms(lambda: resnet_stem_reference(x, *params))
            log(f"[stem] {label} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {STEM_TOL[dtype]:.1e} x max|ref|)"
                f" | kernel {ms:.4f} ms, plain (cuDNN convs) {plain_ms:.4f} ms")
            if label in ("640x640 B=16", "1024x1024 B=1", "1024x1024 B=8"):
                # three 3x3 convs (conv1 stride 2, then at its resolution) on the tensor cores
                # (the TF32 peak for f32, bf16's for bf16), the input read and the pooled output written once
                h1, w1 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
                ops = 2 * 9 * b * h1 * w1 * (3 * 32 + 32 * 32 + 32 * 64)
                kind = "tf32" if dtype == torch.float32 else "bf16"
                bd = bound((x.numel() + out.numel()) * x.element_size(), ops, kind)
                log(f"[stem] {label} {str(dtype)[6:]}: bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}:"
                    f" {ops / 1e9:.1f} GFLOP at the {kind.upper()} peak), kernel at {bd['bound_ms'] / ms:.1%} of it")
                rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd}
                if label == "640x640 B=16":
                    record[dtype] = rec
                else:
                    record["1024"][(b, dtype)] = rec
    return record


# ---------------------------------------------------------------------------
@torch.no_grad()
def perturb(module: torch.nn.Module, seed: int) -> None:
    """Seeded perturbation of what random init leaves degenerate: the MSDA
    sampling-offset / attention-weight kernels are zeros (every query would
    sample the same radial grid with uniform weights) and the BatchNorms are
    identities (the stem's folded BN would be trivial)."""
    from focoos_tpu_torch.models.fai_detr.modelling import MSDeformableAttention

    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, MSDeformableAttention):
            for lin, std in ((m.sampling_offsets, 0.02), (m.attention_weights, 0.05)):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * std)
        elif isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
            m.bias.copy_(torch.randn(c, generator=g) * 0.05)
            m.running_mean.copy_(torch.randn(c, generator=g) * 0.05)
            m.running_var.copy_(torch.rand(c, generator=g) + 0.5)


def selection(model, x: torch.Tensor):
    """(top-k indices [B, Q], selection scores [B, S]) of the encoder query selection."""
    from focoos_tpu_torch.models.fai_detr.modelling import _anchor_tensors

    pred = model.predictor
    memory, ss = pred.flatten_levels(model.encode(x))
    _, valid = _anchor_tensors(tuple(ss), memory.device)
    scores = pred.enc_score_classifier(pred.enc_output(memory * valid.to(memory.dtype))).max(-1).values
    return pred.select_queries(memory, ss)[0], scores


def compare_devices(gpu_model, cpu_model, x_uint8: np.ndarray) -> tuple:
    """Forward the same batch on both modules; compare the selected query
    indices first, then boxes and scores row by row. Rows are matched by
    query index, so two near-tied queries that swap rank compare as
    themselves. An image whose selected set differs (a near-tie at the
    cut-off) is reported and left out. Returns (the images compared, the
    CPU's (boxes, scores, selected indices))."""
    outs, sels = [], []
    for m in (gpu_model, cpu_model):
        dev = next(m.parameters()).device
        x = torch.from_numpy(x_uint8).to(dev)
        with torch.inference_mode():
            out, _ = m(x)
            idx, scores = selection(m, x)
        outs.append((out.boxes.float().cpu(), out.logits.float().cpu()))
        sels.append((idx.cpu(), scores.float().cpu()))
    (gb, gl), (cb, cl) = outs
    (gi, gs), (ci, cs) = sels
    compared = 0
    for b in range(x_uint8.shape[0]):
        g_idx, c_idx = gi[b].tolist(), ci[b].tolist()
        spread = float(cs[b].max() - cs[b].min())
        if g_idx != c_idx:
            moved = sorted(set(g_idx) ^ set(c_idx))
            order = [r for r in range(len(g_idx)) if g_idx[r] != c_idx[r]]
            gaps = [abs(float(cs[b, g_idx[r]] - cs[b, c_idx[r]])) / spread for r in order]
            log(f"[slice] image {b}: top-k flip between card and CPU at {len(order)} ranks"
                f" (largest score gap {max(gaps):.2e} of the spread), {len(moved)} indices in only one set")
            assert max(gaps) < NEAR_TIE, f"image {b}: selection differs beyond a near-tie"
            if moved:
                log(f"[slice] image {b}: selected sets differ at the cut-off (near-tie); values not compared")
                continue
        pos = {q: r for r, q in enumerate(c_idx)}
        perm = torch.tensor([pos[q] for q in g_idx])
        box_err = float((gb[b] - cb[b][perm]).abs().max())
        score_err = float((gl[b] - cl[b][perm]).abs().max())
        sel_err = float((gs[b] - cs[b]).abs().max())
        log(f"[slice] image {b}: query selection {'identical' if g_idx == c_idx else 'same set'};"
            f" card vs CPU max_abs_err boxes {box_err:.3e}, scores {score_err:.3e}"
            f" (tol {SLICE_TOL:.0e}); selection logits {sel_err:.3e}")
        assert box_err <= SLICE_TOL and score_err <= SLICE_TOL, f"image {b}: card and CPU disagree"
        compared += 1
    return compared, (cb, cl, ci)


@contextlib.contextmanager
def carried_selection(predictor, idx: torch.Tensor):
    """``predictor`` takes the query indices ``idx`` [B, Q] instead of its own top-k."""
    real = type(predictor).select_queries
    predictor.select_queries = lambda memory, ss: real(predictor, memory, ss, idx.to(memory.device))
    try:
        yield
    finally:
        del predictor.select_queries


def compare_to_cpu(models: dict, cpu_ref: tuple, x_uint8: np.ndarray) -> dict:
    """Each card module's boxes and scores against a CPU result (boxes,
    scores, selected indices), on the CPU's query selection → {name: (box
    err, score err)}."""
    cb, cl, ci = cpu_ref
    errs = {}
    for name, m in models.items():
        x = torch.from_numpy(x_uint8).to(next(m.parameters()).device)
        with carried_selection(m.predictor, ci), torch.inference_mode():
            out, _ = m(x)
        errs[name] = (float((out.boxes.float().cpu() - cb).abs().max()), float((out.logits.float().cpu() - cl).abs().max()))
    return errs


def serve_timings(module, xs: dict, reps: dict, before=None) -> dict:
    """{name: p50 seconds} of synchronized forwards of ``module`` on each input
    (host clock), after three warm-up forwards; ``before`` runs untimed
    ahead of each timed forward."""
    out = {}
    with torch.inference_mode():
        for name, x in xs.items():
            for _ in range(3):
                module(x)
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps[name]):
                if before is not None:
                    before()
                t = time.perf_counter()
                module(x)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            out[name] = float(np.median(ts))
    return out


def kernel_shares(by_name: dict, busy: float) -> dict:
    """Device time of cuDNN's convolutions and of its layout transposes, each as a share of busy."""
    conv = sum(v for k, v in by_name.items() if any(m in k.lower() for m in CONV_KERNEL_MARKS))
    transpose = sum(v for k, v in by_name.items() if any(m in k.lower() for m in TRANSPOSE_KERNEL_MARKS))
    return {"conv": conv / busy, "transpose": transpose / busy}


def profile_forwards(tag: str, what: str, module, x: torch.Tensor, n: int = 2) -> dict:
    """``n`` inference forwards under the profiler: wall, device busy, idle
    share, launches, the conv and transpose shares and the largest kernels, logged."""
    with torch.inference_mode():
        module(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                module(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
    busy, by_name = device_busy(prof)
    launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    sh = kernel_shares(by_name, busy)
    log(f"[{tag}] profiled {what}, {n} forwards: wall {wall / n / 1e3:.2f} ms, device busy {busy / n / 1e3:.2f} ms a"
        f" forward, idle share {1 - busy / wall:.3f}, {launches // n} kernels a forward; cuDNN convolutions"
        f" {sh['conv']:.1%} of busy, layout transposes {sh['transpose']:.1%}")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[{tag}]   {v / n / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")
    return {"busy_ms": busy / n / 1e3, "idle": 1 - busy / wall, **sh}


def check_detections(results, n_images: int, what: str) -> None:
    assert len(results) == n_images, f"{what}: {len(results)} results for {n_images} images"
    for r in results:
        assert len(r.detections) == 300, f"{what}: {len(r.detections)} detections, expected top_k=300"
        for d in r.detections:
            assert np.isfinite(d.conf) and 0.0 <= d.conf <= 1.0 and 0 <= d.cls_id < 80, f"{what}: bad detection {d}"
            assert len(d.bbox) == 4 and all(isinstance(v, int) for v in d.bbox), f"{what}: bad box {d.bbox}"


def phase_slice(dev, smi: str) -> dict:
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.msda import msda_forward
    from focoos_tpu_torch.ops.stem import fused_resnet_stem

    t0 = time.perf_counter()
    model = ModelManager.get("fai-detr-l-coco", device=dev, seed=0)
    perturb(model.module, seed=1)
    cfg = model.config
    n_dec = cfg.transformer_predictor_dec_layers
    log(f"[slice] {model.name}: ResNet-{cfg.backbone_config.depth}{cfg.backbone_config.variant},"
        f" {cfg.num_queries} queries, {n_dec} decoder layers, {cfg.num_classes} classes,"
        f" {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M params, im_size {model.im_size}"
        f" (built in {time.perf_counter() - t0:.1f}s)")

    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(3)]
    batch = rng.integers(0, 256, (16, 640, 640, 3), dtype=np.uint8)

    # the requests: counters start at 0 just before and are read just after
    msda_forward.launches = 0
    msda_forward.paths = {"vector": 0, "general": 0}
    fused_resnet_stem.launches = 0
    single = [model.infer(img, threshold=0.0) for img in images]
    multi = model(batch, threshold=0.0)
    torch.cuda.synchronize()
    launches = {"msda_forward": msda_forward.launches, "fused_resnet_stem": fused_resnet_stem.launches}
    forwards = len(images) + 1
    log(f"[slice] served {len(images)} infer() requests and one batch of {len(batch)}: {forwards} forwards,"
        f" launches msda_forward {launches['msda_forward']} (paths {msda_forward.paths}),"
        f" fused_resnet_stem {launches['fused_resnet_stem']}")
    assert launches["msda_forward"] == n_dec * forwards, "MSDA kernel did not run once per decoder layer"
    assert msda_forward.paths["vector"] == launches["msda_forward"], "the main path left the MSDA vector path"
    assert launches["fused_resnet_stem"] == forwards, "stem kernel did not run once per forward"
    for r in single:
        check_detections([r], 1, "infer")
    check_detections(multi, len(batch), "batch")
    with torch.inference_mode():
        out = model.forward(batch)
    assert out.boxes.shape == (16, cfg.num_queries, 4) and out.logits.shape == (16, cfg.num_queries, cfg.num_classes)
    assert bool(torch.isfinite(out.boxes).all()) and bool(torch.isfinite(out.logits).all()), "non-finite outputs"
    lat = single[-1].latency
    log(f"[slice] detections well-formed; last infer(): preprocess {lat.preprocess * 1e3:.2f} ms,"
        f" inference {lat.inference * 1e3:.2f} ms, postprocess {lat.postprocess * 1e3:.2f} ms")

    # card vs CPU on the same weights (the CPU runs the plain versions)
    t0 = time.perf_counter()
    cpu_model = ModelManager.get("fai-detr-l-coco", device="cpu", seed=0)
    cpu_model.module.load_state_dict(model.module.state_dict())
    compared, cpu_ref = compare_devices(model.module, cpu_model.module, batch[:2])
    assert compared >= 1, "no image could be compared between card and CPU"
    log(f"[slice] card vs CPU: {compared}/2 images compared ({time.perf_counter() - t0:.1f}s)")

    # latency and throughput of the forward (host clock around synchronized calls)
    x1 = torch.from_numpy(batch[:1]).to(dev)
    x16 = torch.from_numpy(batch).to(dev)
    timings = serve_timings(model.module, {"b1": x1, "b16": x16}, {"b1": 30, "b16": 10})
    e2e = []
    for _ in range(10):
        t = time.perf_counter()
        model.infer(images[0])
        e2e.append(time.perf_counter() - t)
    log(f"[slice] {smi}, fp32, TF32 off: b1 forward p50 {timings['b1'] * 1e3:.2f} ms;"
        f" b16 forward p50 {timings['b16'] * 1e3:.2f} ms = {16 / timings['b16']:.1f} images/s;"
        f" infer() 480x640 end to end p50 {np.median(e2e) * 1e3:.2f} ms")
    bench = model.benchmark(iterations=20)
    log(f"[slice] FocoosModel.benchmark(): {bench}")

    # both MSDA kernels on what the model's last decoder layer samples in the b16 forward
    v, ss, loc, aw = capture_msda_inputs(model.module, x16, n_dec - 1)
    label = f"captured from decoder layer {n_dec - 1} of the b16 forward, B=16 Lq=300 Hh=8 D=32"
    check_msda_forward(label, v, ss, loc, aw)
    grad = torch.randn(v.shape[0], loc.shape[1], v.shape[2] * v.shape[3], generator=torch.Generator().manual_seed(9))
    check_msda_backward(label, v, ss, loc, aw, grad.to(dev))
    prof = profile_forwards("slice", "b16 forward fp32", model.module, x16)
    profile_forwards("slice", "b1 forward fp32", model.module, x1, n=4)
    ctx = dict(model=model, cpu_ref=cpu_ref, batch=batch, images=images, timings=timings, profile=prof)
    return launches, ctx


def phase_slice_bf16(dev, smi: str, ctx: dict) -> dict:
    """fai-detr-l serving in bf16 compute on the fp32 phase's weights."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.nn.layers.common import clear_cast_caches
    from focoos_tpu_torch.ops.msda import msda_forward
    from focoos_tpu_torch.ops.stem import fused_resnet_stem

    model32, batch, images = ctx["model"], ctx["batch"], ctx["images"]
    model = ModelManager.get("fai-detr-l-coco", device=dev, dtype="bfloat16")
    model.module.load_state_dict(model32.module.state_dict())
    cfg = model.config
    n_dec = cfg.transformer_predictor_dec_layers
    assert model.compute_dtype == "bfloat16" and all(p.dtype == torch.float32 for p in model.module.parameters())
    log(f"[slice bf16] {model.name} with dtype=bfloat16 (fp32 parameters), the fp32 phase's weights")

    # the requests: counters start at 0 just before and are read just after
    msda_forward.launches = 0
    msda_forward.paths = {"vector": 0, "general": 0}
    fused_resnet_stem.launches = 0
    single = [model.infer(img, threshold=0.0) for img in images]
    multi = model(batch, threshold=0.0)
    torch.cuda.synchronize()
    launches = {"msda_forward": msda_forward.launches, "fused_resnet_stem": fused_resnet_stem.launches}
    forwards = len(images) + 1
    log(f"[slice bf16] served {len(images)} infer() requests and one batch of {len(batch)}: launches msda_forward"
        f" {launches['msda_forward']} (paths {msda_forward.paths}), fused_resnet_stem {launches['fused_resnet_stem']}")
    assert launches["msda_forward"] == n_dec * forwards, "MSDA kernel did not run once per decoder layer"
    assert msda_forward.paths["vector"] == launches["msda_forward"], "the bf16 path left the MSDA vector path"
    assert launches["fused_resnet_stem"] == forwards, "stem kernel did not run once per forward"
    for r in single:
        check_detections([r], 1, "infer bf16")
    check_detections(multi, len(batch), "batch bf16")
    with torch.inference_mode():
        out = model.forward(batch)
    assert out.boxes.dtype == out.logits.dtype == torch.float32, "bf16 model's outputs are not fp32"
    assert bool(torch.isfinite(out.boxes).all()) and bool(torch.isfinite(out.logits).all()), "non-finite outputs"

    # card bf16 and card fp32 against the CPU's fp32 result, on the CPU's selection
    errs = compare_to_cpu({"fp32": model32.module, "bf16": model.module}, ctx["cpu_ref"], batch[:2])
    log(f"[slice bf16] against the CPU's fp32 result on the CPU's query selection, B=2: card bf16 max_abs_err"
        f" boxes {errs['bf16'][0]:.3e}, scores {errs['bf16'][1]:.3e} (tol {SLICE_BF16_TOL:.0e}); card fp32 boxes"
        f" {errs['fp32'][0]:.3e}, scores {errs['fp32'][1]:.3e}")
    assert max(errs["bf16"]) <= SLICE_BF16_TOL, "card bf16 and CPU fp32 disagree"
    # card bf16 against the CPU's bf16 result (the plain versions in bf16), one image
    t0 = time.perf_counter()
    cpu16 = ModelManager.get("fai-detr-l-coco", device="cpu", dtype="bfloat16")
    cpu16.module.load_state_dict(model32.module.state_dict())
    x_cpu = torch.from_numpy(batch[:1])
    with torch.inference_mode():
        idx, _ = selection(cpu16.module, x_cpu)
        with carried_selection(cpu16.module.predictor, idx):
            out16, _ = cpu16.module(x_cpu)
    e16 = compare_to_cpu({"bf16": model.module}, (out16.boxes.float(), out16.logits.float(), idx), batch[:1])["bf16"]
    log(f"[slice bf16] against the CPU's bf16 result on its selection, B=1 ({time.perf_counter() - t0:.1f}s on the"
        f" CPU): card bf16 max_abs_err boxes {e16[0]:.3e}, scores {e16[1]:.3e} (tol {SLICE_BF16_TOL:.0e})")
    assert max(e16) <= SLICE_BF16_TOL, "card bf16 and CPU bf16 disagree"
    del cpu16

    x1 = torch.from_numpy(batch[:1]).to(dev)
    x16 = torch.from_numpy(batch).to(dev)
    timings = serve_timings(model.module, {"b1": x1, "b16": x16}, {"b1": 30, "b16": 10})
    fp32 = ctx["timings"]
    log(f"[slice bf16] {smi}: b1 forward p50 {timings['b1'] * 1e3:.2f} ms; b16 forward p50 {timings['b16'] * 1e3:.2f} ms"
        f" = {16 / timings['b16']:.1f} images/s | fp32 in this run: b1 {fp32['b1'] * 1e3:.2f} ms, b16"
        f" {16 / fp32['b16']:.1f} images/s")
    # b1 is host-bound and the host's speed drifts: fp32, bf16 and bf16 with every weight cast anew
    # each forward (the cast-weight cache emptied before it), in turns
    rounds = {"fp32": [], "bf16": [], "bf16, no cast cache": []}
    for _ in range(6):
        rounds["fp32"].append(serve_timings(model32.module, {"b1": x1}, {"b1": 8})["b1"])
        rounds["bf16"].append(serve_timings(model.module, {"b1": x1}, {"b1": 8})["b1"])
        rounds["bf16, no cast cache"].append(
            serve_timings(model.module, {"b1": x1}, {"b1": 8}, before=lambda: clear_cast_caches(model.module))["b1"])
    log("[slice bf16] b1 forward in turns, median of 6 rounds of 8 (each round's p50): "
        + ", ".join(f"{k} {np.median(v) * 1e3:.2f} ms (rounds {min(v) * 1e3:.2f}-{max(v) * 1e3:.2f})"
                    for k, v in rounds.items()))
    log(f"[slice bf16] FocoosModel.benchmark(): {model.benchmark(iterations=20)}")

    # both MSDA kernels on the bf16 values the last decoder layer samples in the b16 forward
    v, ss, loc, aw = capture_msda_inputs(model.module, x16, n_dec - 1)
    assert v.dtype == torch.bfloat16 and loc.dtype == aw.dtype == torch.float32
    label = f"captured from decoder layer {n_dec - 1} of the bf16 b16 forward, B=16 Lq=300 Hh=8 D=32"
    check_msda_forward(label, v, ss, loc, aw)
    grad = torch.randn(v.shape[0], loc.shape[1], v.shape[2] * v.shape[3], generator=torch.Generator().manual_seed(9))
    check_msda_backward(label, v, ss, loc, aw, grad.to(dev, torch.bfloat16))
    prof = profile_forwards("slice bf16", "b16 forward bf16", model.module, x16)
    profile_forwards("slice bf16", "b1 forward bf16", model.module, x1, n=4)
    log(f"[slice bf16] cuDNN convolutions {prof['conv']:.1%} of the bf16 b16 forward's device time, fp32"
        f" {ctx['profile']['conv']:.1%} in this run")
    return launches


# ---------------------------------------------------------------------------
@torch.no_grad()
def condition_for_training(module: torch.nn.Module) -> None:
    """Make the random model as well-conditioned as a trained one, so that a
    card-vs-CPU comparison of a training step measures the port and not
    chaos. At random init, train-mode BatchNorm over ~90 layers and box
    refinements of O(1) per decoder layer amplify fp32 rounding: before
    this, the CPU's own fp32 and fp64 runs of one step differ in the
    decoder's last logits by 1.3 (max 8), as much as card and CPU do (an
    H100 and its host's CPU, B=2 640²). Each residual branch's last
    BatchNorm scale (ResNet's and CSPDarknet's) goes to a tenth
    (near-identity blocks, as a zero-γ init), and so does the BatchNorm
    scale of each STDC cat block's convs after its first (the block's
    output near its 1x1 path: STDC has no residual, and ~50 train-mode
    BatchNorms in a row amplify a difference ~10x every few blocks), and
    so does that of bisenetformer's BatchNorms over a 1x1 map (its ARMs'
    attention and the global average's: at B=2 each normalizes the
    difference of two nearly equal image means, which multiplies the
    relative error of its input by the ratio of the means to their
    difference), and each
    decoder box head's last layer (small refinements, as a trained model
    makes)."""
    from focoos_tpu_torch.models.bisenetformer.modelling import AttentionRefinementModule, BiseNet
    from focoos_tpu_torch.nn.backbone.csp_darknet import DarknetBottleneck
    from focoos_tpu_torch.nn.backbone.resnet import BottleNeck
    from focoos_tpu_torch.nn.backbone.stdc import CatBottleneck

    for m in module.modules():
        if isinstance(m, BottleNeck):
            m.branch2c.norm.weight.mul_(0.1)
        elif isinstance(m, DarknetBottleneck) and m.add_identity:  # rtmo's CSPDarknet: residual as ResNet's
            m.conv2.bn.weight.mul_(0.1)
        elif isinstance(m, CatBottleneck):  # STDC: the concat near its 1x1 path, the deeper convs' share x0.1
            for conv in m.conv_list[1:]:
                conv.bn.weight.mul_(0.1)
        elif isinstance(m, AttentionRefinementModule):
            m.bn_atten.weight.mul_(0.1)
        elif isinstance(m, BiseNet):
            m.cp.conv_avg.bn.weight.mul_(0.1)
    for head in getattr(getattr(module, "predictor", None), "dec_bbox_classifier", ()):  # fai_detr's box heads
        head.layers[-1].weight.mul_(0.1)
        head.layers[-1].bias.mul_(0.1)


@contextlib.contextmanager
def cpu_fp64(module: torch.nn.Module):
    """``module`` (on the CPU) computing in fp64 within the block: its
    parameters, statistics and compute dtype (its LayerNorms follow the
    parameters' dtype), and the MSDA plain version (the kernel wrapper takes
    fp32 and bf16 only); outputs and losses stay fp32, as the model casts
    them. Only fp64 inputs take the plain MSDA: a model on the card, run
    inside the block, keeps its MSDA kernels. torch's CPU BatchNorm
    sums its train statistics in fp32, over fai-detr-m's 2x320x320 values a
    channel at the stem's resolution, and STDC's chain of BatchNorms grows
    that drift by the encoder well past the card's (ROADMAP Queue 3). In
    fp64 the CPU's step is the reference the card is held to."""
    import focoos_tpu_torch.models.fai_detr.modelling as modelling
    from focoos_tpu_torch.nn.layers import common
    from focoos_tpu_torch.ops.deformable import ms_deform_attn

    real_msda = modelling.msda_forward
    module.double()
    common.set_compute_dtype(module, torch.float64)
    modelling.msda_forward = lambda v, *a: ms_deform_attn(v, *a) if v.dtype == torch.float64 else real_msda(v, *a)
    try:
        yield module
    finally:
        modelling.msda_forward = real_msda
        module.float()
        common.set_compute_dtype(module, torch.float32)


def train_dataset(n: int, size: int, seed: int) -> list:
    """n seeded size² uint8 images with 1-20 boxes each, 80 classes (in memory)."""
    from focoos_tpu_torch.ports import DatasetEntry
    from focoos_tpu_torch.structures import Boxes, Instances

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 21))
        xy = rng.uniform(0, size * 0.8, (k, 2))
        boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(16, size * 0.4, (k, 2)), size - 1)], 1)
        inst = Instances((size, size), boxes=Boxes(boxes.astype(np.float32)), classes=rng.integers(0, 80, k))
        out.append(DatasetEntry(image=rng.integers(0, 256, (size, size, 3), dtype=np.uint8), height=size,
                                width=size, instances=inst))
    return out


def one_step_on(module, cfg, images: np.ndarray, targets, dev, assign=None) -> tuple:
    """One train-mode forward + criterion + backward of ``module`` on ``dev``,
    the losses taken on ``assign`` when given → (losses, global grad norm,
    the matcher's own assignment [L+1, B, N] and the selected anchors [B, Q],
    both on the CPU)."""
    from focoos_tpu_torch.models.fai_detr.loss import detr_criterion, match

    module.train()
    for p in module.parameters():
        p.grad = None
    t = targets.to(dev)
    feats = []
    hook = module.predictor.register_forward_pre_hook(lambda mod, args: feats.append(args[0]))
    _, aux = module(torch.from_numpy(images).to(dev))
    hook.remove()
    own = match(aux, t, cfg)
    losses = detr_criterion(aux, t, cfg, own if assign is None else assign.to(dev))
    losses["total"].backward()
    norm = float(torch.sqrt(sum(torch.dot(p.grad.flatten(), p.grad.flatten()) for p in module.parameters()
                                if p.grad is not None)))
    with torch.no_grad():  # the query selection again, on the same train-mode features
        anchors = module.predictor.select_queries(*module.predictor.flatten_levels(feats[0]))[0]
    module.eval()
    return {k: float(v.detach()) for k, v in losses.items()}, norm, own.cpu(), anchors.cpu()


def compare_train_step(gpu_model, cpu_model, cfg, ds) -> dict:
    """Card vs CPU on one training step, same weights and batch of two.

    At random init the encoder's selection scores of 8400 anchors lie closer
    than the two devices' fp32 differences (~1e-5 relative), so the top-300
    may come out in another order, or with another anchor at the cut-off;
    and the auction is exact only to eps (1e-2 of each cost range), so a cost
    that differs in the last bits can move a bid. Hence: the CPU step
    matches; its assignment is carried to the card by anchor identity; the
    card takes its losses on that assignment; every loss key and the
    gradient norm are compared. A pair whose selected sets differ is reported
    and the next pair of images is tried. Returns the compared pair's images
    and targets, the CPU's losses, gradient norm, assignment and selection,
    and the card's relative errors."""
    for start in range(0, len(ds) - 1, 2):
        images, targets = cpu_model.processor.train(True).preprocess_entries(ds[start:start + 2], max_instances=100)
        cpu_model.processor.train(False)
        c_losses, c_norm, c_assign, c_anchor = one_step_on(cpu_model.module, cfg, images, targets, torch.device("cpu"))
        g_dev = next(gpu_model.module.parameters()).device
        _, _, g_own, g_anchor = one_step_on(gpu_model.module, cfg, images, targets, g_dev)
        reordered = int((g_anchor != c_anchor).sum())
        only_one = sum(len(set(g_anchor[b].tolist()) ^ set(c_anchor[b].tolist())) for b in range(images.shape[0]))
        valid = targets.valid[None].expand_as(c_assign)
        mapped = torch.zeros_like(c_assign)
        for b in range(images.shape[0]):
            pos = {int(a): q for q, a in enumerate(g_anchor[b])}
            for s_ in range(c_assign.shape[0]):
                for n in range(c_assign.shape[2]):
                    if valid[s_, b, n]:
                        mapped[s_, b, n] = pos.get(int(c_anchor[b, c_assign[s_, b, n]]), 0)
        flips = int(((g_own != mapped) & valid).sum())
        log(f"[train] card vs CPU, images {start}-{start + 1}: {reordered} of {c_anchor.numel()} selected-query"
            f" positions hold another anchor, {only_one} anchors are selected on one device only; the card's own"
            f" matcher differs from the carried assignment on {flips} of {int(valid.sum())}")
        if only_one:  # every query attends to every other: a different set changes every output
            log("[train] a near-tie at the top-300 cut-off: this pair is not compared")
            continue
        g_losses, g_norm, _, _ = one_step_on(gpu_model.module, cfg, images, targets, g_dev, assign=mapped)
        errs = {k: abs(g_losses[k] - c_losses[k]) / max(abs(c_losses[k]), 1e-12) for k in c_losses}
        worst = max(errs, key=errs.get)
        norm_rel = abs(g_norm - c_norm) / c_norm
        log(f"[train] card vs CPU on the CPU's assignment: {len(errs)} loss keys, max rel err {errs[worst]:.3e}"
            f" ({worst}, tol {TRAIN_LOSS_RTOL:.0e}); total card {g_losses['total']:.6f}, CPU {c_losses['total']:.6f};"
            f" grad_norm card {g_norm:.6f}, CPU {c_norm:.6f}, rel err {norm_rel:.3e} (tol {TRAIN_GRAD_NORM_RTOL:.0e})")
        assert errs[worst] <= TRAIN_LOSS_RTOL, f"{worst}: card {g_losses[worst]} vs CPU {c_losses[worst]}"
        assert norm_rel <= TRAIN_GRAD_NORM_RTOL, f"grad_norm: card {g_norm} vs CPU {c_norm}"
        return dict(images=images, targets=targets, losses=c_losses, norm=c_norm, assign=c_assign, anchors=c_anchor,
                    loss_rel=errs[worst], norm_rel=norm_rel)
    raise AssertionError("no pair of images could be compared between card and CPU")


def device_busy(prof) -> tuple:
    """(union of the CUDA kernel intervals in µs, {kernel name: summed µs}).
    Ranges that the code annotates on the card's timeline (the optimizer's
    step) are not kernels and are left out. The union is the port's
    ``utils/profiling.busy_us``, which also reads its Chrome traces."""
    from focoos_tpu_torch.utils.profiling import busy_us

    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kern)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    return busy, by_name


def profiled_trainer(model, args, train_ds, first: int, n: int, val_ds=None):
    """A FocoosTrainer whose loop runs steps ``first`` to ``first + n - 1``
    (each the loader's wait and the step: the profiler is the first hook,
    so the other hooks' after-step work, validation and checkpoints, falls
    outside the window of the last) under the profiler, CPU and CUDA
    activity, the card synchronized at both ends. After ``train()`` its
    ``profile`` holds (the profiler, the window's wall time in µs) and its
    ``loop_s`` the wall time of steps 1 to ``first - 1``, the card
    synchronized at both ends."""
    from focoos_tpu_torch.trainer.hooks import HookBase
    from focoos_tpu_torch.trainer.trainer import FocoosTrainer

    class StepProfiler(HookBase):
        def before_step(self):
            if self.trainer.iter == first:
                torch.cuda.synchronize()
                trainer.loop_s = time.perf_counter() - self.t_first
                self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                               torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()

        def after_step(self):
            if self.trainer.iter == 0:
                torch.cuda.synchronize()
                self.t_first = time.perf_counter()
            if self.trainer.iter == first + n - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - self.t0) * 1e6
                self.prof.__exit__(None, None, None)
                trainer.profile = (self.prof, wall)

    class ProfiledTrainer(FocoosTrainer):
        def _register_hooks(self, loop, checkpointer, schedule) -> None:
            super()._register_hooks(loop, checkpointer, schedule)
            profiler = StepProfiler()
            profiler.trainer = loop
            loop.hooks.insert(0, profiler)

    trainer = ProfiledTrainer(model, args, train_ds, val_ds)
    return trainer


def phase_train(dev, smi: str) -> dict:
    import os
    import shutil
    import tempfile

    from focoos_tpu_torch.ports import TrainerArgs
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.models.fai_detr.loss import compute_cost_matrix
    from focoos_tpu_torch.ops.matching import batched_auction_assign
    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward

    t0 = time.perf_counter()
    model = ModelManager.get("fai-detr-l-coco", device=dev, seed=0)
    perturb(model.module, seed=1)
    condition_for_training(model.module)
    cfg = model.config
    n_dec = cfg.transformer_predictor_dec_layers
    cpu_model = ModelManager.get("fai-detr-l-coco", device="cpu", init_weights=False)
    cpu_model.module.load_state_dict(model.module.state_dict())
    initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}  # for the bf16 run
    ds = train_dataset(4 * TRAIN_BATCH, 640, seed=6)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    log(f"[train] {model.name} at full width and depth (perturbed as for the slice, then conditioned:"
        f" residual branches' last BatchNorm scale and the decoder box heads' last layer x0.1),"
        f" {len(ds)} seeded 640² images with 1-20 boxes,"
        f" B={TRAIN_BATCH}, AdamW + EMA, fp32 with TF32 off ({time.perf_counter() - t0:.1f}s to build)")

    def args(iters: int) -> TrainerArgs:
        return TrainerArgs(run_name="smoke", output_dir=out_dir, batch_size=TRAIN_BATCH, max_iters=iters,
                           ema_enabled=True, checkpointer_period=iters, log_period=iters, seed=0, workers_timeout=300)

    try:
        # card vs CPU on one step at B=2, before any update
        t0 = time.perf_counter()
        pair = compare_train_step(model, cpu_model, cfg, ds[:8])
        log(f"[train] card vs CPU step compared in {time.perf_counter() - t0:.1f}s")
        model.module.zero_grad(set_to_none=True)

        # the main path: FocoosModel.train; counts at 0 just before, read just after
        steps = 3
        msda_forward.launches = 0
        msda_backward.launches = 0
        msda_forward.paths = {"vector": 0, "general": 0}
        msda_backward.paths = {"vector": 0, "general": 0}
        res = model.train(args(steps), ds)
        torch.cuda.synchronize()
        launches = {"msda_forward": msda_forward.launches, "msda_backward": msda_backward.launches}
        log(f"[train] FocoosModel.train ran {res['iterations']} steps: launches msda_forward"
            f" {launches['msda_forward']} (paths {msda_forward.paths}), msda_backward {launches['msda_backward']}"
            f" (paths {msda_backward.paths}) ({n_dec} decoder layers)")
        assert launches["msda_forward"] == n_dec * steps, "the MSDA forward kernel did not run once per decoder layer"
        assert launches["msda_backward"] == n_dec * steps, "the MSDA backward kernel did not run once per decoder layer"
        assert msda_forward.paths["vector"] == n_dec * steps and msda_backward.paths["vector"] == n_dec * steps, \
            "the training step left the MSDA vector paths"
        with open(os.path.join(res["run_dir"], "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        losses = {k: v for k, v in rows[-1].items() if "loss" in k}
        assert len(losses) == 3 * (n_dec + 1) + 1 and all(np.isfinite(v) for v in losses.values()), losses
        assert os.path.isfile(os.path.join(res["run_dir"], "model_final.npz"))
        log(f"[train] losses at step {rows[-1]['iteration']}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())))

        # timing: warm-up steps, then timed steps (host clock per step, IterationTimer),
        # then one more step of the same loop under the profiler
        warm, timed = 2, 10
        torch.cuda.reset_peak_memory_stats()
        trainer = profiled_trainer(model, args(warm + timed + 1), ds, first=warm + timed, n=1)
        trainer.train()
        torch.cuda.synchronize()
        times = [v for v, _ in trainer.loop.storage.history("time").values()][warm:warm + timed]
        step_s = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[train] {smi}, fp32, TF32 off, B={TRAIN_BATCH} 640²: step p50 {step_s * 1e3:.2f} ms"
            f" (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}, {timed} steps)"
            f" = {TRAIN_BATCH / step_s:.1f} images/s; peak memory allocated {peak:.2f} GiB")
        prof, wall = trainer.profile
        busy, by_name = device_busy(prof)
        fwd = sum(v for k, v in by_name.items() if "msda_forward_" in k)
        bwd = sum(v for k, v in by_name.items() if "msda_backward_" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"[train] profiled step: wall {wall / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share"
            f" {1 - busy / wall:.3f}, {sum(1 for _ in by_name)} kernel names; MSDA forward kernel {fwd / 1e3:.3f} ms"
            f" ({fwd / busy:.2%} of busy), MSDA backward kernel {bwd / 1e3:.3f} ms ({bwd / busy:.2%})")
        for k, v in top:
            log(f"[train]   {v / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")

        # the auction alone at the step's shape, on the step's costs
        batch, targets = model.processor.train(True).preprocess_entries(ds[:TRAIN_BATCH], max_instances=100)
        model.processor.train(False)
        t = targets.to(dev)
        model.module.train()
        with torch.no_grad():
            _, aux = model.module(torch.from_numpy(batch).to(dev))
            lg = torch.cat([aux.dec_logits, aux.enc_logits[None]])
            bx = torch.cat([aux.dec_boxes, aux.enc_boxes[None]])
            cost = compute_cost_matrix(lg, bx, t, cfg)
        model.module.eval()
        s_, b_, n_, q_ = cost.shape
        flat_cost, flat_valid = cost.reshape(s_ * b_, n_, q_), t.valid.expand(s_, -1, -1).reshape(s_ * b_, n_)
        auction_ms = time_ms(lambda: batched_auction_assign(flat_cost, flat_valid), calls=2, reps=3)
        log(f"[train] auction: {s_ * b_} problems of {n_}x{q_} ({int(t.valid.sum())} valid targets), "
            f"{batched_auction_assign.rounds} rounds, {auction_ms:.3f} ms alone = {auction_ms / (step_s * 1e3):.2%}"
            f" of the step")
        fp32 = dict(step_s=step_s, peak=peak, conv=kernel_shares(by_name, busy)["conv"])
        log(f"[train] cuDNN convolutions {fp32['conv']:.1%} of the profiled fp32 step's device time")
        del model, cpu_model, trainer
        launches16 = train_bf16(dev, smi, initial, pair, ds, args, fp32)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches, launches16


def train_bf16(dev, smi: str, initial: dict, pair: dict, ds: list, args, fp32: dict) -> dict:
    """fai-detr-l training in bf16 compute from the fp32 phase's initial
    (conditioned) weights: one step against the CPU's fp32 step, the main
    path's launches, timed steps and a profiled step."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward

    model = ModelManager.get("fai-detr-l-coco", device=dev, dtype="bfloat16")
    model.module.load_state_dict(initial)
    cfg = model.config
    n_dec = cfg.transformer_predictor_dec_layers

    # one step on the CPU's selection and assignment, against the CPU's fp32 step
    with carried_selection(model.module.predictor, pair["anchors"]):
        losses, norm, _, _ = one_step_on(model.module, cfg, pair["images"], pair["targets"], dev, assign=pair["assign"])
    model.module.zero_grad(set_to_none=True)
    total = pair["losses"]["total"]
    errs = {k: abs(losses[k] - v) / abs(total) for k, v in pair["losses"].items()}
    rel = {k: abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in pair["losses"].items()}
    worst, worst_rel = max(errs, key=errs.get), max(rel, key=rel.get)
    norm_rel = abs(norm - pair["norm"]) / pair["norm"]
    log(f"[train bf16] card bf16 vs CPU fp32 on the CPU's selection and assignment: {len(errs)} loss keys, largest"
        f" difference {errs[worst]:.3e} of the total ({worst}; tol {TRAIN_BF16_TOL:.0e}), largest relative"
        f" {rel[worst_rel]:.3e} ({worst_rel}); total card {losses['total']:.6f}, CPU {total:.6f}; grad_norm card"
        f" {norm:.6f}, CPU {pair['norm']:.6f}, rel err {norm_rel:.3e} (tol {TRAIN_BF16_GRAD_NORM_RTOL})"
        f" | card fp32 vs CPU: max rel err {pair['loss_rel']:.3e}, grad_norm {pair['norm_rel']:.3e}")
    assert errs[worst] <= TRAIN_BF16_TOL, f"{worst}: card bf16 {losses[worst]} vs CPU fp32 {pair['losses'][worst]}"
    assert norm_rel <= TRAIN_BF16_GRAD_NORM_RTOL, f"grad_norm: card bf16 {norm} vs CPU fp32 {pair['norm']}"

    # the main path: FocoosModel.train in bf16; counts at 0 just before, read just after
    steps = 3
    msda_forward.launches = 0
    msda_backward.launches = 0
    msda_forward.paths = {"vector": 0, "general": 0}
    msda_backward.paths = {"vector": 0, "general": 0}
    res = model.train(args(steps), ds)
    torch.cuda.synchronize()
    launches = {"msda_forward": msda_forward.launches, "msda_backward": msda_backward.launches}
    log(f"[train bf16] FocoosModel.train ran {res['iterations']} steps: launches msda_forward"
        f" {launches['msda_forward']} (paths {msda_forward.paths}), msda_backward {launches['msda_backward']}"
        f" (paths {msda_backward.paths})")
    assert launches["msda_forward"] == n_dec * steps and launches["msda_backward"] == n_dec * steps
    assert msda_backward.paths["vector"] == n_dec * steps, "the bf16 step left the MSDA backward's vector path"
    assert all(p.dtype == torch.float32 for p in model.module.parameters()), "parameters left fp32"

    warm, timed = 2, 10
    torch.cuda.reset_peak_memory_stats()
    trainer = profiled_trainer(model, args(warm + timed + 1), ds, first=warm + timed, n=1)
    trainer.train()
    torch.cuda.synchronize()
    times = [v for v, _ in trainer.loop.storage.history("time").values()][warm:warm + timed]
    step_s = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(v) for v, _ in trainer.loop.storage.history("total_loss").values())
    log(f"[train bf16] {smi}, bf16 compute, B={TRAIN_BATCH} 640²: step p50 {step_s * 1e3:.2f} ms"
        f" (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}, {timed} steps) = {TRAIN_BATCH / step_s:.1f}"
        f" images/s; peak memory allocated {peak:.2f} GiB | fp32 in this run: {fp32['step_s'] * 1e3:.2f} ms ="
        f" {TRAIN_BATCH / fp32['step_s']:.1f} images/s, {fp32['peak']:.2f} GiB")

    prof, wall = trainer.profile
    busy, by_name = device_busy(prof)
    sh = kernel_shares(by_name, busy)
    bwd = sum(v for k, v in by_name.items() if "msda_backward_" in k)
    log(f"[train bf16] profiled step: wall {wall / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share"
        f" {1 - busy / wall:.3f}; cuDNN convolutions {sh['conv']:.1%} of busy (fp32 step {fp32['conv']:.1%}),"
        f" layout transposes {sh['transpose']:.1%}; MSDA backward kernel {bwd / 1e3:.3f} ms ({bwd / busy:.2%})")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[train bf16]   {v / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")
    return launches


# ---------------------------------------------------------------------------
def clustered_boxes(g: torch.Generator, b: int, k: int):
    """[B, K, 4] xyxy boxes around K/8 centres (many overlap) with exact
    duplicates, zero-area boxes, and descending scores with a zero tail."""
    centres = torch.rand(b, k // 8 + 1, 2, generator=g) * 600
    pick = torch.randint(0, centres.shape[1], (b, k), generator=g)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) + torch.randn(b, k, 2, generator=g) * 8
    boxes = torch.cat([xy, xy + torch.rand(b, k, 2, generator=g) * 80 + 20], -1)
    boxes[:, 5:9] = boxes[:, 1:5]
    boxes[:, 10:12, 2:] = boxes[:, 10:12, :2]
    scores = torch.sort(torch.rand(b, k, generator=g) * 0.95 + 0.05, -1, descending=True).values
    scores[:, k - k // 6:] = 0
    return boxes, scores


def phase_nms(dev) -> dict:
    from focoos_tpu_torch.ops.nms import nms_keep, nms_keep_reference

    g = torch.Generator().manual_seed(3)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    log(f"[nms] launch floor: {floor_ms:.4f} ms (time_ms of torch.cuda._sleep(0), the least a queued launch takes)")
    record = {"floor_ms": floor_ms}
    for b, k, thr, label in (
        (16, 300, 0.65, "main path B=16 K=300 thr 0.65"),
        (1, 300, 0.65, "one infer() request B=1 K=300 thr 0.65"),
        (16, 1024, 0.5, "B=16 K=1024 thr 0.5"),
        (2, 37, 0.65, "odd B=2 K=37 thr 0.65"),
        (2, 64, 0.65, "non-finite boxes B=2 K=64 thr 0.65"),
    ):
        boxes, scores = clustered_boxes(g, b, k)
        if label.startswith("non-finite"):  # exp() of a box-size output can overflow
            boxes[:, 2, 0] = float("nan")
            boxes[:, 3, 2:] = float("inf")
            boxes[:, 20:22] = boxes[:, 2:4]
        boxes, scores = boxes.to(dev), scores.to(dev)
        keep = nms_keep(boxes, scores, thr)
        torch.cuda.synchronize()
        ref = nms_keep_reference(boxes, scores, thr)
        differ = int((keep != ref).sum())
        err = float((keep.float() - ref.float()).abs().max())
        kept, valid = int(keep.sum()), int((scores > 0).sum())
        assert differ == 0, f"nms {label}: {differ} keep-mask entries differ from the plain version"
        assert kept < valid, f"nms {label}: nothing suppressed ({kept} kept of {valid} valid)"
        ms = time_ms(lambda: nms_keep(boxes, scores, thr))
        plain_ms = time_ms(lambda: nms_keep_reference(boxes, scores, thr))
        log(f"[nms] {label}: keep masks equal ({kept} kept of {valid} valid)"
            f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if k == 300:
            # boxes and scores read, the keep mask written; ~15 operations an IoU over the K(K-1)/2 pairs
            bd = bound(boxes.numel() * 4 + scores.numel() * 4 + keep.numel(), 15 * b * k * (k - 1) / 2)
            share, above = bd["bound_ms"] / ms, ms - floor_ms
            log(f"[nms] {label}: bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}): kernel at {share:.2%} of it,"
                f" {above:.4f} ms above the launch floor")
            if b == 16:
                record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bd, bound_share=share, above_floor_ms=above)
            else:
                record.update(ms_b1=ms, plain_ms_b1=plain_ms, bound_ms_b1=bd["bound_ms"], bound_share_b1=share,
                              above_floor_ms_b1=above, host_ms=host_ms(lambda: nms_keep(boxes, scores, thr)))
                log(f"[nms] {label}: the wrapper's host time {record['host_ms']:.4f} ms a call (1000 calls, no sync)")
    return record


@torch.no_grad()
def perturb_rtmo(module: torch.nn.Module, seed: int, size: int = 640) -> None:
    """Seeded perturbation of what random init leaves degenerate. rtmo takes
    raw 0-255 pixels, and with identity BatchNorm statistics the random
    CSPDarknet-L's activations reach ~1e3, so exp() of the box-size outputs
    overflows. So: BatchNorm affines are perturbed, then every BatchNorm2d's
    running statistics are set from one train-mode pass over two seeded random
    images (a trained network's BN keeps its activations O(1) the same way);
    the classifier bias is 0 (scores spread over (0, 1), not all at the 0.01
    threshold); the box outputs are scaled by 0.1 around a box-size bias of
    log(6) (boxes about six strides wide, so neighbours overlap and NMS
    suppresses); and DCC's GAU output and bin
    projections are scaled down (at init its bin logits reach ~4e3, a one-hot
    softmax whose keypoints jump a bin on a one-ulp difference)."""
    g = torch.Generator().manual_seed(seed)
    dev = next(module.parameters()).device
    bns = [m for m in module.modules() if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d))]
    for m in bns:
        c = m.num_features
        m.weight.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
        m.bias.copy_(torch.randn(c, generator=g) * 0.05)
        m.running_mean.copy_(torch.randn(c, generator=g) * 0.05)
        m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    convs = [m for m in bns if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in convs]
    for m in convs:
        m.reset_running_stats()
        m.momentum = 1.0  # one pass sets the batch statistics
        m.train()
    module.raw_outputs(torch.randint(0, 256, (2, size, size, 3), generator=g).to(dev))
    for m, momentum in zip(convs, momenta):
        m.momentum = momentum
        m.eval()
    head, dcc = module.head["head_module"], module.head["dcc"]
    for conv in head.out_cls:
        conv.bias.zero_()
    for conv in head.out_bbox:
        conv.weight.mul_(0.1)
        conv.bias.copy_(torch.tensor([0.0, 0.0, math.log(6.0), math.log(6.0)]) + torch.randn(4, generator=g) * 0.05)
    dcc.gau.o.weight.mul_(0.05)
    dcc.x_fc.weight.mul_(0.01)
    dcc.y_fc.weight.mul_(0.01)


def rtmo_selection(module, x: torch.Tensor):
    """(anchor idx [B, D], valid [B, D], candidates' boxes [B, A, 4], scores
    [B, A]) of the batched decode: the NMS launches here are not the main path's."""
    from focoos_tpu_torch.ops.nms import topk_nms

    cfg = module.config
    with torch.inference_mode():
        boxes, scores, _ = module.candidates(module.raw_outputs(x))
        idx, valid, _ = topk_nms(boxes, scores, cfg.nms_pre_topk, cfg.nms_thr, cfg.max_detections, cfg.score_thr)
    return idx.cpu(), valid.cpu(), boxes.float().cpu(), scores.float().cpu()


def explain_flip(cfg, boxes: torch.Tensor, scores: torch.Tensor) -> tuple:
    """What can make two devices select differently for one image: a score
    near-tie at the pre-top-k or max-detections cut, or a candidate pair
    whose IoU sits at the NMS threshold."""
    from focoos_tpu_torch.ops.boxes import box_iou
    from focoos_tpu_torch.ops.nms import nms_keep_reference, pre_topk

    spread = float(scores.max() - scores.min())
    s = torch.sort(scores, descending=True).values
    pre_gap = float(s[cfg.nms_pre_topk - 1] - s[cfg.nms_pre_topk]) / spread if len(s) > cfg.nms_pre_topk else 1.0
    top_boxes, top_scores, _ = pre_topk(boxes[None], scores[None], cfg.nms_pre_topk, cfg.score_thr)
    kept = top_scores[0][nms_keep_reference(top_boxes, top_scores, cfg.nms_thr)[0]]
    kept = torch.sort(kept, descending=True).values
    out_gap = float(kept[cfg.max_detections - 1] - kept[cfg.max_detections]) / spread if len(kept) > cfg.max_detections else 1.0
    iou, _ = box_iou(top_boxes[0], top_boxes[0])
    iou_gap = float((iou - cfg.nms_thr).abs().min())
    return pre_gap, out_gap, iou_gap


def rtmo_run(module, x_uint8: np.ndarray) -> tuple:
    """(outputs {field: [B, D, ...] on the CPU}, rtmo_selection) of one forward."""
    x = torch.from_numpy(x_uint8).to(next(module.parameters()).device)
    with torch.inference_mode():
        out, _ = module(x)
    return ({f: getattr(out, f).float().cpu() for f in ("scores", "boxes", "keypoints", "keypoints_scores")},
            rtmo_selection(module, x))


def compare_rtmo_devices(gpu_model, cpu_model, x_uint8: np.ndarray) -> tuple:
    """Forward the same batch on both modules and match valid detections by
    anchor index (an invalid slot carries the index of a zero score). An
    image whose selected anchors differ is reported; it must show a near-tie
    (score gap at a cut-off, or an IoU at the threshold) and is then left
    out. Returns (the images compared, the CPU's ``rtmo_run``)."""
    runs = [rtmo_run(m, x_uint8) for m in (gpu_model, cpu_model)]
    outs = [r[0] for r in runs]
    (g_idx, g_valid, _, _), (c_idx, c_valid, c_boxes, c_scores) = [r[1] for r in runs]
    compared = 0
    for b in range(x_uint8.shape[0]):
        ga = {int(a): r for r, a in enumerate(g_idx[b]) if g_valid[b, r]}
        ca = {int(a): r for r, a in enumerate(c_idx[b]) if c_valid[b, r]}
        if set(ga) != set(ca):
            pre_gap, out_gap, iou_gap = explain_flip(cpu_model.config, c_boxes[b], c_scores[b])
            log(f"[rtmo] image {b}: selected anchors differ between card and CPU ({len(set(ga) ^ set(ca))} in only"
                f" one set); score gap at the pre-top-k cut {pre_gap:.2e}, at the max-detections cut {out_gap:.2e}"
                f" of the spread, smallest |IoU - thr| {iou_gap:.2e}")
            assert min(pre_gap, out_gap) < NEAR_TIE or iou_gap < 1e-4, f"image {b}: selection differs beyond a near-tie"
            log(f"[rtmo] image {b}: near-tie; values not compared")
            continue
        rows_g = torch.tensor([ga[a] for a in sorted(ga)])
        rows_c = torch.tensor([ca[a] for a in sorted(ca)])
        errs = {}
        for f in outs[0]:
            gv, cv = outs[0][f][b][rows_g], outs[1][f][b][rows_c]
            errs[f] = float((gv - cv).abs().max())
            bound = RTMO_TOL * (float(cv.abs().max()) if f in ("boxes", "keypoints") else 1.0)
            assert errs[f] <= bound, f"image {b}: card and CPU disagree on {f}: {errs[f]} > {bound}"
        log(f"[rtmo] image {b}: {len(ga)} detections, same anchors; card vs CPU max_abs_err "
            + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
            + f" (tol {RTMO_TOL:.0e}, x max|ref| for boxes and keypoints)")
        compared += 1
    return compared, runs[1]


def compare_rtmo_to_cpu(gpu_model, cpu_run: tuple, x_uint8: np.ndarray) -> dict:
    """A card module's detections against a CPU run's (``rtmo_run``) on the anchors
    both keep (bf16 rounding may move a candidate across a cut-off or the NMS
    threshold) → {field: max_abs_err}, and the anchors compared / kept."""
    (g_out, (g_idx, g_valid, _, _)), (c_out, (c_idx, c_valid, _, _)) = rtmo_run(gpu_model, x_uint8), cpu_run
    errs, n_common, n_kept = {f: 0.0 for f in c_out}, 0, 0
    for b in range(x_uint8.shape[0]):
        ga = {int(a): r for r, a in enumerate(g_idx[b]) if g_valid[b, r]}
        ca = {int(a): r for r, a in enumerate(c_idx[b]) if c_valid[b, r]}
        common = sorted(set(ga) & set(ca))
        n_common, n_kept = n_common + len(common), n_kept + len(ca)
        if not common:
            continue
        rows_g, rows_c = torch.tensor([ga[a] for a in common]), torch.tensor([ca[a] for a in common])
        for f in c_out:
            gv, cv = g_out[f][b][rows_g], c_out[f][b][rows_c]
            scale = float(cv.abs().max()) if f in ("boxes", "keypoints") else 1.0
            errs[f] = max(errs[f], float((gv - cv).abs().max()) / scale)
    return {"errs": errs, "common": n_common, "kept": n_kept}


def check_keypoint_detections(results, n_images: int, what: str) -> int:
    assert len(results) == n_images, f"{what}: {len(results)} results for {n_images} images"
    n = 0
    for r in results:
        assert 0 < len(r.detections) <= 100, f"{what}: {len(r.detections)} detections, expected 1..max_detections=100"
        for d in r.detections:
            assert np.isfinite(d.conf) and 0.0 < d.conf <= 1.0 and d.cls_id == 0, f"{what}: bad detection {d}"
            assert len(d.bbox) == 4 and all(isinstance(v, int) for v in d.bbox), f"{what}: bad box {d.bbox}"
            assert len(d.keypoints) == 17, f"{what}: {len(d.keypoints)} keypoints"
            assert all(isinstance(x, int) and isinstance(y, int) and np.isfinite(v) for x, y, v in d.keypoints)
            n += 1
    return n


def phase_rtmo(dev, smi: str) -> dict:
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.nms import nms_keep, pre_topk

    t0 = time.perf_counter()
    model = ModelManager.get("rtmo-l-coco", device=dev, seed=0)
    perturb_rtmo(model.module, seed=4)
    cfg = model.config
    log(f"[rtmo] {model.name}: CSPDarknet-{cfg.backbone_config.size}, {cfg.transformer_encoder_layers} AIFI layer,"
        f" output_dim {cfg.output_dim}, {cfg.num_keypoints} keypoints, nms_pre_topk {cfg.nms_pre_topk},"
        f" max_detections {cfg.max_detections}, {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M params,"
        f" im_size {model.im_size} (built in {time.perf_counter() - t0:.1f}s)")

    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(3)]
    batch = rng.integers(0, 256, (16, 640, 640, 3), dtype=np.uint8)

    # the requests: the counter starts at 0 just before and is read just after
    nms_keep.launches = 0
    single = [model.infer(img) for img in images]
    multi = model(batch)
    torch.cuda.synchronize()
    launches = nms_keep.launches
    forwards = len(images) + 1
    log(f"[rtmo] served {len(images)} infer() requests and one batch of {len(batch)}: {forwards} forwards,"
        f" nms_keep launched {launches} times")
    assert launches == forwards, "the NMS kernel did not run once per forward"
    n = sum(check_keypoint_detections([r], 1, "infer") for r in single) + check_keypoint_detections(multi, 16, "batch")
    lat = single[-1].latency
    log(f"[rtmo] {n} detections well-formed (17 keypoints, int boxes, finite scores); last infer(): preprocess"
        f" {lat.preprocess * 1e3:.2f} ms, inference {lat.inference * 1e3:.2f} ms, postprocess {lat.postprocess * 1e3:.2f} ms")

    # suppression on the main path's inputs (these launches are outside the count)
    with torch.inference_mode():
        boxes, scores, _ = model.module.candidates(model.module.raw_outputs(torch.from_numpy(batch).to(dev)))
        top_boxes, top_scores, _ = pre_topk(boxes, scores, cfg.nms_pre_topk, cfg.score_thr)
        kept = nms_keep(top_boxes, top_scores, cfg.nms_thr).sum(1).tolist()
    valid = (top_scores > 0).sum(1).tolist()
    log(f"[rtmo] NMS on the batch of 16, kept/valid candidates per image: "
        + " ".join(f"{k}/{v}" for k, v in zip(kept, valid)))
    assert any(k < v for k, v in zip(kept, valid)), "NMS suppressed nothing in any image"

    # card vs CPU on the same weights (the CPU runs the plain versions)
    t0 = time.perf_counter()
    cpu_model = ModelManager.get("rtmo-l-coco", device="cpu", init_weights=False)
    cpu_model.module.load_state_dict(model.module.state_dict())
    compared, cpu_run = compare_rtmo_devices(model.module, cpu_model.module, batch[:2])
    assert compared >= 1, "no image could be compared between card and CPU"
    log(f"[rtmo] card vs CPU: {compared}/2 images compared ({time.perf_counter() - t0:.1f}s)")

    # latency and throughput of the forward (host clock around synchronized calls)
    xs = {"b1": torch.from_numpy(batch[:1]).to(dev), "b16": torch.from_numpy(batch).to(dev)}
    timings = serve_timings(model.module, xs, {"b1": 30, "b16": 10})
    e2e = []
    for _ in range(10):
        t = time.perf_counter()
        model.infer(images[0])
        e2e.append(time.perf_counter() - t)
    log(f"[rtmo] {smi}, fp32, TF32 off: b1 forward p50 {timings['b1'] * 1e3:.2f} ms;"
        f" b16 forward p50 {timings['b16'] * 1e3:.2f} ms = {16 / timings['b16']:.1f} images/s;"
        f" infer() 480x640 end to end p50 {np.median(e2e) * 1e3:.2f} ms")
    log(f"[rtmo] FocoosModel.benchmark(): {model.benchmark(iterations=20)}")
    return {"nms_keep": launches}, dict(model=model, cpu_model=cpu_model, cpu_run=cpu_run, batch=batch, images=images,
                                        timings=timings)


def phase_rtmo_bf16(dev, smi: str, ctx: dict) -> dict:
    """rtmo-l serving in bf16 compute on the fp32 phase's weights."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.nms import nms_keep

    batch, images = ctx["batch"], ctx["images"]
    model = ModelManager.get("rtmo-l-coco", device=dev, dtype="bfloat16")
    model.module.load_state_dict(ctx["model"].module.state_dict())
    log(f"[rtmo bf16] {model.name} with dtype=bfloat16 (fp32 parameters), the fp32 phase's weights")
    nms_keep.launches = 0
    single = [model.infer(img) for img in images]
    multi = model(batch)
    torch.cuda.synchronize()
    launches = nms_keep.launches
    log(f"[rtmo bf16] served {len(images)} infer() requests and one batch of {len(batch)}: nms_keep launched"
        f" {launches} times")
    assert launches == len(images) + 1, "the NMS kernel did not run once per forward"
    n = sum(check_keypoint_detections([r], 1, "infer bf16") for r in single)
    n += check_keypoint_detections(multi, 16, "batch bf16")

    res = compare_rtmo_to_cpu(model.module, ctx["cpu_run"], batch[:2])
    log(f"[rtmo bf16] {n} detections well-formed; card bf16 vs CPU fp32 on the {res['common']} of the CPU's"
        f" {res['kept']} kept anchors that both keep: max_abs_err "
        + ", ".join(f"{f} {e:.3e}" for f, e in res["errs"].items()) + " (x max|ref| for boxes and keypoints)")
    assert res["common"] >= res["kept"] // 2, "card bf16 and CPU fp32 keep too few of the same anchors"

    # raw head outputs of one image: card bf16 and CPU bf16, each against the CPU's fp32
    t0 = time.perf_counter()
    cpu16 = ModelManager.get("rtmo-l-coco", device="cpu", dtype="bfloat16")
    cpu16.module.load_state_dict(ctx["model"].module.state_dict())
    x1 = torch.from_numpy(batch[:1])
    fields = ("cls_scores", "bbox_preds", "kpt_offsets", "kpt_vis", "pose_feats")
    with torch.inference_mode():
        raw = {name: m.raw_outputs(x1.to(next(m.parameters()).device))
               for name, m in (("card16", model.module), ("cpu16", cpu16.module), ("cpu32", ctx["cpu_model"].module))}
    for f in fields:
        card, cpu, ref = (getattr(raw[k], f).float().cpu() for k in ("card16", "cpu16", "cpu32"))
        d_card, d_cpu = float((card - ref).abs().max()), float((cpu - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"[rtmo bf16] {f}: from the CPU's fp32, card bf16 {d_card:.3e}, CPU bf16 {d_cpu:.3e} (max|ref| {scale:.3e});"
            f" card bf16 vs CPU bf16 {float((card - cpu).abs().max()):.3e}")
        assert d_card <= 2 * d_cpu + 2.0**-8 * scale, f"{f}: card bf16 moved {d_card} from fp32, CPU bf16 {d_cpu}"
    res = compare_rtmo_to_cpu(model.module, rtmo_run(cpu16.module, batch[:1]), batch[:1])
    log(f"[rtmo bf16] card bf16 vs CPU bf16, B=1 ({time.perf_counter() - t0:.1f}s on the CPU in all), on the"
        f" {res['common']} of the CPU's {res['kept']} kept anchors that both keep: max_abs_err "
        + ", ".join(f"{f} {e:.3e}" for f, e in res["errs"].items()) + " (x max|ref| for boxes and keypoints)")
    assert res["common"] >= res["kept"] // 2, "card bf16 and CPU bf16 keep too few of the same anchors"
    del cpu16

    xs = {"b1": torch.from_numpy(batch[:1]).to(dev), "b16": torch.from_numpy(batch).to(dev)}
    timings = serve_timings(model.module, xs, {"b1": 30, "b16": 10})
    fp32 = ctx["timings"]
    log(f"[rtmo bf16] {smi}: b1 forward p50 {timings['b1'] * 1e3:.2f} ms; b16 forward p50"
        f" {timings['b16'] * 1e3:.2f} ms = {16 / timings['b16']:.1f} images/s | fp32 in this run: b1"
        f" {fp32['b1'] * 1e3:.2f} ms, b16 {16 / fp32['b16']:.1f} images/s")
    profile_forwards("rtmo bf16", "b16 forward bf16", model.module, xs["b16"])
    return {"nms_keep": launches}


# ---------------------------------------------------------------------------
def entries_with_gt(images: list, gts: list) -> list:
    """DatasetEntries of ``images`` holding the ground truth ``gts``: per
    image (boxes, classes) or (boxes, classes, keypoints [G, 17, 3])."""
    from focoos_tpu_torch.ports import DatasetEntry
    from focoos_tpu_torch.structures import Boxes, Instances, Keypoints

    out = []
    for img, gt in zip(images, gts):
        h, w = img.shape[:2]
        fields = dict(boxes=Boxes(gt[0]), classes=np.asarray(gt[1], np.int64))
        if len(gt) == 3:
            fields["keypoints"] = Keypoints(gt[2])
        out.append(DatasetEntry(image=img, height=h, width=w, instances=Instances((h, w), **fields)))
    return out


def pseudo_gt(cpu_model, images: list, keypoints: bool = False) -> list:
    """The model's fp32 CPU detections (its ``eval_postprocess``) as ground
    truth: the top LIFECYCLE_GT x len(images) of all images together (20 an
    image on average), the cut moved down past any score gap under
    GT_SCORE_GAP; keypoints all visible (a person without a visible keypoint
    would count as a miss that no detection can match: ROADMAP Queue 3), and
    people whose box is under 64 px² left out. One
    cut for all images: with each image's own top 20, an image's 21st
    detection can outscore another's 20th and rank as a false positive above
    a true one, so the CPU itself would score under 100."""
    entries = entries_with_gt(images, [(np.zeros((0, 4), np.float32), np.zeros(0))] * len(images))
    with torch.inference_mode():
        out = cpu_model.forward(np.stack(images))
    insts = [r["instances"] for r in cpu_model.processor.eval_postprocess(out, entries)]
    if keypoints:  # OKS scales by the box's area: over a sliver's ~0 area only exactly equal keypoints match
        insts = [i[(i.boxes.tensor[:, 2] - i.boxes.tensor[:, 0]) * (i.boxes.tensor[:, 3] - i.boxes.tensor[:, 1]) >= 64]
                 for i in insts]
    scores = np.concatenate([np.asarray(i.scores) for i in insts])
    image_of = np.concatenate([np.full(len(i), n) for n, i in enumerate(insts)])
    order = np.argsort(-scores, kind="stable")
    cut = LIFECYCLE_GT * len(images)
    while cut < len(order) and scores[order[cut - 1]] - scores[order[cut]] < GT_SCORE_GAP:
        cut += 1
    offsets = np.cumsum([0] + [len(i) for i in insts])
    gts = []
    for n, inst in enumerate(insts):
        sel = np.sort(order[:cut][image_of[order[:cut]] == n]) - offsets[n]
        gt = (inst.boxes.tensor[sel], np.asarray(inst.classes)[sel])
        if keypoints:
            kp = np.asarray(inst.keypoints)[sel].copy()
            kp[..., 2] = 2.0
            gt += (kp,)
        gts.append(gt)
    return gts


def oracle_ap(task, classes: list, entries: list, gts: list) -> dict:
    """The task evaluator on predictions equal to the ground truth."""
    from focoos_tpu_torch.structures import Boxes, Instances
    from focoos_tpu_torch.trainer.evaluation import get_evaluator

    evaluator = get_evaluator(task, len(classes), classes)
    outputs = []
    for e, gt in zip(entries, gts):
        fields = dict(boxes=Boxes(gt[0]), scores=np.linspace(1.0, 0.5, len(gt[0])), classes=np.asarray(gt[1]))
        if len(gt) == 3:
            fields["keypoints"] = gt[2]
        outputs.append({"instances": Instances((e.height, e.width), **fields)})
    evaluator.process(entries, outputs)
    return evaluator.evaluate()


def ap_line(res: dict) -> str:
    return ", ".join(f"{k} {res[k]:.3f}" for k in ("AP", "AP50", "AP75"))


def evaluate_timed(model, dataset: list, batch_size: int) -> tuple:
    """(results, seconds) of ``evaluate_dataset`` on the host clock; it ends synchronized."""
    from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

    t0 = time.perf_counter()
    res = evaluate_dataset(model, dataset, batch_size=batch_size)
    return res, time.perf_counter() - t0


def phase_lifecycle(dev, smi: str, b16_images_per_s: float) -> dict:
    """fai-detr-l's fine-tune-and-evaluate lifecycle at 640²: COCO evaluation
    against pseudo-GT (fp32 and bf16, an oracle), evaluation throughput and
    idle share, rtmo-l keypoint evaluation, then FocoosModel.train with
    in-training validation and periodic checkpoints, a resumed trainer, and
    FocoosModel.eval on the final weights. Each run's kernel counts start at
    0 just before it and are read just after → their sum per kernel."""
    import os
    import shutil
    import tempfile

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward
    from focoos_tpu_torch.ops.nms import nms_keep
    from focoos_tpu_torch.ops.stem import fused_resnet_stem
    from focoos_tpu_torch.ports import Task, TrainerArgs
    from focoos_tpu_torch.trainer.checkpointer import Checkpointer
    from focoos_tpu_torch.trainer.solver import Solver
    from focoos_tpu_torch.trainer.train_step import create_train_state
    from focoos_tpu_torch.trainer.trainer import FocoosTrainer

    kernels = {"msda_forward": msda_forward, "msda_backward": msda_backward, "fused_resnet_stem": fused_resnet_stem,
               "nms_keep": nms_keep}
    total = dict.fromkeys(kernels, 0)

    def counted(fn):
        """fn() with every kernel count at 0 just before and read just after → (result, counts)."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in kernels.items()}
        for name, n in counts.items():
            total[name] += n
        return out, counts

    # fai-detr-l: pseudo-GT from the CPU's fp32 run, then the card in fp32 and bf16
    model = ModelManager.get("fai-detr-l-coco", device=dev, seed=0)
    perturb(model.module, seed=1)
    n_dec = model.config.transformer_predictor_dec_layers
    cpu_model = ModelManager.get("fai-detr-l-coco", device="cpu", init_weights=False)
    cpu_model.module.load_state_dict(model.module.state_dict())
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, (LIFECYCLE_SIZE, LIFECYCLE_SIZE, 3), dtype=np.uint8) for _ in range(4)]
    t0 = time.perf_counter()
    gts = pseudo_gt(cpu_model, images)
    entries = entries_with_gt(images, gts)
    cpu_bbox = evaluate_timed(cpu_model, entries, 2)[0]["bbox"]
    del cpu_model
    oracle = oracle_ap(Task.DETECTION, model.classes, entries, gts)["bbox"]
    log(f"[lifecycle] fai-detr-l (the slice's weights): pseudo-GT = the CPU fp32 run's top"
        f" {sum(len(g[0]) for g in gts)} detections of {len(images)} seeded {LIFECYCLE_SIZE}² images together"
        f" ({time.perf_counter() - t0:.1f}s on the CPU, its own evaluation included); oracle (predictions = GT):"
        f" {ap_line(oracle)}; the CPU's own evaluate_dataset: bbox {ap_line(cpu_bbox)}")
    assert oracle["AP"] == 100.0, "the oracle does not score 100"
    (res, secs), counts = counted(lambda: evaluate_timed(model, entries, 2))
    bbox = res["bbox"]
    log(f"[lifecycle] {smi}: evaluate_dataset fp32 on the card, batch 2: bbox {ap_line(bbox)} ({secs:.2f}s;"
        f" card - CPU {bbox['AP'] - cpu_bbox['AP']:+.3e} AP points); launches msda_forward {counts['msda_forward']},"
        f" fused_resnet_stem {counts['fused_resnet_stem']}")
    assert counts["fused_resnet_stem"] == 2 and counts["msda_forward"] == 2 * n_dec, counts
    assert bbox["AP"] >= 99.0, f"card fp32 bbox/AP {bbox['AP']} against the CPU's own detections"
    model16 = ModelManager.get("fai-detr-l-coco", device=dev, dtype="bfloat16")
    model16.module.load_state_dict(model.module.state_dict())
    (res16, secs16), counts16 = counted(lambda: evaluate_timed(model16, entries, 2))
    log(f"[lifecycle] {smi}: evaluate_dataset bf16 on the card, batch 2: bbox {ap_line(res16['bbox'])}"
        f" ({secs16:.2f}s); launches msda_forward {counts16['msda_forward']},"
        f" fused_resnet_stem {counts16['fused_resnet_stem']}")
    assert counts16["fused_resnet_stem"] == 2 and counts16["msda_forward"] == 2 * n_dec, counts16
    del model16

    # evaluation throughput: 64 seeded images with 1-20 random boxes each, batch 8
    data = train_dataset(EVAL_IMAGES, LIFECYCLE_SIZE, seed=12)
    evaluate_timed(model, data[:EVAL_BATCH], EVAL_BATCH)  # warm-up at this batch
    (_, secs), counts = counted(lambda: evaluate_timed(model, data, EVAL_BATCH))
    batches = EVAL_IMAGES // EVAL_BATCH
    log(f"[lifecycle] {smi}, fp32, TF32 off: evaluate_dataset over {EVAL_IMAGES} images at batch {EVAL_BATCH}:"
        f" {secs:.2f}s = {EVAL_IMAGES / secs:.1f} images/s (b16 forward alone in this run: {b16_images_per_s:.1f}"
        f" images/s); launches msda_forward {counts['msda_forward']}, fused_resnet_stem {counts['fused_resnet_stem']}")
    assert counts["fused_resnet_stem"] == batches and counts["msda_forward"] == batches * n_dec, counts
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall = evaluate_timed(model, data[:2 * EVAL_BATCH], EVAL_BATCH)
    busy, by_name = device_busy(prof)
    idle = 1 - busy / (wall * 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    log(f"[lifecycle] profiled evaluate_dataset over {2 * EVAL_BATCH} images at batch {EVAL_BATCH}: wall"
        f" {wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle share {idle:.3f}; largest kernels "
        + ", ".join(f"{k[:60]} {v / busy:.1%}" for k, v in top))
    del model, data

    # rtmo-l keypoint evaluation (the rtmo phase's weights)
    rmodel = ModelManager.get("rtmo-l-coco", device=dev, seed=0)
    perturb_rtmo(rmodel.module, seed=4)
    rcpu = ModelManager.get("rtmo-l-coco", device="cpu", init_weights=False)
    rcpu.module.load_state_dict(rmodel.module.state_dict())
    rng = np.random.default_rng(13)
    rimages = [rng.integers(0, 256, (LIFECYCLE_SIZE, LIFECYCLE_SIZE, 3), dtype=np.uint8) for _ in range(4)]
    t0 = time.perf_counter()
    rgts = pseudo_gt(rcpu, rimages, keypoints=True)
    rentries = entries_with_gt(rimages, rgts)
    cpu_kp = evaluate_timed(rcpu, rentries, 2)[0]["keypoints"]
    del rcpu
    roracle = oracle_ap(Task.KEYPOINT, rmodel.classes, rentries, rgts)["keypoints"]
    (rres, secs), counts = counted(lambda: evaluate_timed(rmodel, rentries, 2))
    kp = rres["keypoints"]
    log(f"[lifecycle] {smi}: rtmo-l keypoint evaluation fp32 on the card against the CPU's top"
        f" {sum(len(g[0]) for g in rgts)} detections of {len(rimages)} images ({time.perf_counter() - t0:.1f}s with"
        f" the CPU runs), batch 2: keypoints {ap_line(kp)}; the CPU's own: {ap_line(cpu_kp)}; oracle"
        f" {ap_line(roracle)}; nms_keep launches {counts['nms_keep']}")
    assert counts["nms_keep"] == 2, counts
    assert roracle["AP"] == 100.0 and kp["AP"] >= 95.0, f"card keypoints/AP {kp['AP']}"
    del rmodel

    # the lifecycle: fine-tune with validation and checkpoints, resume, evaluate
    model = ModelManager.get("fai-detr-l-coco", device=dev, seed=0)
    perturb(model.module, seed=1)
    condition_for_training(model.module)
    train_ds, val_ds = train_dataset(2 * LIFECYCLE_BATCH, LIFECYCLE_SIZE, seed=14), train_dataset(LIFECYCLE_BATCH, LIFECYCLE_SIZE, seed=15)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    ckpt_dir = os.path.join(out_dir, "ckpt")

    def args(iters: int, **kw) -> TrainerArgs:
        return TrainerArgs(run_name="lifecycle", output_dir=out_dir, batch_size=LIFECYCLE_BATCH, max_iters=iters,
                           eval_period=3, checkpointer_period=3, ckpt_dir=ckpt_dir, ema_enabled=True, log_period=1,
                           seed=0, workers_timeout=300, **kw)

    try:
        res, counts = counted(lambda: model.train(args(6), train_ds, val_ds))
        with open(os.path.join(res["run_dir"], "metrics.json")) as f:
            rows = [json.loads(line) for line in f]
        names = sorted(os.listdir(ckpt_dir))
        log(f"[lifecycle] {smi}: FocoosModel.train, 6 steps at B={LIFECYCLE_BATCH} with an {len(val_ds)}-image"
            f" val_dataset, eval_period 3, checkpointer_period 3: step p50 {rows[-1]['time'] * 1e3:.2f} ms; launches"
            f" msda_backward {counts['msda_backward']}, msda_forward {counts['msda_forward']}, fused_resnet_stem"
            f" {counts['fused_resnet_stem']}; checkpoints {names}; final bbox {ap_line(res['metrics']['bbox'])}")
        assert counts["msda_backward"] == 6 * n_dec, "the MSDA backward kernel did not run once per layer and step"
        assert counts["fused_resnet_stem"] >= 2, "validation did not take the stem kernel"
        assert {"model_0000005", "model_best", "model_final", "last_checkpoint"} <= set(names), names
        assert sum("bbox/AP" in r for r in rows) > 0, "no validation metric was logged"

        # what a resume loads equals what was saved, bit for bit, on the card
        saved = torch.load(os.path.join(ckpt_dir, "model_final", "state.pt"), map_location="cpu", weights_only=True)
        state = create_train_state(model.module, Solver(model.module, args(9)), ema_enabled=True)
        Checkpointer(state, ckpt_dir).load("model_final")
        loaded = state.state_dict()
        same = [torch.equal(loaded["module"][k].cpu(), v) for k, v in saved["module"].items()]
        same += [torch.equal(a.cpu(), b) for a, b in zip(loaded["ema"], saved["ema"], strict=True)]
        for i, s_ in saved["optimizer"]["state"].items():
            same += [torch.equal(torch.as_tensor(loaded["optimizer"]["state"][i][k]).cpu(), torch.as_tensor(v))
                     for k, v in s_.items()]
        assert all(same) and loaded["step"] == saved["step"] == 6, "the loaded state differs from the saved one"
        trainer = FocoosTrainer(model, args(9, resume=True), train_ds, val_ds)
        res2, counts = counted(trainer.train)
        log(f"[lifecycle] resume=True, max_iters 9: started at iteration {trainer.loop.start_iter} from a state equal"
            f" bit for bit to the saved one ({len(same)} tensors), ran to {res2['iterations']}; launches msda_backward"
            f" {counts['msda_backward']}; checkpoints {sorted(os.listdir(ckpt_dir))}")
        assert trainer.loop.start_iter == 6 and res2["iterations"] == 9
        assert counts["msda_backward"] == 3 * n_dec
        final, counts = counted(lambda: model.eval(TrainerArgs(run_name="eval", batch_size=LIFECYCLE_BATCH), val_ds))
        log(f"[lifecycle] FocoosModel.eval on the final weights ({len(val_ds)} images, batch {LIFECYCLE_BATCH}):"
            f" bbox {ap_line(final['bbox'])}; launches msda_forward {counts['msda_forward']}, fused_resnet_stem"
            f" {counts['fused_resnet_stem']}")
        assert counts["fused_resnet_stem"] == 1 and all(np.isfinite(v) for v in final["bbox"].values())
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[lifecycle] launches over the phase's counted runs: {total}")
    return total

def finetune_run(model, args, train_ds, val_ds) -> tuple:
    """FocoosModel.train with both MSDA kernels' counts at 0 just before and
    read just after → (its result, {kernel: launches}, metrics.json's last
    row: ``time`` and ``data_time`` are medians over the run's steps)."""
    import os

    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward

    for k in (msda_forward, msda_backward):
        k.launches = 0
        k.paths = {"vector": 0, "general": 0}
    res = model.train(args, train_ds, val_ds)
    torch.cuda.synchronize()
    counts = {"msda_forward": msda_forward.launches, "msda_backward": msda_backward.launches}
    assert msda_forward.paths["general"] == 0 and msda_backward.paths["general"] == 0, "the MSDA vector paths were left"
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    return res, counts, rows[-1]


def phase_finetune_m(dev, smi: str) -> dict:
    """fai-detr-m fine-tuned from a dataset on disk through the port's data
    pipeline: AutoDataset splits of a seeded Roboflow-COCO set → the loader
    (worker processes bit-equal to in-process on the val split; the train
    loader timed alone) → one step, card fp32 vs CPU fp64 → FocoosModel.train with
    validation, in fp32 and bf16 (step and data_time p50, profiled steps,
    peak memory, bbox/AP) → FocoosModel.eval → b1 and b16 serving. Returns
    each MSDA kernel's launches summed over the counted runs."""
    import copy
    import os
    import shutil
    import tempfile

    import cv2

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import fai_detection_train_augs
    from focoos_tpu_torch.data.loaders import InferenceSampler, build_train_loader
    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward
    from focoos_tpu_torch.ports import TrainerArgs

    total = {"msda_forward": 0, "msda_backward": 0}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            total[k] += v

    # the host: cores for the loader's workers, the image libraries
    cpus = os.cpu_count()
    try:
        import PIL

        pil = PIL.__version__
    except ImportError as e:
        pil = None
        os.environ["FOCOOS_RESIZE_BACKEND"] = "cv2"
        log(f"[finetune_m] PIL does not import ({e}): this phase runs with FOCOOS_RESIZE_BACKEND=cv2, uint8"
            " resizes through cv2's bilinear (not antialiased) in place of PIL's")
    workers = min(8, cpus)
    log(f"[finetune_m] os.cpu_count() {cpus}; cv2 {cv2.__version__}; PIL {pil or 'does not import'};"
        f" loader workers {workers}")

    # a seeded Roboflow-COCO dataset on local disk
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from make_synthetic_dataset import make

    root = tempfile.mkdtemp(prefix="chip_smoke_finetune_m_")
    try:
        t0 = time.perf_counter()
        make(os.path.join(root, "shapes"), n_train=FT_TRAIN, n_val=FT_VAL, size=LIFECYCLE_SIZE, seed=0)
        auto = AutoDataset(os.path.join(root, "shapes"), task="detection")
        train_ds, val_ds = auto.get_split(split="train"), auto.get_split(split="val")
        fai_augs = copy.deepcopy(fai_detection_train_augs)
        fai_train = auto.get_split(fai_augs, split="train")
        classes = train_ds.metadata.classes
        log(f"[finetune_m] wrote {FT_TRAIN} train and {FT_VAL} val {LIFECYCLE_SIZE}² JPEGs, 1-3 boxes of"
            f" {len(classes)} classes each ({time.perf_counter() - t0:.1f}s); AutoDataset splits: the default"
            " detection augmentations (train: color, flip, resize to 320-800 short edge, 640² crop; val: 640²)")

        model = ModelManager.get("fai-detr-m-coco", device=dev, classes=classes, seed=0)
        perturb(model.module, seed=1)
        condition_for_training(model.module)
        cfg = model.config
        n_dec = cfg.transformer_predictor_dec_layers
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        log(f"[finetune_m] {model.name}: STDC (base {cfg.backbone_config.base}, layers"
            f" {cfg.backbone_config.layers}), {cfg.pixel_decoder_num_encoder_layers} AIFI layers, encoder"
            f" {cfg.pixel_decoder_feat_dim} wide, decoder {cfg.transformer_predictor_hidden_dim} wide, {n_dec}"
            f" decoder layers, {cfg.num_queries} queries, {cfg.num_classes} classes,"
            f" {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M params, im_size {model.im_size}")

        # the loader: the val split (its augmentations draw nothing) with 4 workers and in process
        proc = model.processor.train(True)
        val_batches = {}
        for w in (4, 0):
            loader = build_train_loader(val_ds, proc, 4, num_workers=w, sampler=InferenceSampler(len(val_ds)),
                                        timeout=300 if w else 0)
            val_batches[w] = list(loader)
            loader.close()
        same = len(val_batches[4]) == len(val_batches[0]) == FT_VAL // 4 and all(
            torch.equal(a, b) and all(torch.equal(getattr(ta, f), getattr(tb, f)) for f in ("labels", "boxes", "valid"))
            for (a, ta), (b, tb) in zip(val_batches[4], val_batches[0]))
        log(f"[finetune_m] val split through the loader, batch 4: workers=4 and workers=0 give"
            f" {len(val_batches[4])} and {len(val_batches[0])} batches, bit-equal and in order: {same}")
        assert same, "the loader's workers and the in-process loader disagree on the val split"

        # the train loader alone: the fai detection augmentations (zoom-out to 4x side, PIL resizes)
        np.random.seed(0)
        t0 = time.perf_counter()
        mapped = [fai_train[i] for i in range(FT_BATCH)]
        map_ms = (time.perf_counter() - t0) * 1e3 / FT_BATCH
        loader = build_train_loader(fai_train, proc, FT_BATCH, num_workers=workers, seed=0, pin_memory=True,
                                    timeout=300)
        t0 = time.perf_counter()
        next(loader)
        first_s = time.perf_counter() - t0
        n_batches = 8
        t0 = time.perf_counter()
        shapes = [tuple(next(loader)[0].shape[1:3]) for _ in range(n_batches)]
        load_s = time.perf_counter() - t0
        loader.close()
        log(f"[finetune_m] {smi}: train loader alone, fai_detection_train_augs at 640, B={FT_BATCH}, {workers}"
            f" workers: {FT_BATCH * n_batches / load_s:.1f} images/s over {n_batches} batches"
            f" ({load_s * 1e3 / n_batches:.1f} ms a batch; the first, workers starting, {first_s:.2f}s); batch shapes"
            f" {sorted(set(shapes))}; one image mapped in process {map_ms:.1f} ms (mean of {FT_BATCH}, largest"
            f" {max(e.image.shape[:2] for e in mapped)})")
        proc.train(False)
        del mapped

        # one fp32 step on the card against the CPU's step in fp64, on mapped train records (the
        # CPU's assignment carried to the card)
        cpu_model = ModelManager.get("fai-detr-m-coco", device="cpu", classes=classes, init_weights=False)
        cpu_model.module.load_state_dict(model.module.state_dict())
        np.random.seed(3)
        t0 = time.perf_counter()
        msda_forward.launches = msda_backward.launches = 0
        with cpu_fp64(cpu_model.module):
            pair = compare_train_step(model, cpu_model, cfg, [train_ds[i] for i in range(8)])
        torch.cuda.synchronize()
        gate = {"msda_forward": msda_forward.launches, "msda_backward": msda_backward.launches}
        log(f"[finetune_m] card fp32 vs CPU fp64 on one step of fai-detr-m: max loss rel err {pair['loss_rel']:.3e}"
            f" (tol {TRAIN_LOSS_RTOL:.0e}), grad_norm rel err {pair['norm_rel']:.3e} (tol"
            f" {TRAIN_GRAD_NORM_RTOL:.0e}) ({time.perf_counter() - t0:.1f}s); the card's steps launched msda_forward"
            f" {gate['msda_forward']}, msda_backward {gate['msda_backward']} ({n_dec} each a step)")
        # every card step of the gate (its own selection, then the CPU's assignment) ran both kernels per layer
        assert gate["msda_forward"] == gate["msda_backward"] >= 2 * n_dec, gate
        assert gate["msda_forward"] % n_dec == 0, gate
        model.module.zero_grad(set_to_none=True)
        del cpu_model

        out_dir = tempfile.mkdtemp(prefix="ft_", dir=root)

        def args(iters: int, eval_period: int = FT_EVAL_PERIOD) -> TrainerArgs:
            return TrainerArgs(run_name="finetune_m", output_dir=out_dir, batch_size=FT_BATCH, max_iters=iters,
                               workers=workers, eval_period=eval_period, checkpointer_period=iters,
                               log_period=iters, ema_enabled=True, seed=0, workers_timeout=300)

        runs = {}
        for dtype in ("float32", "bfloat16"):
            m = model if dtype == "float32" else ModelManager.get("fai-detr-m-coco", device=dev, classes=classes,
                                                                   dtype=dtype, init_weights=False)
            m.module.load_state_dict(initial)
            torch.cuda.reset_peak_memory_stats()
            res, counts, row = finetune_run(m, args(FT_STEPS), train_ds, val_ds)
            peak = torch.cuda.max_memory_allocated() / 2**30
            add(counts)
            ap = res["metrics"]["bbox"]
            log(f"[finetune_m] {smi}, {dtype}: FocoosModel.train {res['iterations']} steps at B={FT_BATCH} from"
                f" disk, {workers} workers, eval_period {FT_EVAL_PERIOD}: step p50 {row['time'] * 1e3:.2f} ms ="
                f" {FT_BATCH / row['time']:.1f} images/s, data_time p50 {row['data_time'] * 1e3:.2f} ms; peak memory"
                f" allocated {peak:.2f} GiB; val bbox {ap_line(ap)}; launches msda_forward"
                f" {counts['msda_forward']}, msda_backward {counts['msda_backward']} ({n_dec} decoder layers)")
            assert res["iterations"] == FT_STEPS and counts["msda_backward"] == n_dec * FT_STEPS, counts
            # the steps' forwards, then the validations' and the prediction mosaics' (a multiple of n_dec)
            assert counts["msda_forward"] >= n_dec * FT_STEPS and counts["msda_forward"] % n_dec == 0, counts
            assert all(np.isfinite(v) for k, v in row.items() if "loss" in k), row
            assert 0.0 <= ap["AP"] <= 100.0, ap

            # a few more steps with the middle ones under the profiler
            trainer = profiled_trainer(m, args(FT_PROFILED + 2, eval_period=0), train_ds, first=1, n=FT_PROFILED)
            trainer.train()
            prof, wall = trainer.profile
            busy, by_name = device_busy(prof)
            fwd = sum(v for k, v in by_name.items() if "msda_forward_" in k)
            bwd = sum(v for k, v in by_name.items() if "msda_backward_" in k)
            log(f"[finetune_m] {dtype}: {FT_PROFILED} profiled steps: wall {wall / FT_PROFILED / 1e3:.2f} ms a step,"
                f" device busy {busy / FT_PROFILED / 1e3:.2f} ms, idle share {1 - busy / wall:.3f}; cuDNN"
                f" convolutions {kernel_shares(by_name, busy)['conv']:.1%} of busy; MSDA forward kernel"
                f" {fwd / busy:.2%}, backward {bwd / busy:.2%}")
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
                log(f"[finetune_m]   {v / FT_PROFILED / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")
            runs[dtype] = m

        # FocoosModel.eval on the fine-tuned fp32 weights, then serving, fp32 and bf16
        msda_forward.launches = 0
        final = model.eval(TrainerArgs(run_name="eval", batch_size=8), val_ds)
        torch.cuda.synchronize()
        add({"msda_forward": msda_forward.launches})
        log(f"[finetune_m] FocoosModel.eval ({len(val_ds)} val images from disk, batch 8): bbox {ap_line(final['bbox'])};"
            f" launches msda_forward {msda_forward.launches}")
        assert msda_forward.launches == n_dec * FT_VAL // 8 and all(np.isfinite(v) for v in final["bbox"].values())
        batch = np.random.default_rng(5).integers(0, 256, (16, LIFECYCLE_SIZE, LIFECYCLE_SIZE, 3), dtype=np.uint8)
        x1, x16 = torch.from_numpy(batch[:1]).to(dev), torch.from_numpy(batch).to(dev)
        # both MSDA kernels on what the fine-tuned model's last decoder layer samples in a b16 forward
        v, ss, loc, aw = capture_msda_inputs(model.module, x16, n_dec - 1)
        label = f"fai-detr-m captured from decoder layer {n_dec - 1} of the b16 forward, B=16 Lq=300 Hh=8 D=32"
        check_msda_forward(label, v, ss, loc, aw)
        grad = torch.randn(v.shape[0], loc.shape[1], v.shape[2] * v.shape[3], generator=torch.Generator().manual_seed(9))
        check_msda_backward(label, v, ss, loc, aw, grad.to(dev))
        for dtype, m in runs.items():
            msda_forward.launches = 0
            dets = m(batch, threshold=0.0)
            torch.cuda.synchronize()
            add({"msda_forward": msda_forward.launches})
            top_k = min(cfg.top_k, cfg.num_queries * cfg.num_classes)
            assert msda_forward.launches == n_dec and len(dets) == 16 and all(len(d) == top_k for d in dets)
            t = serve_timings(m.module, {"b1": x1, "b16": x16}, {"b1": 30, "b16": 10})
            log(f"[finetune_m] {smi}, {dtype}: serving fai-detr-m, b1 forward p50 {t['b1'] * 1e3:.2f} ms; b16"
                f" forward p50 {t['b16'] * 1e3:.2f} ms = {16 / t['b16']:.1f} images/s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[finetune_m] launches over the phase's counted runs: {total}")
    return total


# ---------------------------------------------------------------------------
# fai_mf: instance segmentation at 1024² and semantic segmentation at 640²
MF_TOL = {"float32": 1e-3, "bfloat16": 5e-2}  # abs, class and mask probabilities, card against the CPU's fp32
MF_CARDS = {  # card → (its size, the card-vs-CPU batch)
    "fai-mf-l-coco-ins": (1024, 1),
    "fai-mf-l-ade": (640, 2),
}
MF_MASK_STD = 0.5  # the conditioned mask logits' std (the bf16 mask errors grow in proportion to it)
# for the evaluations: sharper masks, so that fewer pixels sit at the mask threshold
MF_EVAL_MASK_STD = 4.0
MF_GT_IMAGES, MF_GT = 4, 20  # pseudo-GT: the CPU's top 20 x images instances over all images together
MF_EVAL_IMAGES, MF_EVAL_BATCH = 32, 8
MF_REQUEST = (768, 1024)  # one infer() request's image


@torch.no_grad()
def condition_mf(model, dev, std: float) -> float:
    """Random init gives masks that cover the whole image or nothing (the mask
    features' channel means dominate each query's mask) at a scale no trained
    model has: centre the mask features' channels (fai_mf: their conv's bias;
    bisenetformer's come out of a ReLU and stay as they are) and scale the
    mask head's last layer so that the last decoder layer's mask logits have
    ``std``, both on a seeded 256² eval batch → the scale."""
    x = torch.from_numpy(np.random.default_rng(30).integers(0, 256, (1, 256, 256, 3), dtype=np.uint8)).to(dev)
    model.module.eval()
    feat = getattr(model.module.pixel_decoder, "mask_features", None)
    if feat is not None:
        seen = []
        hook = feat.register_forward_hook(lambda m, a, o: seen.append(o.float().mean((0, 2, 3))))
        try:
            model.module(x)
        finally:
            hook.remove()
        feat.bias.sub_(seen[0])
    _, aux = model.module(x)
    heads = model.module.predictor.forward_prediction_heads
    scale = std / float(aux.masks[-1].float().std())
    heads.mask_classifier.layers[-1].weight.mul_(scale)
    heads.mask_classifier.layers[-1].bias.mul_(scale)
    return scale


def mf_run(module, x_uint8: np.ndarray, allowed=None):
    """(class probabilities, mask probabilities, the attention masks used) of
    one eval forward, on the host as fp32 (masks as stored: bf16 in bf16)."""
    dev = next(module.parameters()).device
    with torch.inference_mode():
        out, aux = module(torch.from_numpy(x_uint8).to(dev),
                          allowed=None if allowed is None else [a.to(dev) for a in allowed])
    return out.logits.float().cpu(), out.masks.cpu(), [a.cpu() for a in aux.allowed]


def compare_mf(tag: str, cpu_run: tuple, runs: dict) -> dict:
    """Each run (class probabilities, masks) against the CPU's fp32 run → {name: (cls err, mask err)}."""
    errs = {}
    for name, (logits, masks, _) in runs.items():
        errs[name] = (float((logits - cpu_run[0]).abs().max()), float((masks.float() - cpu_run[1]).abs().max()))
        log(f"[{tag}] {name} against the CPU's fp32 on its attention masks: max_abs_err class probabilities"
            f" {errs[name][0]:.3e}, mask probabilities {errs[name][1]:.3e}")
    return errs


def flip_share(a: list, b: list) -> float:
    """Share of the attention masks' bits that differ between two runs."""
    return sum(int((x != y).sum()) for x, y in zip(a, b)) / sum(x.numel() for x in a)


def mf_entries(cpu_model, images: list, semantic: bool) -> tuple:
    """DatasetEntries whose ground truth is the CPU's fp32 predictions (its
    ``eval_postprocess``): the label maps for semantic; else the top
    MF_GT x images instances of all images together (the cut moved past score
    gaps under GT_SCORE_GAP, and up above the first empty mask), masks
    unpacked from the decode → (entries, the CPU's own results scored by the
    evaluator)."""
    from focoos_tpu_torch.ports import DatasetEntry
    from focoos_tpu_torch.structures import BitMasks, Instances
    from focoos_tpu_torch.trainer.evaluation import get_evaluator

    h, w = images[0].shape[:2]
    blank = [DatasetEntry(image=img, height=h, width=w) for img in images]
    preds = []
    for i in range(0, len(images), 2):
        with torch.inference_mode():
            out = cpu_model.forward(np.stack(images[i:i + 2]))
        preds += cpu_model.processor.eval_postprocess(out, blank[i:i + 2])
    if semantic:
        entries = [DatasetEntry(image=img, height=h, width=w, sem_seg=p["sem_seg"].astype(np.uint8))
                   for img, p in zip(images, preds)]
    else:
        insts = [p["instances"] for p in preds]
        scores = np.concatenate([np.asarray(i.scores) for i in insts])
        image_of = np.concatenate([np.full(len(i), n) for n, i in enumerate(insts)])
        order = np.argsort(-scores, kind="stable")
        cut = MF_GT * len(images)
        while cut < len(order) and scores[order[cut - 1]] - scores[order[cut]] < GT_SCORE_GAP:
            cut += 1
        # an empty mask has IoU 0 even with itself: the cut stops above the first empty prediction
        empty = np.concatenate([(i.boxes.tensor[:, 2] <= i.boxes.tensor[:, 0]) for i in insts])[order]
        if empty[:cut].any():
            cut = int(np.argmax(empty))
        assert cut >= 2 * len(images), f"pseudo-GT of {cut} instances: an empty mask ranks too high"
        offsets = np.cumsum([0] + [len(i) for i in insts])
        entries = []
        for n, (img, inst) in enumerate(zip(images, insts)):
            sel = np.sort(order[:cut][image_of[order[:cut]] == n]) - offsets[n]
            packed = inst.masks_packed.cpu().numpy()[sel]
            masks = np.unpackbits(packed, axis=-1, count=h * w).reshape(len(sel), h, w).astype(bool)
            gt = Instances((h, w), boxes=BitMasks(masks).get_bounding_boxes(),
                           classes=np.asarray(inst.classes)[sel], masks=BitMasks(masks))
            entries.append(DatasetEntry(image=img, height=h, width=w, instances=gt))
    ev = get_evaluator(cpu_model.task, len(cpu_model.classes), cpu_model.classes)
    ev.process(entries, preds)
    return entries, ev.evaluate()


def mf_metric(res: dict, semantic: bool) -> tuple:
    return ("sem_seg/mIoU", res["sem_seg"]["mIoU"]) if semantic else ("segm/AP", res["segm"]["AP"])


PAN_PQ_GATE = 99.0  # fp32 PQ of the card's panoptic map scored against the CPU's own map
PAN_MIN_SEGMENTS = 5
PAN_MIN_AREA = 1e-3  # the smallest segment the threshold search accepts, as a share of the image
PAN_SEED = 31  # the panoptic check's image
PAN_DROP_OVERLAP = 0.5  # a fixed overlap threshold the card's map is also compared at: the overlap rule drops queries


def check_panoptic(tag: str, model, model16, cpu, size: int, dev) -> None:
    """``panoptic_inference`` on the outputs (class and mask probabilities)
    of one seeded ``size``² image (``PAN_SEED``), the CPU's on the CPU and
    the card's on the card, half the
    classes things and half stuff; the CPU's map is the ground truth that
    ``PanopticEvaluator`` scores the card's fp32 map (gated) and bf16 map
    (reported) against. Random weights give every query nearly the same
    mask (their masks correlate 0.95 at full width, MF_MASK_STD) and similar
    scores, so the best-scored query takes most pixels: the forwards run on
    weights whose mask logits have ``MF_EVAL_MASK_STD`` (``condition_mf``:
    sharper masks), and the weights are put back after. On the phase's own
    B=1 image no thresholds leave enough segments that large (at most 10
    with std 4, some of a few pixels, on an H100); on this one they do.
    The thresholds are searched on the card's own outputs: the highest
    overlap threshold, then the fewest kept queries, that leave
    ``PAN_MIN_SEGMENTS`` segments, none smaller than
    ``PAN_MIN_AREA`` of the image (a segment of a few pixels may come and go
    with an fp32 rounding); the object threshold lies in the middle of a gap
    of the scores wider than twice the fp32 gate, so both devices keep the
    same queries. The searched overlap threshold is low (0.01 on an H100),
    so the card's fp32 map is compared again, under the same gate, at
    ``PAN_DROP_OVERLAP``, where the overlap rule drops queries."""
    from focoos_tpu_torch.trainer.evaluation import PanopticEvaluator

    initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    batch = np.random.default_rng(PAN_SEED).integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    choice = None
    t0 = time.perf_counter()
    try:
        condition_mf(model, dev, MF_EVAL_MASK_STD)
        own = mf_run(model.module, batch)
        probs, masks = own[0][0].to(dev), own[1][0].to(dev).float()
        n_cls = probs.shape[-1]
        things = set(range(n_cls // 2))
        scores = probs.amax(-1).sort(descending=True).values.tolist()
        for overlap in (0.8, 0.5, 0.3, 0.1, 0.05, 0.02, 0.01, 0.0):
            for n in range(PAN_MIN_SEGMENTS, len(scores) - 1):
                if scores[n - 1] - scores[n] <= 2 * MF_TOL["float32"]:
                    continue
                thr = (scores[n - 1] + scores[n]) / 2
                _, segs = model.processor.panoptic_inference(probs, masks, things, thr, overlap)
                if len(segs) >= PAN_MIN_SEGMENTS and min(sg["area"] for sg in segs) >= PAN_MIN_AREA * masks[0].numel():
                    choice = (thr, overlap, n)
                    break
            if choice:
                break
        search_s = time.perf_counter() - t0
        assert choice, "no thresholds leave enough panoptic segments"
        for m in (cpu, model16):
            m.module.load_state_dict(model.module.state_dict())
        cpu_run = mf_run(cpu.module, batch)
        card_run, bf16_run = (mf_run(m.module, batch, cpu_run[2]) for m in (model, model16))
    finally:
        for m in (model, model16, cpu):
            m.module.load_state_dict(initial)
    thr, overlap, n = choice
    t0 = time.perf_counter()
    ref, ref_segs = model.processor.panoptic_inference(cpu_run[0][0], cpu_run[1][0].float(), things, thr, overlap)
    cpu_s = time.perf_counter() - t0
    out = {}
    for name, run in (("fp32", card_run), ("bf16", bf16_run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pan, segs = model.processor.panoptic_inference(run[0][0].to(dev), run[1][0].to(dev).float(), things, thr,
                                                       overlap)
        secs = time.perf_counter() - t0
        ev = PanopticEvaluator(n_cls, thing_ids=sorted(things))
        ev.process([{"pan_seg": ref}], [{"panoptic_seg": (pan, segs)}])
        out[name] = (ev.evaluate()["panoptic_seg"], int((pan != ref).sum()), len(segs), secs)
    # the overlap rule's drop branch: both maps again at a fixed, higher overlap threshold
    drop_ref, drop_ref_segs = model.processor.panoptic_inference(cpu_run[0][0], cpu_run[1][0].float(), things, thr,
                                                                 PAN_DROP_OVERLAP)
    drop_pan, drop_segs = model.processor.panoptic_inference(card_run[0][0].to(dev), card_run[1][0].to(dev).float(),
                                                             things, thr, PAN_DROP_OVERLAP)
    ev = PanopticEvaluator(n_cls, thing_ids=sorted(things))
    ev.process([{"pan_seg": drop_ref}], [{"panoptic_seg": (drop_pan, drop_segs)}])
    drop_pq = ev.evaluate()["panoptic_seg"]
    n_th = sum(sg["isthing"] for sg in ref_segs)
    kept = cpu_run[0][0].argmax(-1)[cpu_run[0][0].amax(-1) > thr].tolist()
    stuff = [c for c in kept if c not in things]
    repeats = sum(1 for c in set(stuff) if stuff.count(c) > 1)
    log(f"[{tag}] panoptic_inference on a seeded {size}² image's outputs (mask logits std {MF_EVAL_MASK_STD}), classes"
        f" 0-{n_cls // 2 - 1} things and the rest stuff: object_threshold {thr:.6f} (the top {n} queries kept),"
        f" overlap_threshold {overlap}"
        f" (searched on the card's outputs, {search_s:.2f}s with the forwards); the CPU's map {len(ref_segs)} segments"
        f" ({n_th} things, {len(ref_segs) - n_th} stuff, areas {sorted(sg['area'] for sg in ref_segs)}; of the"
        f" kept queries {len(stuff)} of stuff classes, {repeats} stuff classes held by more than one (merged where"
        f" they win); {cpu_s:.2f}s); against it "
        + "; ".join(f"the card's {k} map PQ {r['PQ']:.3f} (SQ {r['SQ']:.3f}, RQ {r['RQ']:.3f}), {d} of {ref.size}"
                    f" pixels differ, {m} segments ({s_ * 1e3:.1f} ms)" for k, (r, d, m, s_) in out.items())
        + f"; fp32 gate PQ ≥ {PAN_PQ_GATE}")
    log(f"[{tag}] panoptic_inference at overlap_threshold {PAN_DROP_OVERLAP} (the same object threshold): the CPU's"
        f" map {len(drop_ref_segs)} segments (areas {sorted(sg['area'] for sg in drop_ref_segs)}), void pixels"
        f" {int((drop_ref == 0).sum())} against {int((ref == 0).sum())} at {overlap} (the queries the overlap rule"
        f" dropped); the card's fp32 map PQ {drop_pq['PQ']:.3f} (SQ {drop_pq['SQ']:.3f}, RQ {drop_pq['RQ']:.3f}),"
        f" {int((drop_pan != drop_ref).sum())} pixels differ, {len(drop_segs)} segments; gate PQ ≥ {PAN_PQ_GATE}")
    assert len(ref_segs) >= PAN_MIN_SEGMENTS and out["fp32"][0]["PQ"] >= PAN_PQ_GATE, out["fp32"]
    assert drop_ref_segs and drop_pq["PQ"] >= PAN_PQ_GATE, drop_pq


def phase_mf(dev, smi: str) -> dict:
    """fai-mf-l-coco-ins (ResNet-101-D, 6 pre-norm res5 layers, 9 masked
    decoder layers) at 1024² and fai-mf-l-ade (ResNet-101-D, 6 masked layers,
    150 classes) at 640², each at full width with seeded weights, the
    BatchNorms perturbed and the mask head conditioned (``condition_mf``:
    MF_MASK_STD, then MF_EVAL_MASK_STD for the evaluations), in fp32 then bf16: the requests (infer() on a 768x1024 image and a batch
    through FocoosModel.__call__) with the stem kernel's launches counted
    from 0; card against CPU on the CPU's attention masks; evaluate_dataset
    against the CPU's own predictions taken as ground truth; evaluation
    throughput at batch 8, the bytes copied to the host per batch and the
    idle share; the device mask IoU against the host library; forward
    times, infer() broken out, peak memory and a profiled forward. Returns
    the stem's launches summed over the counted runs."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.mask_iou import device_mask_iou_packed_batch
    from focoos_tpu_torch.ops.stem import fused_resnet_stem
    from focoos_tpu_torch.trainer import evaluation
    from focoos_tpu_torch.utils import native

    total = {"fused_resnet_stem": 0}

    def counted(fn):
        fused_resnet_stem.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = fused_resnet_stem.launches
        total["fused_resnet_stem"] += n
        return out, n

    t0 = time.perf_counter()
    assert native.available(), "the host library (csrc/focoos_native.cpp) did not build"
    log(f"[fai_mf] host library built and loaded ({time.perf_counter() - t0:.2f}s): {native._build().name}")
    for card, (size, b_cmp) in MF_CARDS.items():
        tag = f"fai_mf {card}"
        semantic = card.endswith("-ade")
        t0 = time.perf_counter()
        model = ModelManager.get(card, device=dev, seed=0)
        perturb(model.module, seed=21)
        scale = condition_mf(model, dev, MF_MASK_STD)
        cfg = model.config
        cpu = ModelManager.get(card, device="cpu", init_weights=False)
        cpu.module.load_state_dict(model.module.state_dict())
        log(f"[{tag}] ResNet-{cfg.backbone_config.depth}{cfg.backbone_config.variant}, pixel decoder"
            f" {cfg.pixel_decoder_feat_dim} wide with {cfg.pixel_decoder_transformer_layers} res5 layers,"
            f" {cfg.transformer_predictor_dec_layers} masked decoder layers, {cfg.num_queries} queries,"
            f" {cfg.num_classes} classes, {cfg.postprocessing_type}; {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M"
            f" params; mask head scaled x{scale:.3g} (built in {time.perf_counter() - t0:.1f}s)")
        rng = np.random.default_rng(31)
        request = rng.integers(0, 256, (*MF_REQUEST, 3), dtype=np.uint8)
        batch = rng.integers(0, 256, (b_cmp, size, size, 3), dtype=np.uint8)

        # card against the CPU on the CPU's attention masks
        t0 = time.perf_counter()
        cpu_run = mf_run(cpu.module, batch)
        cpu_secs = time.perf_counter() - t0
        runs16 = {}
        model16 = ModelManager.get(card, device=dev, dtype="bfloat16", init_weights=False)
        model16.module.load_state_dict(model.module.state_dict())
        card_run = mf_run(model.module, batch, cpu_run[2])
        own = mf_run(model.module, batch)
        errs = compare_mf(tag, cpu_run, {"card fp32": card_run})
        assert max(errs["card fp32"]) <= MF_TOL["float32"], f"{card}: card fp32 and CPU disagree"
        runs16["card bf16"] = mf_run(model16.module, batch, cpu_run[2])
        t0 = time.perf_counter()
        cpu16 = ModelManager.get(card, device="cpu", dtype="bfloat16", init_weights=False)
        cpu16.module.load_state_dict(model.module.state_dict())
        runs16["CPU bf16"] = mf_run(cpu16.module, batch, cpu_run[2])
        cpu16_secs = time.perf_counter() - t0
        del cpu16
        errs16 = compare_mf(tag, cpu_run, runs16)
        assert max(errs16["card bf16"]) <= MF_TOL["bfloat16"], f"{card}: card bf16 and the CPU's fp32 disagree"
        log(f"[{tag}] card bf16 / CPU bf16 distance to the CPU's fp32: class probabilities"
            f" {errs16['card bf16'][0] / errs16['CPU bf16'][0]:.2f}, masks {errs16['card bf16'][1] / errs16['CPU bf16'][1]:.2f}")
        log(f"[{tag}] card vs CPU at {size}² B={b_cmp} (CPU fp32 forward {cpu_secs:.1f}s, CPU bf16 {cpu16_secs:.1f}s):"
            f" fp32 within {MF_TOL['float32']:.0e}, bf16 within {MF_TOL['bfloat16']:.0e}; attention-mask bits that"
            f" flip without carrying: {flip_share(own[2], cpu_run[2]):.3e} of"
            f" {sum(a.numel() for a in own[2])}; card bf16's own masks {flip_share(mf_run(model16.module, batch)[2], cpu_run[2]):.3e}")
        if not semantic:
            check_panoptic(tag, model, model16, cpu, size, dev)
        del own, card_run, runs16

        for dtype, m in (("float32", model), ("bfloat16", model16)):
            # the requests: the stem's count from 0 just before, read just after
            def serve():
                one = m.infer(request, threshold=0.0)
                many = m(batch, threshold=0.0)
                return one, many

            (one, many), n = counted(serve)
            log(f"[{tag}] {dtype}: served one infer() at {MF_REQUEST[0]}x{MF_REQUEST[1]} and a batch of {b_cmp} at {size}²: stem launches {n};"
                f" {len(one.detections)} + {[len(r.detections) for r in many]} detections")
            assert n == 2, f"{card} {dtype}: the stem kernel did not run once per forward"
            for r, (hh, ww) in [(one, MF_REQUEST)] + [(r, (size, size)) for r in many]:
                assert len(r.detections) > 0
                for d in r.detections:
                    x0, y0, x1, y1 = d.bbox
                    assert 0 <= x0 <= x1 < ww and 0 <= y0 <= y1 < hh and 0.0 <= d.conf <= 1.0 and d.mask
                    assert 0 <= d.cls_id < cfg.num_classes

        # evaluation against the CPU's own predictions, on sharper masks
        scale = condition_mf(model, dev, MF_EVAL_MASK_STD)
        for m in (cpu, model16):
            m.module.load_state_dict(model.module.state_dict())
        rng = np.random.default_rng(32)
        images = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(MF_GT_IMAGES)]
        t0 = time.perf_counter()
        entries, cpu_res = mf_entries(cpu, images, semantic)
        key, cpu_metric = mf_metric(cpu_res, semantic)
        if semantic:
            maps = np.stack([e.sem_seg for e in entries])
            shares = [float(np.bincount(m.ravel()).max()) / m.size for m in maps]
            # random weights: one class's summed probability over the 100 queries wins nearly
            # everywhere, so the mIoU gate checks little; the card tests' random probabilities do
            what = (f" ({len(np.unique(maps))} classes in the label maps, the largest covering"
                    f" {', '.join(f'{v:.4f}' for v in shares)} of each)")
        else:
            what = f" (top {sum(len(e.instances) for e in entries)} instances together)"
        log(f"[{tag}] mask head rescaled to logits of std {MF_EVAL_MASK_STD} (x{scale:.3g}); pseudo-GT: the CPU fp32"
            f" predictions of {len(images)} seeded {size}² images{what}, {time.perf_counter() - t0:.1f}s; the CPU's"
            f" own predictions score {key} {cpu_metric:.3f}")
        assert cpu_metric == 100.0, "the CPU's predictions do not score 100 against themselves"
        for dtype, m in (("float32", model), ("bfloat16", model16)):
            (res, secs), n = counted(lambda: evaluate_timed(m, entries, 2))
            metric = mf_metric(res, semantic)[1]
            extra = "" if semantic else f", bbox/AP {res['bbox']['AP']:.3f}"
            log(f"[{tag}] {smi}: evaluate_dataset {dtype} on the card, batch 2: {key} {metric:.3f}{extra}"
                f" ({secs:.2f}s); stem launches {n}; {evaluation.stats['host_bytes'] / evaluation.stats['batches']:.0f}"
                " bytes to the host a batch")
            assert n == len(images) // 2
            if dtype == "float32":
                assert metric >= 99.0, f"{card}: card fp32 {key} {metric} against the CPU's own predictions"

        # the device mask IoU against the host library, on a decode of this model's predictions
        if not semantic:
            dec = model.processor.eval_decode(model.forward(np.stack(images[:2])), entries[:2])
            gts = [list(e.instances.masks.tensor) for e in entries[:2]]
            got = device_mask_iou_packed_batch(list(dec.packed_on_device), dec.hw, gts)
            packed = dec.packed_on_device.cpu().numpy()
            for i, g in enumerate(gts):
                dense = np.unpackbits(packed[i], axis=-1, count=size * size).reshape(-1, size, size)
                ref = native.mask_iou(list(dense), g)
                assert got[i].shape == ref.shape and np.array_equal(got[i], ref), "device mask IoU != host library"
            t0 = time.perf_counter()
            for _ in range(3):
                device_mask_iou_packed_batch(list(dec.packed_on_device), dec.hw, gts)
            t = (time.perf_counter() - t0) / 3 * 1e3
            log(f"[{tag}] device mask IoU equals native.mask_iou bit for bit: [{packed.shape[1]}, G] x 2 images at"
                f" {size}² ({[len(g) for g in gts]} ground truths); {t:.2f} ms a call on the host clock (the"
                " ground truth packed and copied up, the matrices copied back)")

        # evaluation throughput, the bytes to the host and the idle share
        data = [entries[i % len(entries)] for i in range(MF_EVAL_IMAGES)]
        evaluate_timed(model, data[:MF_EVAL_BATCH], MF_EVAL_BATCH)
        (_, secs), n = counted(lambda: evaluate_timed(model, data, MF_EVAL_BATCH))
        per_batch = evaluation.stats["host_bytes"] / evaluation.stats["batches"]
        assert n == MF_EVAL_IMAGES // MF_EVAL_BATCH
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, wall = evaluate_timed(model, data[:2 * MF_EVAL_BATCH], MF_EVAL_BATCH)
        busy, by_name = device_busy(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        log(f"[{tag}] {smi}, fp32: evaluate_dataset over {MF_EVAL_IMAGES} images at batch {MF_EVAL_BATCH}:"
            f" {secs:.2f}s = {MF_EVAL_IMAGES / secs:.2f} images/s; {per_batch:.0f} bytes to the host a batch (the"
            f" output stack would be {MF_EVAL_BATCH * cfg.num_queries * size * size * 4} bytes); profiled"
            f" {2 * MF_EVAL_BATCH} images: idle share {1 - busy / (wall * 1e6):.3f}; largest kernels "
            + ", ".join(f"{k[:50]} {v / busy:.1%}" for k, v in top))

        # times: host clock around synchronized forwards
        shapes = {"b1": 1, "b8": 8} if size == 1024 else {}
        shapes.update({"b1@640": 1, "b16@640": 16})
        g = np.random.default_rng(33)
        for dtype, m in (("float32", model), ("bfloat16", model16)):
            xs = {k: torch.from_numpy(g.integers(0, 256, (b, 640 if "640" in k else size, 640 if "640" in k else size, 3),
                                                 dtype=np.uint8)).to(dev) for k, b in shapes.items()}
            torch.cuda.reset_peak_memory_stats()
            t = serve_timings(m.module, xs, {k: (10 if b == 1 else 4) for k, b in shapes.items()})
            peak = torch.cuda.max_memory_allocated() / 2**30
            lat = []
            for _ in range(5):
                r = m.infer(request, threshold=0.5)
                lat.append((r.latency.preprocess, r.latency.inference, r.latency.postprocess))
            p50 = np.median(np.array(lat), 0) * 1e3
            log(f"[{tag}] {smi}, {dtype}: " + "; ".join(
                f"{k} forward p50 {v * 1e3:.2f} ms = {shapes[k] / v:.2f} images/s" for k, v in t.items())
                + f"; peak memory {peak:.2f} GiB; infer() {MF_REQUEST[0]}x{MF_REQUEST[1]} p50: preprocess"
                f" {p50[0]:.2f} ms, forward {p50[1]:.2f} ms, postprocess {p50[2]:.2f} ms (the [1, {cfg.num_queries},"
                f" {MF_REQUEST[0]}, {MF_REQUEST[1]}] mask stack to the host and the host decode)")
            big = "b8" if size == 1024 else "b16@640"
            profile_forwards(tag, f"{big} forward {dtype}", m.module, xs[big], n=2)
        del model, model16, cpu
        torch.cuda.empty_cache()
    log(f"[fai_mf] stem launches over the phase's counted runs: {total['fused_resnet_stem']}")
    return total


# ---------------------------------------------------------------------------
# segm_train: mask-classification training (fai_mf, bisenetformer)
SEG_STEP_CARD = "fai-mf-l-ade"  # the card-vs-CPU step: 640², B=2 mapped semantic records
SEG_FT_CARD, SEG_FT_SIZE = "fai-mf-l-coco-ins", 1024  # the fine-tune from disk, the card's own resolution
SEG_FT_HW = (480, 640)  # the instance set's originals (height, width): COCO's most common size
SEG_FT_TRAIN, SEG_FT_VAL = 32, 8
SEG_FT_BATCH, SEG_FT_STEPS, SEG_FT_EVAL_PERIOD = 8, 6, 3  # cut from 10 and 5: the script's time limit
# the sustained run: steps 1 .. SEG_FT_SUSTAINED - SEG_FT_PROFILED - 1 timed as one loop, past the
# 8 workers x 2 batches the DataLoader prefetches; then SEG_FT_PROFILED steps under the profiler
SEG_FT_SUSTAINED, SEG_FT_PROFILED = 24, 3
BISENET_CARD, BISENET_SIZE, BISENET_BATCH = "bisenetformer-l-ade", 640, 16
SEG_WORKERS = 8


SHAPE_CLASSES = ["circle", "square", "triangle"]


def draw_shapes(rng: np.random.Generator, height: int, width: int) -> tuple:
    """A seeded height x width RGB image of 1-5 filled shapes of 3 classes
    (between 1/12 and 1/3 of the short edge wide) on a noise background,
    with per-pixel texture over all of it, as photographs have: on flat
    fills a pre-activation within fp32 rounding of 0 switches a whole region
    at once, and an fp32 training step then strays from the fp64 one far
    past the step gates → (image, [(class, polygon [K, 2] px)]).
    ``tools/make_synthetic_dataset.py`` writes the same layouts, but square
    images with flat fills and shapes 30-90 px wide at any size."""
    import cv2

    img = rng.integers(0, 80, (height, width, 3), np.uint8)
    shapes = []
    short = min(height, width)
    for _ in range(int(rng.integers(1, 6))):
        cls = int(rng.integers(0, 3))
        s = int(rng.integers(short // 12, short // 3))
        x, y = int(rng.integers(0, width - s)), int(rng.integers(0, height - s))
        if cls == 0:
            t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
            poly = np.stack([x + s / 2 + s / 2 * np.cos(t), y + s / 2 + s / 2 * np.sin(t)], 1)
        elif cls == 1:
            poly = np.array([[x, y], [x + s, y], [x + s, y + s], [x, y + s]], float)
        else:
            poly = np.array([[x + s / 2, y], [x, y + s], [x + s, y + s]], float)
        cv2.fillPoly(img, [poly.round().astype(np.int32)], tuple(int(c) for c in rng.integers(120, 255, 3)))
        shapes.append((cls, poly))
    img = np.clip(img.astype(np.int16) + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)
    return img, shapes


def write_instance_set(root: str, n_train: int, n_val: int, hw: tuple, seed: int) -> str:
    """A seeded Roboflow-COCO instance-segmentation set on local disk:
    ``draw_shapes`` JPEGs of ``hw`` = (height, width), each shape with its
    polygon."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("valid", n_val)):
        sdir = os.path.join(root, split)
        os.makedirs(sdir, exist_ok=True)
        images, annotations = [], []
        for i in range(n):
            img, shapes = draw_shapes(rng, *hw)
            for cls, poly in shapes:
                x0, y0 = poly.min(0)
                w, h = poly.max(0) - poly.min(0)
                annotations.append(dict(id=len(annotations) + 1, image_id=i, category_id=cls + 1,
                                        bbox=[float(x0), float(y0), float(w), float(h)], area=float(w * h), iscrowd=0,
                                        segmentation=[poly.flatten().tolist()]))
            fn = f"img_{i:04d}.jpg"
            cv2.imwrite(os.path.join(sdir, fn), img[:, :, ::-1])
            images.append(dict(id=i, file_name=fn, height=hw[0], width=hw[1]))
        cats = [dict(id=0, name="shapes", supercategory="none")] + [
            dict(id=c + 1, name=name, supercategory="shapes") for c, name in enumerate(SHAPE_CLASSES)]
        with open(os.path.join(sdir, "_annotations.coco.json"), "w") as f:
            json.dump(dict(images=images, annotations=annotations, categories=cats), f)
    return root


def write_semantic_set(root: str, n_train: int, n_val: int, size: int, seed: int) -> str:
    """A seeded Roboflow semantic-segmentation set on local disk
    (``from_roboflow_seg``'s layout: JPEG, ``*_mask.png`` of class indices,
    ``_classes.csv`` with background at 0) of ``draw_shapes`` images."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("valid", n_val)):
        sdir = os.path.join(root, split)
        os.makedirs(sdir, exist_ok=True)
        with open(os.path.join(sdir, "_classes.csv"), "w") as f:
            f.write("Pixel Value, Class\n0, background\n" + "".join(f"{c + 1}, {name}\n" for c, name in enumerate(SHAPE_CLASSES)))
        for i in range(n):
            img, shapes = draw_shapes(rng, size, size)
            mask = np.zeros((size, size), np.uint8)
            for cls, poly in shapes:
                cv2.fillPoly(mask, [poly.round().astype(np.int32)], cls + 1)
            cv2.imwrite(os.path.join(sdir, f"img_{i:04d}.jpg"), img[:, :, ::-1])
            cv2.imwrite(os.path.join(sdir, f"img_{i:04d}_mask.png"), mask)
    return root


def mf_step_on(module, cfg, images: np.ndarray, targets, dev, carried=None, allowed=None) -> dict:
    """One train-mode forward + criterion + backward of a mask-classification
    ``module`` on ``dev``, on ``carried`` draws and ``allowed`` attention
    masks where given (else its own: draws from a generator seeded 0 on
    ``dev``) → losses, global grad norm, the draws and assignment used and
    the attention masks, both on the CPU."""
    from focoos_tpu_torch.models.fai_mf.loss import maskformer_criterion

    module.train()
    for p in module.parameters():
        p.grad = None
    _, aux = module(torch.from_numpy(images).to(dev), allowed=None if allowed is None else [a.to(dev) for a in allowed])
    losses, used = maskformer_criterion(aux, targets.to(dev), cfg, torch.Generator(device=dev).manual_seed(0),
                                        carried=None if carried is None else carried.to(dev))
    losses["total"].backward()
    norm = float(torch.sqrt(sum(torch.dot(p.grad.flatten().double(), p.grad.flatten().double())
                                for p in module.parameters() if p.grad is not None)))
    module.eval()
    return dict(losses={k: float(v.detach()) for k, v in losses.items()}, norm=norm, used=used.to("cpu"),
                allowed=[a.cpu() for a in aux.allowed])


def compare_mf_train_step(tag: str, model, model16, cpu_model, images: np.ndarray, targets) -> dict:
    """One training step, card against the CPU on the same weights and batch.
    The CPU runs in fp64 (``cpu_fp64``: the reference the card is held to;
    train-mode BatchNorm chains make the CPU's own fp32 step drift, as
    fai-detr-m's does). Its attention masks, matcher and loss points and
    assignment are carried to the card. First the card's own step on the
    CPU's points alone (attention masks and assignment its own) is reported;
    then the card fp32 (each loss 1e-4 rel, grad_norm 1e-3 rel) and bf16
    (each loss within 1e-2 of the total, grad_norm 0.25 rel) steps on
    everything carried."""
    from focoos_tpu_torch.models.fai_mf.loss import CriterionDraws

    cfg, dev = model.config, model.device
    t0 = time.perf_counter()
    with cpu_fp64(cpu_model.module):
        ref = mf_step_on(cpu_model.module, cfg, images, targets, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    points = CriterionDraws(match_coords=ref["used"].match_coords, loss_coords=ref["used"].loss_coords)
    own = mf_step_on(model.module, cfg, images, targets, dev, carried=points)
    valid = targets.valid[None].expand_as(ref["used"].assign)
    pairs = int((own["used"].assign != ref["used"].assign)[valid].sum())
    log(f"[{tag}] one step at B={images.shape[0]} {images.shape[1]}x{images.shape[2]}: the CPU's fp64 step took"
        f" {cpu_s:.1f}s; with only the CPU's points carried, the card's attention masks differ in"
        f" {sum(int((a != b).sum()) for a, b in zip(own['allowed'], ref['allowed']))} of"
        f" {sum(a.numel() for a in ref['allowed'])} bits and its assignment in {pairs} of {int(valid.sum())} pairs")
    out = {}
    for name, m, gate in (("fp32", model, TRAIN_LOSS_RTOL), ("bf16", model16, TRAIN_BF16_TOL)):
        got = mf_step_on(m.module, cfg, images, targets, dev, carried=ref["used"], allowed=ref["allowed"])
        if name == "fp32":
            errs = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-12) for k, v in ref["losses"].items()}
        else:  # bf16: each loss within TRAIN_BF16_TOL of the total
            errs = {k: abs(got["losses"][k] - v) / abs(ref["losses"]["total"]) for k, v in ref["losses"].items()}
        worst = max(errs, key=errs.get)
        norm_rel = abs(got["norm"] - ref["norm"]) / ref["norm"]
        norm_gate = TRAIN_GRAD_NORM_RTOL if name == "fp32" else TRAIN_BF16_GRAD_NORM_RTOL
        log(f"[{tag}] card {name} vs CPU fp64, everything carried: {len(errs)} loss keys, max"
            f" {'rel err' if name == 'fp32' else 'err / total'} {errs[worst]:.3e} ({worst}, tol {gate:.0e}); total"
            f" card {got['losses']['total']:.6f}, CPU {ref['losses']['total']:.6f}; grad_norm card {got['norm']:.6f},"
            f" CPU {ref['norm']:.6f}, rel err {norm_rel:.3e} (tol {norm_gate:.0e})")
        assert errs[worst] <= gate, f"{tag} {name} {worst}: card {got['losses'][worst]} vs CPU {ref['losses'][worst]}"
        assert norm_rel <= norm_gate, f"{tag} {name} grad_norm: card {got['norm']} vs CPU {ref['norm']}"
        out[name] = (errs[worst], norm_rel)
    for m in (model, model16):
        m.module.zero_grad(set_to_none=True)
    return out


def segm_finetune_run(model, args, train_ds, val_ds) -> tuple:
    """FocoosModel.train with the stem's count at 0 just before and read just
    after → (its result, the stem's launches, metrics.json's last row: ``time``
    and ``data_time`` are medians over the run's steps)."""
    import os

    from focoos_tpu_torch.ops.stem import fused_resnet_stem

    fused_resnet_stem.launches = 0
    res = model.train(args, train_ds, val_ds)
    torch.cuda.synchronize()
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    return res, fused_resnet_stem.launches, rows[-1]


def criterion_alone_ms(model, images: np.ndarray, targets) -> tuple:
    """The criterion and its backward alone on the card at a step's shapes:
    a train-mode forward's outputs taken as leaves → (ms a call on the host
    clock around synchronized calls, the auction's rounds, one profiled
    call's device busy ms and its largest kernels)."""
    from focoos_tpu_torch.models.fai_mf.loss import maskformer_criterion
    from focoos_tpu_torch.ops.matching import batched_auction_assign
    from focoos_tpu_torch.models.fai_mf.ports import MaskFormerAuxOutputs

    dev = model.device
    model.module.train()
    with torch.no_grad():
        _, aux = model.module(torch.from_numpy(images).to(dev))
    model.module.eval()
    logits, masks = aux.logits.detach().requires_grad_(), aux.masks.detach().requires_grad_()
    t = targets.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call():
        losses, _ = maskformer_criterion(MaskFormerAuxOutputs(logits, masks), t, model.config, gen)
        losses["total"].backward()

    call()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return float(np.median(ts)) * 1e3, batched_auction_assign.rounds, busy / 1e3, top


def phase_segm_train(dev, smi: str) -> dict:
    """Mask-classification training at full width: one fai-mf-l-ade step on
    the card against the CPU (fp32 and bf16); fai-mf-l-coco-ins fine-tuned
    at 1024² from a seeded instance set of 640x480 JPEGs on disk (the train
    loader alone, the preset's validation raising, FocoosModel.train with
    validation at 480 in fp32 and bf16, a sustained loop and profiled steps,
    the criterion alone, FocoosModel.eval); bisenetformer-l-ade served,
    compared, evaluated and trained from a seeded semantic set on disk.
    Returns the stem's launches summed over the counted runs (the ResNet-D
    card's validations and evaluation: train-mode forwards take the plain
    stem convs, STDC has no ResNet-D stem)."""
    import copy
    import os
    import shutil
    import tempfile

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import fai_instance_train_augs, get_default_by_task
    from focoos_tpu_torch.data.loaders import build_train_loader
    from focoos_tpu_torch.ops.stem import fused_resnet_stem
    from focoos_tpu_torch.ports import DatasetLayout, Task, TrainerArgs
    from focoos_tpu_torch.trainer import evaluation

    phase_t0 = time.perf_counter()
    total = {"fused_resnet_stem": 0}
    workers = min(SEG_WORKERS, os.cpu_count())
    root = tempfile.mkdtemp(prefix="chip_smoke_segm_train_")
    try:
        # 1. fai-mf-l-ade at 640²: one step on the card against the CPU on mapped semantic records
        t0 = time.perf_counter()
        sem_root = write_semantic_set(os.path.join(root, "sem"), 2 * BISENET_BATCH, 8, BISENET_SIZE, seed=1)
        sem = AutoDataset(sem_root, task="semseg", layout=DatasetLayout.ROBOFLOW_SEG)
        sem_train, sem_val = sem.get_split(split="train"), sem.get_split(split="val")
        sem_classes = sem_train.metadata.classes
        np.random.seed(4)
        pair = [sem_train[i] for i in range(2)]
        log(f"[segm_train] wrote {2 * BISENET_BATCH} train and 8 val {BISENET_SIZE}² Roboflow semantic records, 1-5"
            f" textured shapes each ({len(sem_classes)} classes with background; {time.perf_counter() - t0:.1f}s)")
        tag = f"segm_train {SEG_STEP_CARD}"
        model = ModelManager.get(SEG_STEP_CARD, device=dev, seed=0)
        perturb(model.module, seed=21)
        condition_for_training(model.module)
        scale = condition_mf(model, dev, MF_MASK_STD)
        model16 = ModelManager.get(SEG_STEP_CARD, device=dev, dtype="bfloat16", init_weights=False)
        cpu = ModelManager.get(SEG_STEP_CARD, device="cpu", init_weights=False)
        for m in (model16, cpu):
            m.module.load_state_dict(model.module.state_dict())
        cfg = model.config
        images, targets = model.processor.train(True).preprocess_entries(pair)
        model.processor.train(False)
        log(f"[{tag}] ResNet-{cfg.backbone_config.depth}{cfg.backbone_config.variant},"
            f" {cfg.transformer_predictor_dec_layers} decoder layers, {cfg.num_classes} classes, weights perturbed and"
            f" conditioned (residual branches' last BatchNorm x0.1, mask head x{scale:.3g}); B=2 mapped records,"
            f" {int(targets.valid.sum())} valid targets, masks {tuple(targets.masks.shape[-2:])},"
            f" {cfg.criterion_num_points} points")
        fused_resnet_stem.launches = 0
        compare_mf_train_step(tag, model, model16, cpu, images, targets)
        assert fused_resnet_stem.launches == 0, "a train-mode forward launched the stem kernel"
        del model, model16, cpu
        torch.cuda.empty_cache()

        # 2. fai-mf-l-coco-ins fine-tuned at 1024² from a set on disk of COCO-sized originals. Validation at
        # the preset's 1024 resizes every record, which meets ROADMAP Queue 3's fault: the evaluator pairs
        # predictions at the original size with ground truth at the mapped one and raises. Validation at the
        # originals' short edge keeps every record exact.
        t0 = time.perf_counter()
        ins_root = write_instance_set(os.path.join(root, "ins"), SEG_FT_TRAIN, SEG_FT_VAL, SEG_FT_HW, seed=2)
        auto = AutoDataset(ins_root, task="instseg")
        augs = copy.deepcopy(fai_instance_train_augs)
        augs.resolution = SEG_FT_SIZE
        ft_train = auto.get_split(augs, split="train")
        preset_val = auto.get_split(get_default_by_task(Task.INSTANCE_SEGMENTATION, SEG_FT_SIZE)[1], split="val")
        ft_val = auto.get_split(get_default_by_task(Task.INSTANCE_SEGMENTATION, min(SEG_FT_HW))[1], split="val")
        classes = ft_train.metadata.classes
        p0, v0 = preset_val[0], ft_val[0]
        assert p0.image.shape[:2] != (p0.height, p0.width) and v0.image.shape[:2] == (v0.height, v0.width) == SEG_FT_HW
        log(f"[segm_train] wrote {SEG_FT_TRAIN} train and {SEG_FT_VAL} val {SEG_FT_HW[1]}x{SEG_FT_HW[0]} JPEGs with"
            f" 1-5 textured polygons of 3 classes ({time.perf_counter() - t0:.1f}s); train: fai_instance_train_augs"
            f" ({SEG_FT_SIZE}, crop); segmentation_val_augs at {SEG_FT_SIZE} map a val record to"
            f" {p0.image.shape[:2]} (the resized path), at {min(SEG_FT_HW)} to {v0.image.shape[:2]} (the exact path)")
        tag = f"segm_train {SEG_FT_CARD}"
        model = ModelManager.get(SEG_FT_CARD, device=dev, classes=classes, seed=0)
        perturb(model.module, seed=22)
        condition_for_training(model.module)
        condition_mf(model, dev, MF_MASK_STD)
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        cfg = model.config

        proc = model.processor.train(True)
        np.random.seed(0)
        t0 = time.perf_counter()
        mapped = [ft_train[i] for i in range(SEG_FT_BATCH)]
        map_ms = (time.perf_counter() - t0) * 1e3 / SEG_FT_BATCH
        t0 = time.perf_counter()
        _, tgt = proc.preprocess_entries(mapped)
        collate_ms = (time.perf_counter() - t0) * 1e3
        loader = build_train_loader(ft_train, proc, SEG_FT_BATCH, num_workers=workers, seed=0, pin_memory=True,
                                    timeout=300)
        t0 = time.perf_counter()
        next(loader)
        first_s = time.perf_counter() - t0
        n_batches = 6
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(loader)
        load_s = time.perf_counter() - t0
        loader.close()
        proc.train(False)
        target_bytes = sum(t.numel() * t.element_size() for t in (tgt.labels, tgt.masks, tgt.valid))
        log(f"[{tag}] {smi}: train loader alone, B={SEG_FT_BATCH}, {workers} workers:"
            f" {SEG_FT_BATCH * n_batches / load_s:.1f} images/s over {n_batches} batches ({load_s * 1e3 / n_batches:.1f}"
            f" ms a batch; the first, workers starting, {first_s:.2f}s); in process: a record mapped in {map_ms:.1f} ms,"
            f" the collate of {SEG_FT_BATCH} ({int(tgt.valid.sum())} instances resized with cv2) {collate_ms:.1f} ms;"
            f" targets copied to the card a step: {target_bytes} bytes (masks {tuple(tgt.masks.shape)} fp32)")
        del mapped

        out_dir = tempfile.mkdtemp(prefix="ft_", dir=root)

        def args(iters: int, eval_period: int = SEG_FT_EVAL_PERIOD) -> TrainerArgs:
            return TrainerArgs(run_name="segm_train", output_dir=out_dir, batch_size=SEG_FT_BATCH, max_iters=iters,
                               workers=workers, eval_period=eval_period, checkpointer_period=iters, log_period=iters,
                               ema_enabled=True, seed=0, workers_timeout=300, samples=0)

        # the preset's validation: the first one raises the pinned ValueError, and nothing else may
        t0 = time.perf_counter()
        try:
            model.train(args(SEG_FT_EVAL_PERIOD), ft_train, preset_val)
        except ValueError as e:
            fault = str(e)
        else:
            raise AssertionError("validation of resized instance records ran: ROADMAP Queue 3's fault is gone,"
                                 " so this phase should validate at the preset's resolution")
        assert fault.startswith("mask_iou: masks of sizes"), fault
        log(f"[{tag}] FocoosModel.train validating at the preset's {SEG_FT_SIZE}: {SEG_FT_EVAL_PERIOD} steps, then the"
            f" first validation raised ValueError({fault!r}) ({time.perf_counter() - t0:.1f}s; ROADMAP Queue 3)."
            f" The runs below validate at {min(SEG_FT_HW)}")
        model.module.load_state_dict(initial)

        for dtype in ("float32", "bfloat16"):
            m = model if dtype == "float32" else ModelManager.get(SEG_FT_CARD, device=dev, classes=classes,
                                                                   dtype=dtype, init_weights=False)
            m.module.load_state_dict(initial)
            torch.cuda.reset_peak_memory_stats()
            res, n, row = segm_finetune_run(m, args(SEG_FT_STEPS), ft_train, ft_val)
            peak = torch.cuda.max_memory_allocated() / 2**30
            total["fused_resnet_stem"] += n
            ap = res["metrics"]["segm"]
            log(f"[{tag}] {smi}, {dtype}: FocoosModel.train {res['iterations']} steps at B={SEG_FT_BATCH}"
                f" {SEG_FT_SIZE}² from disk, {workers} workers, validation at {min(SEG_FT_HW)} every"
                f" {SEG_FT_EVAL_PERIOD}: step p50"
                f" {row['time'] * 1e3:.2f} ms = {SEG_FT_BATCH / row['time']:.2f} images/s, data_time p50"
                f" {row['data_time'] * 1e3:.2f} ms; peak memory allocated {peak:.2f} GiB; final val segm {ap_line(ap)};"
                f" stem launches {n} (the validations' and final evaluation's forwards)")
            assert res["iterations"] == SEG_FT_STEPS and n > 0, (res["iterations"], n)
            assert all(np.isfinite(v) for k, v in row.items() if "loss" in k), row
            assert 0.0 <= ap["AP"] <= 100.0, ap

            m.module.load_state_dict(initial)
            first = SEG_FT_SUSTAINED - SEG_FT_PROFILED
            trainer = profiled_trainer(m, args(SEG_FT_SUSTAINED, eval_period=0), ft_train, first=first,
                                       n=SEG_FT_PROFILED)
            trainer.train()
            waits = [v for v, it in trainer.loop.storage.history("data_time").values() if 1 <= it < first]
            steps = [v for v, it in trainer.loop.storage.history("time").values() if 1 <= it < first]
            log(f"[{tag}] {smi}, {dtype}: sustained, no validation: steps 1-{first - 1} as one loop"
                f" {trainer.loop_s:.2f}s = {(first - 1) * SEG_FT_BATCH / trainer.loop_s:.2f} images/s (step p50"
                f" {np.median(steps) * 1e3:.2f} ms = {SEG_FT_BATCH / np.median(steps):.2f} images/s); the loader's"
                f" wait {sum(waits):.2f}s = {sum(waits) / trainer.loop_s:.1%} of the loop, {np.median(waits[-20:]) * 1e3:.2f}"
                f" ms p50 over its last 20 steps (the prefetch holds {workers} workers x 2 batches)")
            assert len(waits) == len(steps) == first - 1, (len(waits), len(steps))
            prof, wall = trainer.profile
            busy, by_name = device_busy(prof)
            sh = kernel_shares(by_name, busy)
            log(f"[{tag}] {dtype}: {SEG_FT_PROFILED} profiled steps (steps {first}-{first + SEG_FT_PROFILED - 1}): wall {wall / SEG_FT_PROFILED / 1e3:.2f} ms a step,"
                f" device busy {busy / SEG_FT_PROFILED / 1e3:.2f} ms, idle share {1 - busy / wall:.3f}; cuDNN"
                f" convolutions {sh['conv']:.1%} of busy, layout transposes {sh['transpose']:.1%}")
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                log(f"[{tag}]   {v / SEG_FT_PROFILED / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")
            batch, tg = m.processor.train(True).preprocess_entries([ft_train[i] for i in range(SEG_FT_BATCH)])
            m.processor.train(False)
            crit_ms, rounds, crit_busy, top = criterion_alone_ms(m, batch, tg)
            log(f"[{tag}] {dtype}: the criterion and its backward alone at B={SEG_FT_BATCH}"
                f" ({cfg.transformer_predictor_dec_layers + 1} layers x {SEG_FT_BATCH} images in one auction,"
                f" {rounds} rounds, {int(tg.valid.sum())} valid targets): {crit_ms:.2f} ms on the host clock ="
                f" {crit_ms / (row['time'] * 1e3):.1%} of the step p50; a profiled call keeps the card busy"
                f" {crit_busy:.2f} ms, largest kernels " + ", ".join(f"{k[:60]} {v / 1e3:.2f} ms" for k, v in top))
            if dtype == "bfloat16":
                del m
        fused_resnet_stem.launches = 0
        final = model.eval(TrainerArgs(run_name="eval", batch_size=4), ft_val)
        torch.cuda.synchronize()
        n = fused_resnet_stem.launches
        total["fused_resnet_stem"] += n
        log(f"[{tag}] FocoosModel.eval ({SEG_FT_VAL} val images from disk, batch 4): segm {ap_line(final['segm'])};"
            f" stem launches {n}")
        assert n == SEG_FT_VAL // 4 and all(np.isfinite(v) for v in final["segm"].values())
        del model
        torch.cuda.empty_cache()

        # 3. bisenetformer-l-ade at 640²
        tag = f"segm_train {BISENET_CARD}"
        t0 = time.perf_counter()
        model = ModelManager.get(BISENET_CARD, device=dev, seed=0)
        perturb(model.module, seed=23)
        condition_for_training(model.module)
        scale = condition_mf(model, dev, MF_MASK_STD)
        model16 = ModelManager.get(BISENET_CARD, device=dev, dtype="bfloat16", init_weights=False)
        cpu = ModelManager.get(BISENET_CARD, device="cpu", init_weights=False)
        for m in (model16, cpu):
            m.module.load_state_dict(model.module.state_dict())
        cfg = model.config
        log(f"[{tag}] STDC (base {cfg.backbone_config.base}, layers {cfg.backbone_config.layers}), pixel decoder"
            f" {cfg.pixel_decoder_feat_dim} wide, {cfg.transformer_predictor_dec_layers} decoder layers over 2 scales,"
            f" {cfg.num_classes} classes, {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M params; mask"
            f" head x{scale:.3g} ({time.perf_counter() - t0:.1f}s to build)")
        rng = np.random.default_rng(34)
        requests = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(3)]
        for dtype, m in (("float32", model), ("bfloat16", model16)):
            dets = [m.infer(r, threshold=0.0) for r in requests]
            assert all(len(d.detections) > 0 for d in dets)
            for d in (x for r in dets for x in r.detections):
                x0, y0, x1, y1 = d.bbox
                assert 0 <= x0 <= x1 < 640 and 0 <= y0 <= y1 < 480 and 0.0 <= d.conf <= 1.0 and d.mask
            log(f"[{tag}] {dtype}: infer() on three 480x640 images: {[len(r.detections) for r in dets]} detections")
        batch = rng.integers(0, 256, (2, BISENET_SIZE, BISENET_SIZE, 3), dtype=np.uint8)
        cpu_run = mf_run(cpu.module, batch)
        own = mf_run(model.module, batch)
        errs = compare_mf(tag, cpu_run, {"card fp32": mf_run(model.module, batch, cpu_run[2])})
        assert max(errs["card fp32"]) <= MF_TOL["float32"], "bisenetformer: card fp32 and CPU disagree"
        cpu16 = ModelManager.get(BISENET_CARD, device="cpu", dtype="bfloat16", init_weights=False)
        cpu16.module.load_state_dict(model.module.state_dict())
        errs16 = compare_mf(tag, cpu_run, {"card bf16": mf_run(model16.module, batch, cpu_run[2]),
                                           "CPU bf16": mf_run(cpu16.module, batch, cpu_run[2])})
        del cpu16
        assert max(errs16["card bf16"]) <= MF_TOL["bfloat16"], "bisenetformer: card bf16 and the CPU's fp32 disagree"
        log(f"[{tag}] card vs CPU at {BISENET_SIZE}² B=2 on the CPU's attention masks: fp32 within"
            f" {MF_TOL['float32']:.0e}, bf16 within {MF_TOL['bfloat16']:.0e}; bits that flip without carrying:"
            f" {flip_share(own[2], cpu_run[2]):.3e} of {sum(a.numel() for a in own[2])}")
        g = np.random.default_rng(35)
        xs = {"b1": 1, "b16": 16}
        for dtype, m in (("float32", model), ("bfloat16", model16)):
            x = {k: torch.from_numpy(g.integers(0, 256, (b, BISENET_SIZE, BISENET_SIZE, 3), dtype=np.uint8)).to(dev)
                 for k, b in xs.items()}
            torch.cuda.reset_peak_memory_stats()
            t = serve_timings(m.module, x, {"b1": 10, "b16": 4})
            log(f"[{tag}] {smi}, {dtype}: b1 forward p50 {t['b1'] * 1e3:.2f} ms; b16 forward p50"
                f" {t['b16'] * 1e3:.2f} ms = {16 / t['b16']:.2f} images/s; peak memory"
                f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # evaluation against the CPU's own predictions, then its throughput
        images = [g.integers(0, 256, (BISENET_SIZE, BISENET_SIZE, 3), dtype=np.uint8) for _ in range(MF_GT_IMAGES)]
        entries, cpu_res = mf_entries(cpu, images, semantic=True)
        assert cpu_res["sem_seg"]["mIoU"] == 100.0
        for dtype, m in (("float32", model), ("bfloat16", model16)):
            res, secs = evaluate_timed(m, entries, 2)
            log(f"[{tag}] {smi}: evaluate_dataset {dtype} against the CPU's fp32 predictions of {len(images)} seeded"
                f" images: sem_seg/mIoU {res['sem_seg']['mIoU']:.3f} ({secs:.2f}s)")
            if dtype == "float32":
                assert res["sem_seg"]["mIoU"] >= 99.0, res["sem_seg"]
        data = [entries[i % len(entries)] for i in range(MF_EVAL_IMAGES)]
        evaluate_timed(model, data[:MF_EVAL_BATCH], MF_EVAL_BATCH)
        _, secs = evaluate_timed(model, data, MF_EVAL_BATCH)
        log(f"[{tag}] {smi}, fp32: evaluate_dataset over {MF_EVAL_IMAGES} images at batch {MF_EVAL_BATCH}:"
            f" {MF_EVAL_IMAGES / secs:.2f} images/s; {evaluation.stats['host_bytes'] / evaluation.stats['batches']:.0f}"
            " bytes to the host a batch")

        # one step on the card against the CPU, then FocoosModel.train from disk
        np.random.seed(5)
        step_images, step_targets = model.processor.train(True).preprocess_entries([sem_train[i] for i in range(2)])
        model.processor.train(False)
        compare_mf_train_step(tag, model, model16, cpu, step_images, step_targets)
        del cpu
        b_model = ModelManager.get(BISENET_CARD, device=dev, classes=sem_classes, seed=0)
        perturb(b_model.module, seed=24)
        condition_for_training(b_model.module)
        condition_mf(b_model, dev, MF_MASK_STD)
        b_initial = {k: v.detach().clone() for k, v in b_model.module.state_dict().items()}
        del model, model16
        out_dir = tempfile.mkdtemp(prefix="bisenet_", dir=root)
        for dtype in ("float32", "bfloat16"):
            m = b_model if dtype == "float32" else ModelManager.get(BISENET_CARD, device=dev, classes=sem_classes,
                                                                     dtype=dtype, init_weights=False)
            m.module.load_state_dict(b_initial)
            torch.cuda.reset_peak_memory_stats()
            res, n, row = segm_finetune_run(m, TrainerArgs(
                run_name="bisenet", output_dir=out_dir, batch_size=BISENET_BATCH, max_iters=SEG_FT_STEPS,
                workers=workers, eval_period=SEG_FT_EVAL_PERIOD, checkpointer_period=SEG_FT_STEPS,
                log_period=SEG_FT_STEPS, ema_enabled=True, seed=0, workers_timeout=300, samples=0), sem_train, sem_val)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[{tag}] {smi}, {dtype}: FocoosModel.train {res['iterations']} steps at B={BISENET_BATCH}"
                f" {BISENET_SIZE}² from disk ({len(sem_classes)} classes), validation every {SEG_FT_EVAL_PERIOD}:"
                f" step p50 {row['time'] * 1e3:.2f} ms = {BISENET_BATCH / row['time']:.2f} images/s, data_time p50"
                f" {row['data_time'] * 1e3:.2f} ms; peak memory allocated {peak:.2f} GiB; final val sem_seg/mIoU"
                f" {res['metrics']['sem_seg']['mIoU']:.3f}")
            assert res["iterations"] == SEG_FT_STEPS and n == 0
            assert all(np.isfinite(v) for k, v in row.items() if "loss" in k), row
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[segm_train] stem launches over the phase's counted runs: {total['fused_resnet_stem']}; phase wall time"
        f" {time.perf_counter() - phase_t0:.1f}s")
    return total


# ---------------------------------------------------------------------------
# fai_cls: classification served, evaluated and fine-tuned; rtmo fine-tuned

CLS_CARD, CLS_SIZE = "fai-cls-m-coco", 224
CLS_TOL = {"float32": 1e-3, "bfloat16": 5e-2}  # abs, sigmoid probabilities, card against the CPU's fp32
CLS_LOGIT_STD = 4.0  # the conditioned classifier's logit spread over the compared images
CLS_GT_IMAGES, CLS_EVAL_BATCH = 64, 32
CLS_FT_HW = (240, 320)  # the folder set's JPEGs (height, width)
CLS_FT_TRAIN, CLS_FT_VAL = 64, 16
CLS_FT_BATCH, CLS_FT_STEPS, CLS_FT_EVAL_PERIOD, CLS_FT_PROFILED = 64, 10, 5, 3  # cut from 20 and 10: the time limit
KP_CARD, KP_SIZE = "rtmo-s-coco", 640
KP_FT_HW = (480, 640)  # the keypoint set's JPEGs (height, width): COCO's most common size
KP_FT_TRAIN, KP_FT_VAL = 64, 16
KP_FT_BATCH, KP_FT_STEPS, KP_FT_EVAL_PERIOD, KP_FT_PROFILED = 16, 10, 5, 3  # cut from 20 and 10: the time limit
KP_DCC_TOL = 1e-5  # DCC's running statistics after the card's fp32 step against the CPU's fp64 step, per feature
KP_NAMES = ["nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder", "right_shoulder", "left_elbow",
            "right_elbow", "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee", "right_knee",
            "left_ankle", "right_ankle"]


def kernel_counts() -> dict:
    """Every kernel's launch count, as its wrapper keeps it."""
    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward
    from focoos_tpu_torch.ops.nms import nms_keep
    from focoos_tpu_torch.ops.stem import fused_resnet_stem

    return {"msda_forward": msda_forward.launches, "msda_backward": msda_backward.launches,
            "fused_resnet_stem": fused_resnet_stem.launches, "nms_keep": nms_keep.launches}


def zero_kernel_counts() -> None:
    from focoos_tpu_torch.ops.msda import msda_backward, msda_forward
    from focoos_tpu_torch.ops.nms import nms_keep
    from focoos_tpu_torch.ops.stem import fused_resnet_stem

    for k in (msda_forward, msda_backward, fused_resnet_stem, nms_keep):
        k.launches = 0


def counted(run, total: dict) -> tuple:
    """``run()`` with every kernel's count set to 0 just before and read just
    after (the card synchronized) → (its result, the counts), the counts also
    added to ``total``."""
    zero_kernel_counts()
    out = run()
    torch.cuda.synchronize()
    counts = kernel_counts()
    for k, v in counts.items():
        total[k] += v
    return out, counts


def dcc_stat_errs(got: tuple, ref: tuple, initial: tuple, momentum: float) -> dict:
    """DCC's statistics after one step, ``got`` against ``ref`` (fp64
    running mean and variance, ``rtmo_step_on``), each the max over the
    features: the running mean's error over the running std and the running
    variance's relative error (``running``); the step's own batch
    statistics, recovered as (running - (1 - momentum) * initial) /
    momentum, the mean's error over the batch std and the biased variance's
    relative error (``batch``), with |mean| / std of the feature whose
    variance is worst (``offset``): a variance taken around a mean that many
    times its std loses that many times its inputs' relative precision."""
    (gm, gv), (rm, rv), (m0, v0) = got, ref, (t.double() for t in initial)
    batch = lambda run, init: (run - (1 - momentum) * init) / momentum  # noqa: E731
    bm, bv = batch(rm, m0), batch(rv, v0)
    var_rel = (batch(gv, v0) - bv).abs() / bv
    return dict(running=(float(((gm - rm).abs() / rv.sqrt()).max()), float(((gv - rv).abs() / rv).max())),
                batch=(float(((batch(gm, m0) - bm).abs() / bv.sqrt()).max()), float(var_rel.max())),
                offset=float(bm.abs()[var_rel.argmax()] / bv.sqrt()[var_rel.argmax()]))


def textured(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Per-pixel texture over an image (see ``draw_shapes``)."""
    return np.clip(img.astype(np.int16) + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


def write_folder_set(root: str, n_train: int, n_val: int, hw: tuple, seed: int) -> str:
    """A seeded folder-per-class classification set on local disk (``train/``
    and ``valid/``, one folder per class of ``SHAPE_CLASSES``): JPEGs of ``hw``,
    each a noise background with one textured filled shape of its class,
    classes in turn."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    h, w = hw
    for split, n in (("train", n_train), ("valid", n_val)):
        for i in range(n):
            cls = i % len(SHAPE_CLASSES)
            cdir = os.path.join(root, split, SHAPE_CLASSES[cls])
            os.makedirs(cdir, exist_ok=True)
            img = rng.integers(0, 80, (h, w, 3), np.uint8)
            s = int(rng.integers(min(hw) // 3, min(hw) * 3 // 4))
            x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
            if cls == 0:
                t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
                poly = np.stack([x + s / 2 + s / 2 * np.cos(t), y + s / 2 + s / 2 * np.sin(t)], 1)
            elif cls == 1:
                poly = np.array([[x, y], [x + s, y], [x + s, y + s], [x, y + s]], float)
            else:
                poly = np.array([[x + s / 2, y], [x, y + s], [x + s, y + s]], float)
            cv2.fillPoly(img, [poly.round().astype(np.int32)], tuple(int(c) for c in rng.integers(120, 255, 3)))
            cv2.imwrite(os.path.join(cdir, f"img_{i:04d}.jpg"), textured(rng, img)[:, :, ::-1])
    return root


def write_keypoint_set(root: str, n_train: int, n_val: int, hw: tuple, seed: int) -> str:
    """A seeded Roboflow-COCO person-keypoints set on local disk: JPEGs of
    ``hw``, each with 1-3 textured person shapes (a filled ellipse 1/5 to 1/2
    of the short edge wide, twice as tall) with 17 keypoints inside, drawn
    as bright dots where visible; about a fifth of them unlabelled
    (v = 0, x = y = 0, as COCO marks them)."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    h, w = hw
    for split, n in (("train", n_train), ("valid", n_val)):
        sdir = os.path.join(root, split)
        os.makedirs(sdir, exist_ok=True)
        images, annotations = [], []
        for i in range(n):
            img = rng.integers(0, 80, (h, w, 3), np.uint8)
            for _ in range(int(rng.integers(1, 4))):
                bw = int(rng.integers(min(hw) // 5, min(hw) // 2))
                bh = min(2 * bw, h - 2)
                x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                cv2.ellipse(img, (x + bw // 2, y + bh // 2), (bw // 2, bh // 2), 0, 0, 360,
                            tuple(int(c) for c in rng.integers(120, 255, 3)), -1)
                kpts = []
                for _k in range(17):
                    kx, ky = float(rng.uniform(x + 0.2 * bw, x + 0.8 * bw)), float(rng.uniform(y + 0.1 * bh, y + 0.9 * bh))
                    v = 0 if rng.random() < 0.2 else int(rng.integers(1, 3))
                    if v:
                        cv2.circle(img, (int(kx), int(ky)), 3, (255, 255, 255), -1)
                        kpts += [kx, ky, v]
                    else:
                        kpts += [0.0, 0.0, 0]
                annotations.append(dict(id=len(annotations) + 1, image_id=i, category_id=1, bbox=[x, y, bw, bh],
                                        area=float(bw * bh), iscrowd=0, keypoints=kpts,
                                        num_keypoints=int(sum(1 for j in range(17) if kpts[3 * j + 2]))))
            fn = f"img_{i:04d}.jpg"
            cv2.imwrite(os.path.join(sdir, fn), textured(rng, img)[:, :, ::-1])
            images.append(dict(id=i, file_name=fn, height=h, width=w))
        cats = [dict(id=0, name="people", supercategory="none"),
                dict(id=1, name="person", supercategory="people", keypoints=KP_NAMES,
                     skeleton=[[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13], [6, 7], [6, 8],
                               [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]])]
        with open(os.path.join(sdir, "_annotations.coco.json"), "w") as f:
            json.dump(dict(images=images, annotations=annotations, categories=cats), f)
    return root


def loader_alone(ds, proc, batch: int, workers: int, n_batches: int = 6) -> tuple:
    """The train loader timed alone → (images/s over ``n_batches`` after the
    first, ms a batch, the first batch's seconds, workers starting)."""
    from focoos_tpu_torch.data.loaders import build_train_loader

    proc.train(True)
    loader = build_train_loader(ds, proc, batch, num_workers=workers, seed=0, pin_memory=True, timeout=300)
    try:
        t0 = time.perf_counter()
        next(loader)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(loader)
        load_s = time.perf_counter() - t0
    finally:
        loader.close()
        proc.train(False)
    return batch * n_batches / load_s, load_s * 1e3 / n_batches, first_s


def grad_norm(module) -> float:
    return float(torch.sqrt(sum(torch.dot(p.grad.flatten().double(), p.grad.flatten().double())
                                for p in module.parameters() if p.grad is not None)))


def cls_logits(module, images: np.ndarray) -> torch.Tensor:
    """Eval logits [N, C] of uint8 NHWC ``images`` on the module's device, in batches of 32, on the CPU."""
    dev = next(module.parameters()).device
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), 32):
            out.append(module(torch.from_numpy(images[i:i + 32]).to(dev))[0].logits.float().cpu())
    return torch.cat(out)


def condition_cls(cpu_model, images: np.ndarray) -> tuple:
    """Condition the random classifier for the comparisons and the
    evaluation gate: its logits scaled to a spread of ``CLS_LOGIT_STD`` over
    ``images`` and the classes (the CPU's fp32 forward), and each class's
    bias set to the middle of the widest gap between two of its sorted
    logits, so that every class has images on both sides of the 0.5
    threshold and no logit sits nearer it than half that gap. Random
    features barely tell the images apart (a class's logits spread ~1e-3 of
    the spread over the classes): scaling each class to that spread would
    scale the bf16 rounding of the features with it → (the scale, the
    smallest |logit| over the images)."""
    conv = cpu_model.module.cls_head.classifier[-1]
    u = cls_logits(cpu_model.module, images) - conv.bias.detach()  # [N, C] without the bias
    scale = CLS_LOGIT_STD / float(u.std())
    v = torch.sort(u * scale, dim=0).values
    j = (v[1:] - v[:-1]).argmax(0)
    cols = torch.arange(v.shape[1])
    mid = (v[j, cols] + v[j + 1, cols]) / 2
    with torch.no_grad():
        conv.weight.mul_(scale)
        conv.bias.copy_(-mid)
    return scale, float((u * scale - mid).abs().min())


def phase_fai_cls(dev, smi: str) -> dict:
    """fai-cls-m-coco (STDC-small, 80 classes) at 224², full width: served
    (infer(), card vs CPU at B=2 in fp32 and bf16, b1, b128 and a profiled
    b128 forward), evaluated (classification/f1 against the CPU's own fp32
    predictions), one step against the CPU's in fp64 on a carried dropout
    mask, and FocoosModel.train from a seeded folder-per-class JPEG set on
    disk in fp32 and bf16. No kernel of the port is on this path (STDC has no
    ResNet-D stem): every count must stay 0. Returns the counts."""
    import os
    import shutil
    import tempfile

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import get_default_by_task
    from focoos_tpu_torch.models.fai_cls.loss import classification_loss
    from focoos_tpu_torch.ports import DatasetEntry, Task, TrainerArgs

    phase_t0 = time.perf_counter()
    zero_kernel_counts()
    tag = f"fai_cls {CLS_CARD}"
    workers = min(SEG_WORKERS, os.cpu_count())
    t0 = time.perf_counter()
    model = ModelManager.get(CLS_CARD, device=dev, seed=0)
    perturb(model.module, seed=40)
    condition_for_training(model.module)
    cpu = ModelManager.get(CLS_CARD, device="cpu", init_weights=False)
    cpu.module.load_state_dict(model.module.state_dict())
    rng = np.random.default_rng(41)
    gt_images = np.stack([draw_shapes(rng, CLS_SIZE, CLS_SIZE)[0] for _ in range(CLS_GT_IMAGES)])
    scale, margin = condition_cls(cpu, gt_images)
    model.module.load_state_dict(cpu.module.state_dict())
    model16 = ModelManager.get(CLS_CARD, device=dev, dtype="bfloat16", init_weights=False)
    model16.module.load_state_dict(model.module.state_dict())
    cfg = model.config
    log(f"[{tag}] STDC-{cfg.backbone_config.size} to {cfg.features}, {cfg.num_layers}-layer head, {cfg.num_classes}"
        f" classes, dropout {cfg.dropout_rate}, {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M"
        f" params, {CLS_SIZE}²; weights perturbed and conditioned (logits scaled x{scale:.3g} to std {CLS_LOGIT_STD} over"
        f" {CLS_GT_IMAGES} seeded images, each class's bias in its widest gap: smallest |logit| {margin:.2e})"
        f" ({time.perf_counter() - t0:.1f}s)")

    # the requests
    requests = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(3)]
    for dtype, m in (("float32", model), ("bfloat16", model16)):
        dets = [m.infer(r, threshold=0.0) for r in requests]
        for d in dets:
            assert len(d.detections) == cfg.num_classes, len(d.detections)
            assert all(0.0 <= x.conf <= 1.0 and x.label == m.classes[x.cls_id] for x in d.detections)
        over = [len(m.infer(r).detections) for r in requests]
        log(f"[{tag}] {dtype}: infer() on three 480x640 images: {cfg.num_classes} classes each at threshold 0,"
            f" {over} over the card's threshold {cfg.threshold}; last inference {dets[-1].latency.inference * 1e3:.2f} ms")

    # card vs CPU at B=2 on the same weights
    x2 = gt_images[:2]
    ref = torch.sigmoid(cls_logits(cpu.module, x2))
    cpu16 = ModelManager.get(CLS_CARD, device="cpu", dtype="bfloat16", init_weights=False)
    cpu16.module.load_state_dict(model.module.state_dict())
    errs = {name: float((torch.sigmoid(cls_logits(m.module, x2)) - ref).abs().max())
            for name, m in (("card fp32", model), ("card bf16", model16), ("CPU bf16", cpu16))}
    del cpu16
    log(f"[{tag}] card vs the CPU's fp32 at B=2 {CLS_SIZE}², max abs err of the probabilities: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol fp32 {CLS_TOL['float32']:.0e}, bf16 {CLS_TOL['bfloat16']:.0e})")
    assert errs["card fp32"] <= CLS_TOL["float32"] and errs["card bf16"] <= CLS_TOL["bfloat16"], errs

    # timings: b1 and the JAX bench's b128
    g = np.random.default_rng(42)
    xs = {"b1": torch.from_numpy(g.integers(0, 256, (1, CLS_SIZE, CLS_SIZE, 3), dtype=np.uint8)).to(dev),
          "b128": torch.from_numpy(g.integers(0, 256, (128, CLS_SIZE, CLS_SIZE, 3), dtype=np.uint8)).to(dev)}
    for dtype, m in (("float32", model), ("bfloat16", model16)):
        torch.cuda.reset_peak_memory_stats()
        t = serve_timings(m.module, xs, {"b1": 30, "b128": 10})
        log(f"[{tag}] {smi}, {dtype}: b1 forward p50 {t['b1'] * 1e3:.3f} ms; b128 forward p50 {t['b128'] * 1e3:.2f} ms"
            f" = {128 / t['b128']:.1f} images/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_forwards(f"{tag} {dtype}", "b128 forward", m.module, xs["b128"])

    # evaluation against the CPU's own fp32 predictions
    cpu_logits = cls_logits(cpu.module, gt_images)
    labels = [torch.nonzero(z > 0)[:, 0].tolist() for z in cpu_logits]
    entries = [DatasetEntry(image=im, height=CLS_SIZE, width=CLS_SIZE, label=lab, image_id=i)
               for i, (im, lab) in enumerate(zip(gt_images, labels))]
    near = {tol: int((cpu_logits.abs() < tol).sum()) for tol in (1e-3, 1e-2)}
    for dtype, m in (("float32", model), ("bfloat16", model16)):
        res, secs = evaluate_timed(m, entries, CLS_EVAL_BATCH)
        f1 = res["classification"]["f1"]
        log(f"[{tag}] {smi}: evaluate_dataset {dtype} against the CPU's fp32 predictions of {CLS_GT_IMAGES} images"
            f" ({sum(map(len, labels))} positive labels; of {cpu_logits.numel()} logits, within 1e-3 of the threshold's 0:"
            f" {near[1e-3]}, within 1e-2: {near[1e-2]}): classification/f1 {f1:.3f}, micro_f1 {res['classification']['micro_f1']:.3f}"
            f" ({secs:.2f}s)")
        if dtype == "float32":
            assert f1 >= 99.0, res

    # one step against the CPU's in fp64, on one dropout mask carried to every run
    root = tempfile.mkdtemp(prefix="chip_smoke_fai_cls_")
    try:
        t0 = time.perf_counter()
        write_folder_set(root, CLS_FT_TRAIN, CLS_FT_VAL, CLS_FT_HW, seed=43)
        auto = AutoDataset(root, task="classification")
        train_augs, val_augs = get_default_by_task(Task.CLASSIFICATION, CLS_SIZE)
        ft_train, ft_val = auto.get_split(train_augs, split="train"), auto.get_split(val_augs, split="val")
        classes = ft_train.metadata.classes
        log(f"[{tag}] wrote {CLS_FT_TRAIN} train and {CLS_FT_VAL} val {CLS_FT_HW[1]}x{CLS_FT_HW[0]} JPEGs, one"
            f" textured shape each, folder per class {classes} ({time.perf_counter() - t0:.1f}s)")
        np.random.seed(44)
        images, targets = model.processor.preprocess_entries([ft_train[i] for i in range(2)])
        feats = model.module.backbone.output_shape()[cfg.features].channels
        keep = torch.rand(2, feats, 1, 1, generator=torch.Generator().manual_seed(45)) < 1.0 - cfg.dropout_rate
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}

        def step(m, d) -> tuple:
            m.module.train()
            m.module.zero_grad(set_to_none=True)
            out, _ = m.module(torch.from_numpy(images).to(d), keep=keep.to(d))
            loss = classification_loss(out.logits, targets.to(d), cfg)["loss_cls"]
            loss.backward()
            r = float(loss.detach()), grad_norm(m.module)
            m.module.eval()
            m.module.zero_grad(set_to_none=True)
            m.module.load_state_dict(initial)
            return r

        with cpu_fp64(cpu.module):
            ref_loss, ref_norm = step(cpu, torch.device("cpu"))
        for name, m, (lgate, ngate) in (("fp32", model, (TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL)),
                                        ("bf16", model16, (TRAIN_BF16_TOL, TRAIN_BF16_GRAD_NORM_RTOL))):
            loss, norm = step(m, dev)
            lrel, nrel = abs(loss - ref_loss) / abs(ref_loss), abs(norm - ref_norm) / ref_norm
            log(f"[{tag}] one step at B=2 {tuple(images.shape[1:3])} on mapped train records, dropout mask carried"
                f" ({int(keep.sum())} of {keep.numel()} kept): card {name} vs CPU fp64: loss {loss:.6f} vs {ref_loss:.6f}"
                f" rel {lrel:.3e} (tol {lgate:.0e}); grad_norm {norm:.6f} vs {ref_norm:.6f} rel {nrel:.3e} (tol {ngate:.0e})")
            assert lrel <= lgate and nrel <= ngate, (name, loss, ref_loss, norm, ref_norm)
        del cpu, model16

        # the loader alone, then FocoosModel.train from disk in fp32 and bf16
        ips, ms, first = loader_alone(ft_train, model.processor, CLS_FT_BATCH, workers)
        log(f"[{tag}] {smi}: train loader alone, classification_train_augs at {CLS_SIZE}, B={CLS_FT_BATCH}, {workers}"
            f" workers: {ips:.1f} images/s ({ms:.1f} ms a batch; the first, workers starting, {first:.2f}s)")
        model = ModelManager.get(CLS_CARD, device=dev, classes=classes, seed=0)
        perturb(model.module, seed=46)
        condition_for_training(model.module)
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        out_dir = tempfile.mkdtemp(prefix="ft_", dir=root)

        def args(iters: int, eval_period: int = CLS_FT_EVAL_PERIOD) -> TrainerArgs:
            return TrainerArgs(run_name="fai_cls", output_dir=out_dir, batch_size=CLS_FT_BATCH, max_iters=iters,
                               workers=workers, eval_period=eval_period, checkpointer_period=iters, log_period=iters,
                               ema_enabled=True, seed=0, workers_timeout=300, samples=0)

        for dtype in ("float32", "bfloat16"):
            m = model if dtype == "float32" else ModelManager.get(CLS_CARD, device=dev, classes=classes, dtype=dtype,
                                                                   init_weights=False)
            m.module.load_state_dict(initial)
            torch.cuda.reset_peak_memory_stats()
            res = m.train(args(CLS_FT_STEPS), ft_train, ft_val)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            with open(os.path.join(res["run_dir"], "metrics.json")) as f:
                row = [json.loads(line) for line in f][-1]
            f1 = res["metrics"]["classification"]
            log(f"[{tag}] {smi}, {dtype}: FocoosModel.train {res['iterations']} steps at B={CLS_FT_BATCH} from disk,"
                f" {workers} workers, validation every {CLS_FT_EVAL_PERIOD}: step p50 {row['time'] * 1e3:.2f} ms ="
                f" {CLS_FT_BATCH / row['time']:.1f} images/s, data_time p50 {row['data_time'] * 1e3:.2f} ms; peak"
                f" memory allocated {peak:.2f} GiB; final val classification/f1 {f1['f1']:.3f}, micro_f1"
                f" {f1['micro_f1']:.3f}; loss_cls {row['loss_cls']:.4f}")
            assert res["iterations"] == CLS_FT_STEPS and np.isfinite(row["loss_cls"]), row
            m.module.load_state_dict(initial)
            trainer = profiled_trainer(m, args(CLS_FT_PROFILED + 2, eval_period=0), ft_train, first=1,
                                       n=CLS_FT_PROFILED)
            trainer.train()
            prof, wall = trainer.profile
            busy, by_name = device_busy(prof)
            log(f"[{tag}] {dtype}: {CLS_FT_PROFILED} profiled steps: wall {wall / CLS_FT_PROFILED / 1e3:.2f} ms a step,"
                f" device busy {busy / CLS_FT_PROFILED / 1e3:.2f} ms, idle share {1 - busy / wall:.3f}; cuDNN"
                f" convolutions {kernel_shares(by_name, busy)['conv']:.1%} of busy")
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
                log(f"[{tag}]   {v / CLS_FT_PROFILED / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")
            if dtype == "bfloat16":
                del m
        final = model.eval(TrainerArgs(run_name="eval", batch_size=8), ft_val)
        log(f"[{tag}] FocoosModel.eval ({CLS_FT_VAL} val images from disk, batch 8): {final['classification']}")
        assert 0.0 <= final["classification"]["f1"] <= 100.0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    counts = kernel_counts()
    log(f"[fai_cls] launches over the phase: {counts} (STDC: no kernel of the port on this path); phase wall time"
        f" {time.perf_counter() - phase_t0:.1f}s")
    assert not any(counts.values()), counts
    return counts


def rtmo_step_on(module, cfg, images: np.ndarray, targets, dev, carried=None) -> dict:
    """One train-mode forward + criterion + backward of an rtmo ``module`` on
    ``dev`` (on ``carried``'s assignment where given) → losses, global grad
    norm, the assignment used and DCC's running statistics after it, on the
    CPU. DCC's running buffers are held in fp64 for the step (the module
    still takes its batch statistics in fp32): stored in fp32, ~0.9 of them
    the initial values, their rounding would put a floor of ~4e-5 under
    the recovered batch variance's error (2^-24 x running / (0.1 x batch)
    variance, at rtmo-s's smallest batch variances)."""
    from focoos_tpu_torch.models.rtmo.loss import rtmo_criterion

    bn = module.head["dcc"].pose_to_kpts[1]
    held = {n: getattr(bn, n) for n in ("running_mean", "running_var")}
    for n, t in held.items():
        setattr(bn, n, t.double())
    module.train()
    module.zero_grad(set_to_none=True)
    _, aux = module(torch.from_numpy(images).to(dev))
    losses, used = rtmo_criterion(module.head["dcc"], aux, targets.to(dev), cfg,
                                  carried=None if carried is None else carried.to(dev))
    losses["total"].backward()
    out = dict(losses={k: float(v.detach()) for k, v in losses.items()}, norm=grad_norm(module), used=used.to("cpu"),
               dcc=(bn.running_mean.detach().cpu(), bn.running_var.detach().cpu()))
    for n, t in held.items():
        t.copy_(getattr(bn, n))
        setattr(bn, n, t)
    module.eval()
    module.zero_grad(set_to_none=True)
    return out


def rtmo_criterion_alone(model, images: np.ndarray, targets) -> tuple:
    """The criterion (SimOTA included) and its backward alone on the card at a
    step's shapes, a train-mode forward's raw outputs taken as leaves → (ms
    a call on the host clock around synchronized calls, [B, A, N], one
    profiled call's device busy ms and its largest kernels)."""
    import dataclasses

    from focoos_tpu_torch.models.rtmo.loss import rtmo_criterion

    dev, module = model.device, model.module
    state = {k: v.detach().clone() for k, v in module.state_dict().items()}
    module.train()
    with torch.no_grad():
        _, aux = module(torch.from_numpy(images).to(dev))
    leaves = {f: getattr(aux, f).detach().requires_grad_() for f in ("cls_scores", "bbox_preds", "kpt_offsets",
                                                                      "kpt_vis", "pose_feats")}
    aux = dataclasses.replace(aux, **leaves)
    t = targets.to(dev)

    def call():
        losses, _ = rtmo_criterion(module.head["dcc"], aux, t, model.config)
        losses["total"].backward()

    call()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    module.eval()
    module.zero_grad(set_to_none=True)
    module.load_state_dict(state)
    busy, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return float(np.median(ts)) * 1e3, (*aux.cls_scores.shape[:2], t.labels.shape[1]), busy / 1e3, top


def phase_rtmo_train(dev, smi: str) -> dict:
    """rtmo-s-coco fine-tuned at 640², full width: one B=2 step on mapped
    train records, the card's SimOTA against the CPU's, then the card's step
    on the CPU's assignment against the CPU's step in fp64 (fp32 and bf16,
    DCC's running statistics too); FocoosModel.train from a seeded
    COCO-keypoints set on disk (the train loader alone, fp32 and bf16 with
    keypoint validation, profiled steps, the criterion alone) and
    FocoosModel.eval, every kernel's launches counted from 0 before each
    run: nms_keep once per validation forward, no other kernel; nms_keep
    held against its plain version on a validation batch's candidates.
    Returns every kernel's launches summed over the counted runs."""
    import copy
    import os
    import shutil
    import tempfile

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import get_default_by_task, keypoints_train_augs
    from focoos_tpu_torch.ops.nms import nms_keep, nms_keep_reference, pre_topk
    from focoos_tpu_torch.ports import Task, TrainerArgs

    phase_t0 = time.perf_counter()
    tag = f"rtmo_train {KP_CARD}"
    total = dict.fromkeys(kernel_counts(), 0)
    workers = min(SEG_WORKERS, os.cpu_count())
    root = tempfile.mkdtemp(prefix="chip_smoke_rtmo_train_")
    try:
        t0 = time.perf_counter()
        kp_root = write_keypoint_set(os.path.join(root, "people"), KP_FT_TRAIN, KP_FT_VAL, KP_FT_HW, seed=50)
        auto = AutoDataset(kp_root, task="keypoint")
        augs = copy.deepcopy(keypoints_train_augs)
        kp_train = auto.get_split(augs, split="train")
        kp_val = auto.get_split(get_default_by_task(Task.KEYPOINT, min(KP_FT_HW))[1], split="val")
        v0 = kp_val[0]
        assert v0.image.shape[:2] == (v0.height, v0.width) == KP_FT_HW
        log(f"[rtmo_train] wrote {KP_FT_TRAIN} train and {KP_FT_VAL} val {KP_FT_HW[1]}x{KP_FT_HW[0]} JPEGs with 1-3"
            f" textured people of 17 keypoints, about a fifth unlabelled ({time.perf_counter() - t0:.1f}s); train:"
            f" keypoints_train_augs (640, crop); validation at {min(KP_FT_HW)} (records kept at their size)")

        model = ModelManager.get(KP_CARD, device=dev, seed=0)
        perturb_rtmo(model.module, seed=51, size=KP_SIZE)
        condition_for_training(model.module)
        cfg = model.config
        model16 = ModelManager.get(KP_CARD, device=dev, dtype="bfloat16", init_weights=False)
        cpu = ModelManager.get(KP_CARD, device="cpu", init_weights=False)
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        for m in (model16, cpu):
            m.module.load_state_dict(initial)
        dcc_bn = model.module.head["dcc"].pose_to_kpts[1]
        dcc0 = tuple(initial[f"head.dcc.pose_to_kpts.1.running_{s}"].cpu() for s in ("mean", "var"))
        log(f"[{tag}] CSPDarknet-{cfg.backbone_config.size}, widen {cfg.widen_factor} (SimOTA centres on the visible"
            f" keypoints' mean), {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f}M params; weights"
            f" perturbed (perturb_rtmo) and conditioned (condition_for_training)")

        # one step at B=2: the card's SimOTA against the CPU's, then the step on the CPU's assignment
        np.random.seed(52)
        pair = [kp_train[i] for i in range(2)]
        images, targets = model.processor.train(True).preprocess_entries(pair, max_instances=100)
        model.processor.train(False)
        t0 = time.perf_counter()
        with cpu_fp64(cpu.module):
            ref = rtmo_step_on(cpu.module, cfg, images, targets, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        cpu.module.load_state_dict(initial)
        # the CPU's own fp32 step on its assignment: how far fp32 alone takes DCC's statistics from fp64
        cpu32 = dcc_stat_errs(rtmo_step_on(cpu.module, cfg, images, targets, torch.device("cpu"), carried=ref["used"])
                              ["dcc"], ref["dcc"], dcc0, dcc_bn.momentum)
        cpu.module.load_state_dict(initial)
        own = rtmo_step_on(model.module, cfg, images, targets, dev)
        model.module.load_state_dict(initial)
        r, o = ref["used"], own["used"]
        n_pos, n_own = int(r.pos_mask.sum()), int(o.pos_mask.sum())
        same_set = bool(torch.equal(o.pos_mask, r.pos_mask))
        same_gt = same_set and bool(torch.equal(o.gt_idx[r.pos_mask], r.gt_idx[r.pos_mask]))
        log(f"[{tag}] one step at B=2 {tuple(images.shape[1:3])}, {int(targets.valid.sum())} people, SimOTA over"
            f" [2, {r.pos_mask.shape[1]} priors, {targets.valid.shape[1]} gt]: the CPU's fp64 step ({cpu_s:.1f}s) has"
            f" {n_pos} positives, the card's own SimOTA {n_own}; the same positive set {same_set}, the same gt index"
            f" {same_gt}")
        assert n_pos > 0 and n_own == n_pos and same_set and same_gt, "the card's SimOTA differs from the CPU's"
        for name, m, gate, ngate in (("fp32", model, TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL),
                                     ("bf16", model16, TRAIN_BF16_TOL, TRAIN_BF16_GRAD_NORM_RTOL)):
            got = rtmo_step_on(m.module, cfg, images, targets, dev, carried=r)
            m.module.load_state_dict(initial)
            keys = [k for k in ref["losses"] if k.startswith("loss_") or k == "total"]
            if name == "fp32":
                errs = {k: abs(got["losses"][k] - ref["losses"][k]) / max(abs(ref["losses"][k]), 1e-12) for k in keys}
            else:  # bf16: each loss within TRAIN_BF16_TOL of the total
                errs = {k: abs(got["losses"][k] - ref["losses"][k]) / abs(ref["losses"]["total"]) for k in keys}
            worst = max(errs, key=errs.get)
            nrel = abs(got["norm"] - ref["norm"]) / ref["norm"]
            dcc = dcc_stat_errs(got["dcc"], ref["dcc"], dcc0, dcc_bn.momentum)
            log(f"[{tag}] card {name} vs CPU fp64 on the CPU's assignment: "
                + ", ".join(f"{k} {got['losses'][k]:.6f}/{ref['losses'][k]:.6f}" for k in keys)
                + f"; max {'rel err' if name == 'fp32' else 'err / total'} {errs[worst]:.3e} ({worst}, tol {gate:.0e});"
                f" grad_norm {got['norm']:.6f} vs {ref['norm']:.6f} rel {nrel:.3e} (tol {ngate:.0e})")
            for what, e in ((f"card {name}", dcc),) + ((("the CPU's own fp32", cpu32),) if name == "fp32" else ()):
                log(f"[{tag}] DCC's statistics, {what} vs CPU fp64: running mean {e['running'][0]:.3e} of the running"
                    f" std, running variance {e['running'][1]:.3e} rel; the step's batch statistics: mean"
                    f" {e['batch'][0]:.3e} of the batch std, variance {e['batch'][1]:.3e} rel (that feature's |mean|"
                    f" {e['offset']:.1f} std)" + (f"; gates: running ≤ {KP_DCC_TOL:.0e}, batch no farther than the"
                                                  " CPU's own fp32" if what == "card fp32" else ""))
            assert errs[worst] <= gate, f"{name} {worst}: card {got['losses'][worst]} vs CPU {ref['losses'][worst]}"
            assert nrel <= ngate, f"{name} grad_norm: card {got['norm']} vs CPU {ref['norm']}"
            assert got["losses"]["num_pos"] == ref["losses"]["num_pos"]
            if name == "fp32":  # the batch statistics, undiluted, lie beyond fp32's reach of 1e-5 (the CPU's own)
                assert max(dcc["running"]) <= KP_DCC_TOL, f"DCC's running statistics: {dcc['running']}"
                assert all(c <= k for c, k in zip(dcc["batch"], cpu32["batch"])), f"DCC's batch statistics: {dcc}"
        del cpu, model16

        # the loader alone and the criterion alone at the run's batch
        ips, ms, first = loader_alone(kp_train, model.processor, KP_FT_BATCH, workers)
        log(f"[{tag}] {smi}: train loader alone, keypoints_train_augs, B={KP_FT_BATCH}, {workers} workers:"
            f" {ips:.1f} images/s ({ms:.1f} ms a batch; the first, workers starting, {first:.2f}s)")
        np.random.seed(53)
        batch, tg = model.processor.train(True).preprocess_entries([kp_train[i] for i in range(KP_FT_BATCH)],
                                                                   max_instances=100)
        model.processor.train(False)
        crit_ms, shape, crit_busy, top = rtmo_criterion_alone(model, batch, tg)
        log(f"[{tag}] {smi}: the criterion (SimOTA over {list(shape)}, {int(tg.valid.sum())} people) and its backward"
            f" alone: {crit_ms:.2f} ms on the host clock; a profiled call keeps the card busy {crit_busy:.2f} ms,"
            " largest kernels " + ", ".join(f"{k[:60]} {v / 1e3:.2f} ms" for k, v in top))

        out_dir = tempfile.mkdtemp(prefix="ft_", dir=root)

        def args(iters: int, eval_period: int = KP_FT_EVAL_PERIOD) -> TrainerArgs:
            return TrainerArgs(run_name="rtmo_train", output_dir=out_dir, batch_size=KP_FT_BATCH, max_iters=iters,
                               workers=workers, eval_period=eval_period, checkpointer_period=iters, log_period=iters,
                               ema_enabled=True, seed=0, workers_timeout=300, samples=0)

        val_forwards = -(-KP_FT_VAL // (KP_FT_BATCH // 2))  # evaluate_dataset's batches at the trainer's B/2
        n_evals = KP_FT_STEPS // KP_FT_EVAL_PERIOD + 1  # the validations and the final metrics
        for dtype in ("float32", "bfloat16"):
            m = model if dtype == "float32" else ModelManager.get(KP_CARD, device=dev, dtype=dtype, init_weights=False)
            m.module.load_state_dict(initial)
            torch.cuda.reset_peak_memory_stats()
            res, counts = counted(lambda: m.train(args(KP_FT_STEPS), kp_train, kp_val), total)
            n = counts["nms_keep"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            with open(os.path.join(res["run_dir"], "metrics.json")) as f:
                row = [json.loads(line) for line in f][-1]
            kp = res["metrics"]["keypoints"]
            log(f"[{tag}] {smi}, {dtype}: FocoosModel.train {res['iterations']} steps at B={KP_FT_BATCH} {KP_SIZE} from"
                f" disk, {workers} workers, validation every {KP_FT_EVAL_PERIOD}: step p50 {row['time'] * 1e3:.2f} ms ="
                f" {KP_FT_BATCH / row['time']:.1f} images/s, data_time p50 {row['data_time'] * 1e3:.2f} ms; peak"
                f" memory allocated {peak:.2f} GiB; final val keypoints {ap_line(kp)}; losses "
                + ", ".join(f"{k} {row[k]:.4f}" for k in sorted(row) if k.startswith("loss_"))
                + f", num_pos {row.get('num_pos', float('nan')):.1f}; launches {counts} (nms_keep: {n_evals} evaluations x"
                f" {val_forwards} forwards)")
            assert res["iterations"] == KP_FT_STEPS and n == n_evals * val_forwards, (res["iterations"], n)
            assert not any(v for k, v in counts.items() if k != "nms_keep"), counts
            assert all(np.isfinite(v) for k, v in row.items() if "loss" in k), row
            assert 0.0 <= kp["AP"] <= 100.0, kp
            m.module.load_state_dict(initial)
            trainer = profiled_trainer(m, args(KP_FT_PROFILED + 2, eval_period=0), kp_train, first=1, n=KP_FT_PROFILED)
            trainer.train()
            prof, wall = trainer.profile
            busy, by_name = device_busy(prof)
            sh = kernel_shares(by_name, busy)
            log(f"[{tag}] {dtype}: {KP_FT_PROFILED} profiled steps: wall {wall / KP_FT_PROFILED / 1e3:.2f} ms a step,"
                f" device busy {busy / KP_FT_PROFILED / 1e3:.2f} ms, idle share {1 - busy / wall:.3f}; cuDNN"
                f" convolutions {sh['conv']:.1%} of busy, layout transposes {sh['transpose']:.1%}")
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                log(f"[{tag}]   {v / KP_FT_PROFILED / 1e3:9.3f} ms {v / busy:6.1%}  {k[:110]}")
            if dtype == "bfloat16":
                del m
        final, counts = counted(lambda: model.eval(TrainerArgs(run_name="eval", batch_size=8), kp_val), total)
        n = counts["nms_keep"]
        log(f"[{tag}] FocoosModel.eval ({KP_FT_VAL} val images from disk, batch 8): keypoints"
            f" {ap_line(final['keypoints'])}; launches {counts}")
        assert n == -(-KP_FT_VAL // 8) and all(np.isfinite(v) for v in final["keypoints"].values())
        assert not any(v for k, v in counts.items() if k != "nms_keep"), counts

        # the NMS kernel against its plain version on a validation batch's candidates (outside the counts)
        vb, _ = model.processor.preprocess([kp_val[i] for i in range(8)])
        with torch.inference_mode():
            boxes, scores, _ = model.module.candidates(model.module.raw_outputs(torch.from_numpy(vb).to(dev)))
            top_boxes, top_scores, _ = pre_topk(boxes, scores, cfg.nms_pre_topk, cfg.score_thr)
            keep = nms_keep(top_boxes, top_scores, cfg.nms_thr)
            plain = nms_keep_reference(top_boxes, top_scores, cfg.nms_thr)
        differ, kept, valid = int((keep != plain).sum()), int(keep.sum()), int((top_scores > 0).sum())
        log(f"[{tag}] nms_keep on a validation batch's candidates [{top_boxes.shape[0]}, {top_boxes.shape[1]}]"
            f" (thr {cfg.nms_thr}): {differ} keep-mask entries differ from the plain version; {kept} kept of {valid}"
            " valid")
        assert differ == 0, f"nms_keep on the validation candidates: {differ} entries differ"
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[rtmo_train] launches over the phase's counted runs: {total}; phase wall time"
        f" {time.perf_counter() - phase_t0:.1f}s")
    return total


# ---------------------------------------------------------------------------
# user_data: a user's own dataset, converted, augmented and fine-tuned (multi-step calls)
UD_CARD = "fai-detr-l-coco"
UD_HW = (480, 640)  # the Supervisely set's JPEGs (height, width): COCO's most common size
UD_TRAIN, UD_VAL = 32, 8
UD_BATCH, UD_K, UD_STEPS = 8, 2, 12
UD_CKPT_PERIOD = 5  # not a multiple of K: a period boundary falls inside a call
UD_PROFILED = (4, 4)  # ProfilerHook over iterations 4-7: calls 3 and 4
UD_GATE_STEPS = 4  # K=2 against K=1: 4 steps each from the same weights and loader order
UD_SGD_LR = 1e-2  # the SGD gate runs' learning rate (SGD's usual): one update moves the losses and the parameters
UD_PARAM_SHARE = 0.02  # SGD, K=2 against K=1: max |Δparam| within this share of the 4 steps' max |θ4 − θ0|
UD_ADAMW_LOSS_RTOL = 1e-4  # AdamW, K=2 against K=1, first call: two K=1 runs' first calls differ by up to 1.9e-5
UD_VAL_SIZE = 480  # the exact path: the 640x480 records stay unresized (ROADMAP Queue 3)


def write_supervisely_set(root: str, n_train: int, n_val: int, hw: tuple, seed: int) -> str:
    """A seeded Supervisely detection folder, ``<split>/img/*.jpg`` and
    ``<split>/ann/<image>.json``: ``draw_shapes`` images of ``hw``, each
    square a rectangle object and each circle and triangle a polygon."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("valid", n_val)):
        img_dir, ann_dir = os.path.join(root, split, "img"), os.path.join(root, split, "ann")
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        for i in range(n):
            img, shapes = draw_shapes(rng, *hw)
            objects = []
            for cls, poly in shapes:
                pts = poly.round().astype(int)
                if SHAPE_CLASSES[cls] == "square":
                    geom = ("rectangle", [pts.min(0).tolist(), pts.max(0).tolist()])
                else:
                    geom = ("polygon", pts.tolist())
                objects.append({"classTitle": SHAPE_CLASSES[cls], "geometryType": geom[0],
                                "points": {"exterior": geom[1], "interior": []}})
            fn = f"img_{i:04d}.jpg"
            cv2.imwrite(os.path.join(img_dir, fn), img[:, :, ::-1])
            with open(os.path.join(ann_dir, fn + ".json"), "w") as f:
                json.dump({"size": {"height": hw[0], "width": hw[1]}, "objects": objects}, f)
    return root


def user_augmentations() -> list:
    """A user's own augmentation list, built of the augmentations no preset uses."""
    from focoos_tpu_torch.data import transforms as T

    return [T.RandomBrightness(0.8, 1.2), T.RandomContrast(0.8, 1.2), T.RandomSaturation(0.8, 1.2),
            T.RandomLighting(0.1), T.MinIoURandomCrop(prob=0.5), T.RandomExtent((0.8, 1.2), (0.2, 0.2)),
            T.ResizeScale(0.5, 1.5, 640, 640), T.FixedSizeCrop((640, 640))]


def history(trainer, keys) -> dict:
    """{iteration: {key: value}} of a trained FocoosTrainer's storage."""
    out = {}
    for key in keys:
        for v, it in trainer.loop.storage.history(key).values():
            out.setdefault(int(it), {})[key] = v
    return out


def phase_user_data(dev, smi: str) -> dict:
    """A user's own detection data through the port's data and training API
    on fai-detr-l-coco at full width (``perturb``, ``condition_for_training``):
    a Supervisely folder converted by ``data/converters.py`` into the
    Roboflow-COCO layout (and one image and its mask resized), a train split
    mapped through a user augmentation list, FocoosModel.train with
    ``steps_per_call=2`` (checkpoints, a resume, ``ProfilerHook``, the
    TensorBoard writer where tensorboardX imports, validation at 480), the
    K=2 calls held against K=1 steps, ``retry_if_oom`` on the card and
    ``device_op_ms``. Every kernel's launches counted from 0 before each
    counted run. Returns them summed over those runs."""
    import importlib.util
    import os
    import shutil
    import tempfile

    import cv2

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.converters import (
        get_output_shape,
        resize_shortest_length,
        supervisely_to_coco,
        supervisely_to_semseg_masks,
    )
    from focoos_tpu_torch.data.datasets import DictDataset, MapDataset
    from focoos_tpu_torch.data.default_aug import DatasetAugmentations
    from focoos_tpu_torch.data.mappers import get_mapper_by_task
    from focoos_tpu_torch.ports import Task, TrainerArgs
    from focoos_tpu_torch.trainer.checkpointer import Checkpointer
    from focoos_tpu_torch.trainer.hooks import ProfilerHook
    from focoos_tpu_torch.trainer.solver import Solver
    from focoos_tpu_torch.trainer.trainer import FocoosTrainer
    from focoos_tpu_torch.utils.memory import retry_if_oom
    from focoos_tpu_torch.utils.profiling import device_events, device_op_ms, parse_trace, parse_trace_busy_us

    phase_t0 = time.perf_counter()
    tag = "user_data"
    total = dict.fromkeys(kernel_counts(), 0)
    workers = min(SEG_WORKERS, os.cpu_count())
    root = tempfile.mkdtemp(prefix="chip_smoke_user_data_")
    try:
        # 1. convert: Supervisely → Roboflow-COCO, and one image and its mask resized
        t0 = time.perf_counter()
        sv = write_supervisely_set(os.path.join(root, "supervisely"), UD_TRAIN, UD_VAL, UD_HW, seed=60)
        coco_root = os.path.join(root, "coco")
        n_objects = 0
        for split in ("train", "valid"):
            img_dir, ann_dir, out = (os.path.join(sv, split, "img"), os.path.join(sv, split, "ann"),
                                     os.path.join(coco_root, split))
            os.makedirs(out)
            supervisely_to_coco(ann_dir, img_dir, os.path.join(out, "_annotations.coco.json"), class_list=SHAPE_CLASSES)
            for fn in os.listdir(img_dir):
                shutil.copy(os.path.join(img_dir, fn), out)
            with open(os.path.join(out, "_annotations.coco.json")) as f:
                coco = json.load(f)
            for fn in os.listdir(ann_dir):
                with open(os.path.join(ann_dir, fn)) as f:
                    n_objects += len(json.load(f)["objects"])
            assert len(coco["images"]) == len(os.listdir(img_dir)) and [c["name"] for c in coco["categories"]] == \
                SHAPE_CLASSES, coco["categories"]
        masks_dir = supervisely_to_semseg_masks(os.path.join(sv, "valid", "ann"), os.path.join(root, "masks"),
                                                SHAPE_CLASSES)
        want = get_output_shape(*UD_HW, 320, 640)
        small_img = resize_shortest_length(os.path.join(sv, "valid", "img", "img_0000.jpg"), os.path.join(root, "s"),
                                           320, 640)
        small_mask = resize_shortest_length(os.path.join(masks_dir, "img_0000_mask.png"), os.path.join(root, "s"),
                                            320, 640, is_mask=True)
        img_s, mask_s = cv2.imread(small_img), cv2.imread(small_mask, cv2.IMREAD_UNCHANGED)
        assert img_s.shape[:2] == mask_s.shape == want, (img_s.shape, mask_s.shape, want)
        assert set(np.unique(mask_s).tolist()) <= {0, 1, 2, 255} and len(np.unique(mask_s)) > 1
        base = DictDataset.from_roboflow_coco(os.path.join(coco_root, "train"), Task.DETECTION)
        n_anns = sum(len(r["annotations"]) for r in base)
        classes = base.metadata.classes
        train_ds = MapDataset(base, get_mapper_by_task(Task.DETECTION, user_augmentations(), is_train=True))
        val_ds = AutoDataset(coco_root, task="detection").get_split(DatasetAugmentations(resolution=UD_VAL_SIZE),
                                                                     split="val")
        v0 = val_ds[0]
        assert v0.image.shape[:2] == (v0.height, v0.width) == UD_HW
        np.random.seed(61)
        shapes = sorted({train_ds[i].image.shape for i in range(8)})
        assert shapes == [(640, 640, 3)], shapes
        log(f"[{tag}] wrote a Supervisely folder of {UD_TRAIN} train and {UD_VAL} val {UD_HW[1]}x{UD_HW[0]} JPEGs,"
            f" {n_objects} objects (squares as rectangles, circles and triangles as polygons);"
            f" supervisely_to_coco → the Roboflow-COCO layout: classes {classes}, {n_anns} train annotations;"
            f" supervisely_to_semseg_masks, then resize_shortest_length of one image and its mask to {want}"
            f" (get_output_shape) ({time.perf_counter() - t0:.1f}s). Train: a user augmentation list"
            f" ({', '.join(type(a).__name__ for a in user_augmentations())}), mapped records {shapes};"
            f" validation at {UD_VAL_SIZE} (records kept at their size)")

        model = ModelManager.get(UD_CARD, device=dev, classes=classes, seed=0)
        perturb(model.module, seed=62)
        condition_for_training(model.module)
        n_dec = model.config.transformer_predictor_dec_layers
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        out_dir = os.path.join(root, "runs")

        def args(iters: int, k: int, **kw) -> TrainerArgs:
            kw = {"checkpointer_period": 10**6, "log_period": iters, **kw}  # one checkpoint: model_final
            return TrainerArgs(run_name="user_data", output_dir=out_dir, batch_size=UD_BATCH, max_iters=iters,
                               steps_per_call=k, workers=workers, ema_enabled=True, seed=0, workers_timeout=300,
                               eval_period=0, samples=0, **kw)

        # 2. K=2 against K=1: the same weights and loader order, each inner step's LR recorded, 4 steps a run.
        # SGD: losses, grad_norm and LR as the K=1 steps', and the parameters within UD_PARAM_SHARE of how far
        # the steps moved them; two planted faults, a call whose second inner step repeats the first batch and
        # one whose second inner step skips its update, must fail that gate. AdamW, the default optimizer, is
        # held on its first call's metrics: Adam moves a parameter whose gradient is noise (the MSDA backward's
        # atomics) by ±lr either way, and the gap grows over the steps: two K=1 runs' second calls differ by
        # up to 1.2e-2 in loss (one run in ten on an H100), their first calls by up to 1.9e-5
        import focoos_tpu_torch.trainer.trainer as trainer_mod

        lrs, fault = [], [None]
        real_step, real_multi = Solver.step, trainer_mod.build_multi_train_step

        def recording_step(self, step):
            lrs.append((step, self.schedule(step)))
            if fault[0] == "skip" and step % 2:  # the call's second inner step: its gradients, then no update
                self.optimizer.step = lambda: None
                try:
                    return real_step(self, step)
                finally:
                    del self.optimizer.step
            return real_step(self, step)

        def faulty_multi(step_fn, steps_per_call):
            multi = real_multi(step_fn, steps_per_call)
            if fault[0] != "repeat":
                return multi
            return lambda state, batches: multi(state, [batches[0]] * len(batches))

        sgd = {"optimizer": "SGD", "learning_rate": UD_SGD_LR, "optimizer_extra": {"momentum": 0.9}}
        repeat, skip = "SGD K=2, the second inner step on the first batch", "SGD K=2, the second inner update skipped"
        plan = (("SGD K=2", 2, sgd, None), ("SGD K=1", 1, sgd, None), ("SGD K=1 again", 1, sgd, None),
                (repeat, 2, sgd, "repeat"), (skip, 2, sgd, "skip"),
                ("AdamW K=2", 2, {}, None), ("AdamW K=1", 1, {}, None), ("AdamW K=1 again", 1, {}, None))
        runs = {}
        Solver.step, trainer_mod.build_multi_train_step = recording_step, faulty_multi
        try:
            for name, k, opt, planted in plan:
                fault[0] = planted
                model.module.load_state_dict(initial)
                lrs.clear()
                trainer = FocoosTrainer(model, args(UD_GATE_STEPS, k, **opt), train_ds)
                res, counts = counted(trainer.train, total)
                assert res["iterations"] == UD_GATE_STEPS and trainer.loop.state.step == UD_GATE_STEPS, res
                assert counts["msda_forward"] == counts["msda_backward"] == n_dec * UD_GATE_STEPS, counts
                keys = [k_ for k_ in trainer.loop.storage.histories() if "loss" in k_ or k_ == "grad_norm"]
                runs[name] = dict(metrics=history(trainer, keys), lrs=list(lrs),
                                  times=history(trainer, ["time", "data_time"]),
                                  params={n: p.detach().clone() for n, p in model.module.named_parameters()})
        finally:
            Solver.step, trainer_mod.build_multi_train_step = real_step, real_multi
        assert sorted(runs["SGD K=2"]["metrics"]) == list(range(0, UD_GATE_STEPS, 2)), runs["SGD K=2"]["metrics"]

        def call_errs(calls: dict, steps: dict) -> tuple:
            """Each call's metrics against the mean of its two steps' → (worst loss rel err, its key, grad_norm's)."""
            loss, where, norm = 0.0, None, 0.0
            for it, got in calls.items():
                for key, v in got.items():
                    mean = (steps[it][key] + steps[it + 1][key]) / 2
                    rel = abs(v - mean) / max(abs(mean), 1e-12)
                    if key == "grad_norm":
                        norm = max(norm, rel)
                    elif rel >= loss:
                        loss, where = rel, f"{key} at {it}"
            return loss, where, norm

        def as_calls(run: dict) -> dict:
            """A K=1 run with its steps' metrics paired into K=2 calls (the floor two K=1 runs give)."""
            m = run["metrics"]
            return dict(run, metrics={it: {k_: (v + m[it + 1][k_]) / 2 for k_, v in m[it].items()}
                                      for it in range(0, UD_GATE_STEPS, 2)})

        scale = max(float(p.abs().max()) for p in runs["SGD K=1"]["params"].values())

        def param_diff(a: dict, b: dict) -> float:
            return max(float((a[n] - b[n]).abs().max()) for n in a) / scale

        def k_errs(two: dict, one: dict, calls: int = UD_GATE_STEPS // 2) -> dict:
            loss, where, norm = call_errs({it: two["metrics"][it] for it in range(0, 2 * calls, 2)}, one["metrics"])
            return {"loss": loss, "where": where, "norm": norm, "lr": two["lrs"] == one["lrs"],
                    "param": param_diff(two["params"], one["params"])}

        def k_gate(e: dict, loss_tol: float, param_tol: float = float("inf")) -> bool:
            return e["loss"] <= loss_tol and e["norm"] <= TRAIN_GRAD_NORM_RTOL and e["lr"] and e["param"] <= param_tol

        moved = {o: param_diff(runs[f"{o} K=1"]["params"], initial) for o in ("SGD", "AdamW")}
        param_tol = UD_PARAM_SHARE * moved["SGD"]
        errs = {"SGD K=2": k_errs(runs["SGD K=2"], runs["SGD K=1"]),
                "SGD K=1 again": k_errs(as_calls(runs["SGD K=1 again"]), runs["SGD K=1"]),
                repeat: k_errs(runs[repeat], runs["SGD K=1"]), skip: k_errs(runs[skip], runs["SGD K=1"]),
                "AdamW K=2": k_errs(runs["AdamW K=2"], runs["AdamW K=1"]),
                "AdamW K=1 again": k_errs(as_calls(runs["AdamW K=1 again"]), runs["AdamW K=1"]),
                "AdamW K=2, first call": k_errs(runs["AdamW K=2"], runs["AdamW K=1"], calls=1),
                "AdamW K=1 again, first call": k_errs(as_calls(runs["AdamW K=1 again"]), runs["AdamW K=1"], calls=1)}
        sgd_pass = {n: k_gate(errs[n], TRAIN_LOSS_RTOL, param_tol) for n in ("SGD K=2", repeat, skip)}
        log(f"[{tag}] {smi}: K=2 against K=1 from the same weights and loader order, {UD_GATE_STEPS} steps each at"
            f" B={UD_BATCH}: each call's metrics against the mean of its two K=1 steps (a second K=1 run's pairs"
            f" beside: the floor), max |Δparam| / max |param| after {UD_GATE_STEPS} steps (the EMA's); the steps"
            f" moved the parameters max |θ4 − θ0| / max |θ| = {moved['SGD']:.3e} under SGD at lr {UD_SGD_LR:g},"
            f" {moved['AdamW']:.3e} under AdamW at lr {runs['AdamW K=1']['lrs'][0][1]:g}; "
            + "; ".join(f"{n}: losses {e['loss']:.3e} ({e['where']}), grad_norm {e['norm']:.3e}, LR equal {e['lr']},"
                        f" Δparam {e['param']:.3e}" + (f", gate {'passed' if sgd_pass[n] else 'failed'}"
                                                        if n in sgd_pass else "") for n, e in errs.items())
            + f"; SGD gate: losses ≤ {TRAIN_LOSS_RTOL:.0e}, grad_norm ≤ {TRAIN_GRAD_NORM_RTOL:.0e}, Δparam ≤"
            f" {UD_PARAM_SHARE} of the steps' {moved['SGD']:.3e} = {param_tol:.3e}; AdamW, first call: losses ≤"
            f" {UD_ADAMW_LOSS_RTOL:.0e}, grad_norm ≤ {TRAIN_GRAD_NORM_RTOL:.0e}; LRs"
            f" {[f'{lr:.3e}' for _, lr in runs['SGD K=1']['lrs']]} (SGD),"
            f" {[f'{lr:.3e}' for _, lr in runs['AdamW K=1']['lrs']]} (AdamW)")
        assert sgd_pass["SGD K=2"], errs["SGD K=2"]
        assert not sgd_pass[repeat] and not sgd_pass[skip], (errs[repeat], errs[skip])
        assert k_gate(errs["AdamW K=2, first call"], UD_ADAMW_LOSS_RTOL), errs["AdamW K=2, first call"]
        assert [s for s, _ in runs["SGD K=1"]["lrs"]] == list(range(UD_GATE_STEPS)), runs["SGD K=1"]["lrs"]
        for name, k in (("SGD K=1", 1), ("SGD K=2", 2)):
            t = runs[name]["times"]
            steps = [t[it]["time"] / k for it in sorted(t)[1:]]  # the first call waits for the workers
            data = [t[it]["data_time"] for it in sorted(t)[1:]]
            log(f"[{tag}] {smi}, {name}: step p50 {np.median(steps) * 1e3:.2f} ms (a call / K, the first call left"
                f" out), data_time p50 {np.median(data) * 1e3:.2f} ms a call")
        del runs

        # 3. the fine-tune: 12 steps at K=2, checkpoints every 5, the profiler over calls 3-4, validation
        saves = []
        real_save = Checkpointer.save

        def recording_save(self, name, state, **extra):
            saves.append((name, int(extra.get("iteration", -1))))
            return real_save(self, name, state, **extra)

        prof = ProfilerHook(os.path.join(root, "profile"), *UD_PROFILED)

        class UserTrainer(FocoosTrainer):
            def _register_hooks(self, loop, checkpointer, schedule) -> None:
                super()._register_hooks(loop, checkpointer, schedule)
                prof.trainer = loop
                loop.hooks.insert(0, prof)

        ckpt_dir = os.path.join(root, "ckpt")
        model.module.load_state_dict(initial)
        Checkpointer.save = recording_save
        try:
            trainer = UserTrainer(model, args(UD_STEPS, UD_K, checkpointer_period=UD_CKPT_PERIOD,
                                              checkpointer_max_to_keep=2, ckpt_dir=ckpt_dir, log_period=2),
                                  train_ds, val_ds)
            t0 = time.perf_counter()
            res, counts = counted(trainer.train, total)
            wall = time.perf_counter() - t0
        finally:
            Checkpointer.save = real_save
        val_forwards = -(-UD_VAL // (UD_BATCH // 2))  # the final validation at the trainer's B/2
        box = res["metrics"]["bbox"]
        t = history(trainer, ["time", "data_time"])
        log(f"[{tag}] {smi}: FocoosModel.train {res['iterations']} steps at B={UD_BATCH}, steps_per_call={UD_K},"
            f" {workers} workers, {wall:.1f}s with the final validation; a call p50"
            f" {np.median([v['time'] for v in t.values()]) * 1e3:.2f} ms, data_time p50"
            f" {np.median([v['data_time'] for v in t.values()]) * 1e3:.2f} ms a call; final val bbox"
            f" {ap_line(box)}; launches {counts}")
        assert res["iterations"] == UD_STEPS and trainer.loop.state.step == UD_STEPS
        assert counts["msda_backward"] == n_dec * UD_STEPS, counts
        assert counts["msda_forward"] == n_dec * (UD_STEPS + val_forwards), counts
        assert counts["fused_resnet_stem"] == val_forwards and counts["nms_keep"] == 0, counts
        assert all(np.isfinite(v) for v in box.values()) and 0.0 <= box["AP"] <= 100.0, box
        # checkpoints: JAX's rule, a save when a multiple of the period falls in (it, it + K], named by the last step
        want = [(f"model_{it + UD_K - 1:07d}", it + UD_K - 1) for it in range(0, UD_STEPS, UD_K)
                if (it + UD_K) // UD_CKPT_PERIOD > it // UD_CKPT_PERIOD] + [("model_final", UD_STEPS - 1)]
        log(f"[{tag}] checkpoints saved (name, iteration): {saves}; JAX's rule for period {UD_CKPT_PERIOD} at"
            f" K={UD_K}: {want}")
        assert saves == want, (saves, want)
        tb = os.path.join(res["run_dir"], "tb")
        if importlib.util.find_spec("tensorboardX") is None:
            log(f"[{tag}] tensorboardX is not installed here: the trainer ran without its TensorBoard writer")
            assert not os.path.exists(tb)
        else:
            events = [f for f in os.listdir(tb) if f.startswith("events.out.tfevents")]
            log(f"[{tag}] tensorboardX imports: the TensorBoard writer wrote {events} in the run dir")
            assert events
        # the profiler's window: two calls, MSDA 6 + 6 a step in its trace
        n_prof = UD_PROFILED[1]
        dur, _ = parse_trace(prof.trace_path)
        evs = device_events(prof.trace_path)
        n_fwd = sum(1 for e in evs if "msda_forward_" in e["name"])
        n_bwd = sum(1 for e in evs if "msda_backward_" in e["name"])
        busy_file = parse_trace_busy_us(prof.trace_path)
        busy_mem, _ = device_busy(prof.profiler)
        with open(prof.trace_path) as f:
            xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
        span = max(float(e["ts"]) + float(e["dur"]) for e in xs) - min(float(e["ts"]) for e in xs)
        top = sorted(dur.items(), key=lambda kv: -kv[1])[:4]
        log(f"[{tag}] {smi}: ProfilerHook over iterations {UD_PROFILED[0]}-{UD_PROFILED[0] + n_prof - 1}"
            f" ({os.path.basename(prof.trace_path)}, {os.path.getsize(prof.trace_path) / 2**20:.1f} MiB): MSDA forward"
            f" kernels {n_fwd}, backward {n_bwd} ({n_dec} each a step expected); device busy from the trace file"
            f" {busy_file / 1e3:.2f} ms, from the profiler's events {busy_mem / 1e3:.2f} ms (rel"
            f" {abs(busy_file - busy_mem) / max(busy_mem, 1e-9):.2e}); {busy_file / n_prof / 1e3:.2f} ms a step, idle"
            f" share {1 - busy_file / span:.3f} of the trace's span; largest kernels "
            + ", ".join(f"{k[:50]} {v / max(busy_file, 1e-9):.1%}" for k, v in top))
        assert n_fwd == n_dec * n_prof and n_bwd == n_dec * n_prof, (n_fwd, n_bwd)
        assert abs(busy_file - busy_mem) <= 0.01 * busy_mem, (busy_file, busy_mem)

        # a resume from model_0000005 continues at iteration 6
        with open(os.path.join(ckpt_dir, "last_checkpoint"), "w") as f:
            f.write("model_0000005")
        trainer = FocoosTrainer(model, args(8, UD_K, ckpt_dir=ckpt_dir, resume=True), train_ds)
        res, counts = counted(trainer.train, total)
        log(f"[{tag}] resumed from model_0000005: start_iter {trainer.loop.start_iter}, ran to {res['iterations']},"
            f" the state's step {trainer.loop.state.step}; launches {counts}")
        assert trainer.loop.start_iter == 6 and res["iterations"] == 8 and trainer.loop.state.step == 8
        assert counts["msda_backward"] == n_dec * 2, counts

        # retry_if_oom on the card: one retry after emptying the cache, then the OOM; never the CPU
        total_mem = torch.cuda.get_device_properties(dev).total_memory
        tries, where = [], []

        @retry_if_oom
        def too_big_once():
            tries.append(1)
            return torch.empty(2 * total_mem if len(tries) == 1 else 1 << 20, dtype=torch.uint8, device=dev).device

        @retry_if_oom
        def too_big_always():
            where.append(torch.empty(2 * total_mem, dtype=torch.uint8, device=dev).device)

        got = too_big_once()
        raised = False
        try:
            too_big_always()
        except torch.OutOfMemoryError:
            raised = True
        log(f"[{tag}] retry_if_oom: a first request of {2 * total_mem / 2**30:.0f} GiB then 1 MiB returned on {got}"
            f" after {len(tries)} calls; always {2 * total_mem / 2**30:.0f} GiB raised torch.OutOfMemoryError {raised},"
            f" ran on {where or 'no device'}")
        assert got.type == "cuda" and len(tries) == 2 and raised and where == []

        # device_op_ms of one b8 eval forward (reported)
        x8 = torch.from_numpy(np.random.default_rng(63).integers(0, 256, (8, 640, 640, 3), np.uint8)).to(dev)
        model.module.eval()
        with torch.inference_mode():
            model.module(x8)
            ms = device_op_ms(lambda: model.module(x8), n_calls=3)
        log(f"[{tag}] {smi}: device_op_ms of a b8 eval forward at 640²: {ms:.2f} ms of device busy time a forward")
        del model, trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[{tag}] launches over the phase's counted runs: {total}; phase wall time"
        f" {time.perf_counter() - phase_t0:.1f}s")
    return total


# ---------------------------------------------------------------------------
# export: the serving artifacts (focoos_tpu_torch/infer)

EXPORT_TOL = {"fp32": 1e-6, "bf16": 1e-6, "pt2": 1e-5}  # x max|ref|, runtime against FocoosModel.forward
# the card's int8 forward against the CPU's int8 forward of the same directory,
# both in bf16, on the CPU's query selection: abs on sigmoid scores and
# normalized boxes. An activation a hair from an int8 rounding edge lands one
# step apart between cuDNN/cuBLAS and the CPU and carries on through the later
# layers; the card's bf16 forward against the CPU's bf16 forward is reported beside.
# Read on an H100 80GB HBM3 at 700 W over the phase's three seeded images: boxes
# 1.856e-2 to 3.047e-2, scores 7.310e-3 to 8.505e-3 (bf16 pair: boxes to 1.687e-2)
INT8_TOL = 5e-2
EXPORT_CALIB_IMAGES = 8
EXPORT_ROUNDS = 2  # the runtimes' timing turns (cut from 3: the script's time limit)
EXPORT_SIZE, EXPORT_BUCKET, EXPORT_BATCH = 640, 512, 16  # fai-detr-l's card size, its bucket, the b16 batch
EXPORT_FAMILIES = (("fai-cls-m-coco", 224), ("bisenetformer-l-ade", 640), ("fai-mf-l-coco-ins", 1024), ("rtmo-s-coco", 640))


def output_errs(got: list, ref, names: list) -> dict:
    """{name: (max_abs_err, max|ref|, bit-equal)} of a runtime's outputs against a ModelOutput."""
    out = {}
    for name, g in zip(names, got):
        r = getattr(ref, name)
        assert g.shape == r.shape and g.dtype == r.dtype, f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(r.shape)} {r.dtype}"
        out[name] = (float((g.float() - r.float()).abs().max()), float(r.float().abs().max()), bool(torch.equal(g, r)))
    return out


def same_detections(a, b, what: str) -> None:
    """Two FocoosDetections equal: boxes, classes, masks and keypoints, scores 1e-6."""
    assert len(a.detections) == len(b.detections), f"{what}: {len(a.detections)} vs {len(b.detections)} detections"
    for x, y in zip(a.detections, b.detections):
        assert (x.bbox, x.cls_id, x.mask, x.keypoints) == (y.bbox, y.cls_id, y.mask, y.keypoints), f"{what}: {x} vs {y}"
        assert abs(x.conf - y.conf) <= 1e-6, f"{what}: score {x.conf} vs {y.conf}"


def weight_casts(program) -> int:
    """Dtype conversions in an exported graph whose input is a parameter or buffer."""
    sig = program.graph_signature
    weights = set(sig.inputs_to_parameters) | set(sig.inputs_to_buffers)
    casts = ("_to_copy", "to.dtype", "_to_dtype")
    return sum(1 for n in program.graph.nodes if n.op == "call_function" and any(c in str(n.target) for c in casts)
               and n.args and getattr(n.args[0], "name", None) in weights)


def e2e_breakdown(run, img: np.ndarray, n: int = 10) -> dict:
    """p50 ms of ``run([img])`` end to end and of its preprocess, inference and postprocess."""
    run([img])
    parts = {"total": [], "preprocess": [], "inference": [], "postprocess": []}
    for _ in range(n):
        t = time.perf_counter()
        lat = run([img])[0].latency
        parts["total"].append(time.perf_counter() - t)
        for k in ("preprocess", "inference", "postprocess"):
            parts[k].append(getattr(lat, k))
    return {k: float(np.median(v)) * 1e3 for k, v in parts.items()}


@contextlib.contextmanager
def direct_launches():
    """The three forward wrappers call their ops' CUDA implementations
    directly, without the ``torch.library`` dispatch between: how they
    launched before the kernels became custom ops (the control for what the
    ops cost the eager path)."""
    from focoos_tpu_torch.ops import msda, nms, stem

    saved = msda.msda_forward_op, stem.fused_resnet_stem_op, nms.nms_keep_op
    msda.msda_forward_op, stem.fused_resnet_stem_op, nms.nms_keep_op = (
        msda._msda_forward_cuda, stem._fused_resnet_stem_cuda, nms._nms_keep_cuda)
    try:
        yield
    finally:
        msda.msda_forward_op, stem.fused_resnet_stem_op, nms.nms_keep_op = saved


def without_ops(fn):
    def run(x):
        with direct_launches():
            return fn(x)
    return run


def op_dispatch_costs(dev, model, model16, x1: np.ndarray) -> dict:
    """What the custom ops add to an eager forward, on the host: each op's
    host time a call against its CUDA implementation called directly, at the
    main path's b1 shapes (min of 3 rounds in turns, 300 calls each), and
    ``torch.compiler.is_exporting()`` (the check that the cast cache and the
    constant caches gained), its calls in one b1 forward of each dtype and its
    host time a call."""
    from focoos_tpu_torch.ops import msda, nms, stem

    g = torch.Generator().manual_seed(21)
    v, loc, aw, _ = msda_case(g, 1, 300, 8, 32, MSDA_SHAPES, dev)
    flat = [n for hw in MSDA_SHAPES for n in hw]
    params = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        params += [(torch.randn(3, 3, cin, cout, generator=g) * 0.1).to(dev), torch.ones(cout, device=dev),
                   torch.zeros(cout, device=dev)]
    xs = torch.rand(1, 640, 640, 3, generator=g).to(dev) * 255
    boxes, scores = (t.to(dev) for t in clustered_boxes(g, 1, 300))
    calls = {
        "msda_forward": (lambda: msda.msda_forward_op(v, flat, loc, aw),
                         lambda: msda._msda_forward_cuda(v, flat, loc, aw)),
        "fused_resnet_stem": (lambda: stem.fused_resnet_stem_op(xs, *params),
                              lambda: stem._fused_resnet_stem_cuda(xs, *params)),
        "nms_keep": (lambda: nms.nms_keep_op(boxes, scores, 0.65), lambda: nms._nms_keep_cuda(boxes, scores, 0.65)),
    }
    out = {}
    for name, (op, direct) in calls.items():
        assert torch.equal(op(), direct()), f"{name}: the op and its CUDA implementation disagree"
        ts = {"op": [], "direct": []}
        for _ in range(3):
            ts["op"].append(host_ms(op, calls=300))
            ts["direct"].append(host_ms(direct, calls=300))
        out[name] = {k: min(t) * 1e3 for k, t in ts.items()}  # µs a call
    real, n = torch.compiler.is_exporting, {"n": 0}

    def counting():
        n["n"] += 1
        return real()

    torch.compiler.is_exporting = counting
    try:
        for tag, m in (("fp32", model), ("bf16", model16)):
            n["n"] = 0
            m.forward(x1)
            out[f"is_exporting_calls_{tag}"] = n["n"]
    finally:
        torch.compiler.is_exporting = real
    t0 = time.perf_counter()
    for _ in range(100_000):
        real()
    out["is_exporting_us"] = (time.perf_counter() - t0) * 10  # µs a call
    # b1 forwards with and without the ops, one call each, in 40 pairs whose
    # order alternates: the paired differences cancel the host's drift
    for tag, m in (("fp32", model), ("bf16", model16)):
        runs, diffs, times = (m.forward, without_ops(m.forward)), [], []
        for i in range(40):
            t = {}
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[j](x1)
                torch.cuda.synchronize()
                t[j] = (time.perf_counter() - t0) * 1e3
            diffs.append(t[0] - t[1])
            times.append(t[0])
        out[f"paired_{tag}"] = (float(np.median(diffs)), *np.percentile(diffs, [25, 75]), float(np.median(times)))
    return out


def phase_export(dev, smi: str) -> dict:
    """Export, serve and quantize (``focoos_tpu_torch/infer``) on the card:
    fai-detr-l-coco at 640² served from exported directories in fp32 and
    bf16 (runtime against FocoosModel.forward and infer()), as a
    ``torch.export`` program with a 512² bucket and as an int8 store with
    calibrated scales (card against the CPU); rtmo-l's program with NMS
    inside; one bf16 request for every other family; then b1/b16 times of
    each runtime against FocoosModel's, in turns, and the end-to-end
    breakdown. Every kernel launch of a counted run goes into the returned
    counts."""
    import os
    import tempfile

    import cv2

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.infer.infer_model import InferModel
    from focoos_tpu_torch.infer.quantizer import Quantizer
    from focoos_tpu_torch.ports import ArtifactName, RuntimeType

    t_phase = time.perf_counter()
    total = {"msda_forward": 0, "msda_backward": 0, "fused_resnet_stem": 0, "nms_keep": 0}
    root = tempfile.mkdtemp(prefix="focoos_export_")
    rng = np.random.default_rng(13)
    size, bucket = EXPORT_SIZE, EXPORT_BUCKET
    batch2 = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    batch16 = rng.integers(0, 256, (EXPORT_BATCH, size, size, 3), dtype=np.uint8)
    request = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)

    # 1. fai-detr-l-coco 640², CUDA_FP32 and CUDA_BF16, against FocoosModel of the same dtype
    model = ModelManager.get("fai-detr-l-coco", device=dev, seed=0)
    perturb(model.module, seed=1)
    model16 = ModelManager.get("fai-detr-l-coco", device=dev, dtype="bfloat16")
    model16.module.load_state_dict(model.module.state_dict())
    n_dec = model.config.transformer_predictor_dec_layers
    names = model.processor.get_output_names()
    served = {}
    for tag, rt, m in (("fp32", RuntimeType.CUDA_FP32, model), ("bf16", RuntimeType.CUDA_BF16, model16)):
        t0 = time.perf_counter()
        im = served[tag] = m.export(rt, out_dir=os.path.join(root, tag))
        (raw, counts) = counted(lambda: im.runtime(batch2), total)
        ref = m.forward(batch2)
        errs = output_errs(raw, ref, names)
        for name, (err, mx, _) in errs.items():
            assert err <= EXPORT_TOL[tag] * mx, f"[export] {tag} {name}: {err} > {EXPORT_TOL[tag]} x {mx}"
        assert counts["msda_forward"] == n_dec and counts["fused_resnet_stem"] == 1, f"{tag} runtime launches {counts}"
        same_detections(im.infer(request, threshold=0.0), m.infer(request, threshold=0.0), f"{tag} infer")
        log(f"[export] fai-detr-l {rt}: exported + served in {time.perf_counter() - t0:.1f}s; B=2 against"
            f" FocoosModel.forward: " + ", ".join(f"{k} max_abs_err {e:.3e} (bit-equal {eq})" for k, (e, _, eq)
                                                  in errs.items())
            + f" (tol {EXPORT_TOL[tag]:.0e} x max); launches a forward msda_forward {counts['msda_forward']},"
            f" fused_resnet_stem {counts['fused_resnet_stem']}; infer() detections equal FocoosModel.infer()")

    # 2. the torch.export program at 640², b1, with a 512² bucket, and a bf16 program
    pt2_dir = os.path.join(root, "pt2")
    t0 = time.perf_counter()
    model.export(RuntimeType.TORCH_EXPORT, out_dir=pt2_dir, size_buckets=[bucket])
    export_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(pt2_dir, f)) for f in os.listdir(pt2_dir) if f.endswith(".pt2")) / 1e6
    t0 = time.perf_counter()
    served["pt2"] = pt2 = InferModel(pt2_dir, RuntimeType.TORCH_EXPORT)
    rt = pt2.runtime
    load_s = time.perf_counter() - t0
    assert rt.sizes == [(bucket, bucket), (size, size)], rt.sizes
    x1 = batch2[:1]
    raw, counts = counted(lambda: rt(x1), total)
    errs = output_errs(raw, model.forward(x1), names)
    for name, (err, mx, _) in errs.items():
        assert err <= EXPORT_TOL["pt2"] * mx, f"[export] pt2 {name}: {err} > {EXPORT_TOL['pt2']} x {mx}"
    assert counts["msda_forward"] == n_dec and counts["fused_resnet_stem"] == 1, f"program launches {counts}"
    x512 = rng.integers(0, 256, (1, bucket, bucket, 3), dtype=np.uint8)
    assert rt.pick(bucket, bucket) == ((bucket, bucket), False)
    out512, c512 = counted(lambda: rt(x512), total)
    e512 = output_errs(out512, model.forward(x512), names)
    assert all(e <= EXPORT_TOL["pt2"] * mx for e, mx, _ in e512.values()), f"{bucket}² bucket: {e512}"
    b3 = batch16[:3]
    out3, c3 = counted(lambda: rt(b3), total)
    first = rt(b3[:1])
    assert [o.shape[0] for o in out3] == [3, 3] and all(torch.equal(a[:1], b) for a, b in zip(out3, first))
    assert c3["msda_forward"] == 3 * n_dec and c3["fused_resnet_stem"] == 3, f"3 chunked calls launched {c3}"
    t0 = time.perf_counter()
    model16.export(RuntimeType.TORCH_EXPORT, out_dir=os.path.join(root, "pt2_bf16"))
    export16_s = time.perf_counter() - t0
    pt2_16 = InferModel(os.path.join(root, "pt2_bf16"), RuntimeType.TORCH_EXPORT)
    import torch.export as texport

    casts16 = weight_casts(texport.load(os.path.join(root, "pt2_bf16", ArtifactName.EXPORTED_PROGRAM.value)))
    casts32 = weight_casts(texport.load(os.path.join(pt2_dir, ArtifactName.EXPORTED_PROGRAM.value)))
    e16 = output_errs(pt2_16.runtime(x1), model16.forward(x1), names)
    log(f"[export] fai-detr-l TORCH_EXPORT: {size}² b1 + {bucket}² bucket exported in {export_s:.1f}s, {mb:.1f} MB of .pt2,"
        f" loaded in {load_s:.1f}s; against eager fp32 B=1: "
        + ", ".join(f"{k} {e:.3e} (bit-equal {eq})" for k, (e, _, eq) in errs.items())
        + f" (tol {EXPORT_TOL['pt2']:.0e} x max); launches a call msda_forward {counts['msda_forward']},"
        f" fused_resnet_stem {counts['fused_resnet_stem']}; a {bucket}² request took its bucket exactly"
        f" (err {max(e for e, _, _ in e512.values()):.3e}); B=3 padded and chunked to b1, first image equal;"
        f" bf16 program exported in {export16_s:.1f}s, {casts16} weight casts in its graph (fp32 program"
        f" {casts32}), against eager bf16: " + ", ".join(f"{k} {e:.3e} (bit-equal {eq})" for k, (e, _, eq) in e16.items()))

    # 3. rtmo-l-coco's program: NMS inside, one launch a call
    rmodel = ModelManager.get("rtmo-l-coco", device=dev, seed=0)
    perturb_rtmo(rmodel.module, seed=5, size=size)
    rdir = os.path.join(root, "rtmo_pt2")
    t0 = time.perf_counter()
    rserved = rmodel.export(RuntimeType.TORCH_EXPORT, out_dir=rdir)
    rexport_s = time.perf_counter() - t0
    rnames = rmodel.processor.get_output_names()
    rraw, rc = counted(lambda: rserved.runtime(x1), total)
    rref = rmodel.forward(x1)
    rerrs = output_errs(rraw, rref, rnames)
    for name, (err, mx, eq) in rerrs.items():
        assert eq or err <= EXPORT_TOL["pt2"] * max(mx, 1.0), f"[export] rtmo {name}: {err}"
    assert rc["nms_keep"] == 1, f"rtmo program launches {rc}"
    assert int((rraw[0] > 0).sum()) > 0, "rtmo program kept no detection"
    try:
        rserved.runtime(request[None])
        raise AssertionError("rtmo's program served a 480x640 request without a matching program")
    except ValueError as e:
        refused = str(e).split(";")[0]
    log(f"[export] rtmo-l TORCH_EXPORT at {size}² in {rexport_s:.1f}s: nms_keep {rc['nms_keep']} launch a call;"
        f" against eager: " + ", ".join(f"{k} {e:.3e} (bit-equal {eq})" for k, (e, _, eq) in rerrs.items())
        + f"; a 480x640 request raised: {refused}")
    del rserved, rmodel

    # 4. fai-detr-l CUDA_INT8: calibrated on 8 seeded JPEGs, card against the CPU
    int8_dir = os.path.join(root, "int8")
    calib = os.path.join(root, "calib")
    os.makedirs(calib)
    for i in range(EXPORT_CALIB_IMAGES):
        img, _ = draw_shapes(rng, 480, 640)
        cv2.imwrite(os.path.join(calib, f"img_{i:02d}.jpg"), img[:, :, ::-1])
    t0 = time.perf_counter()
    (_, qc) = counted(lambda: Quantizer(model).quantize(int8_dir, calibration_images_dir=calib), total)
    model.export(RuntimeType.CUDA_INT8, out_dir=int8_dir)
    quant_s = time.perf_counter() - t0
    served["int8"] = int8 = InferModel(int8_dir, RuntimeType.CUDA_INT8, device=dev)
    n_conv = sum(1 for m in int8.runtime.module.modules() if type(m).__name__ == "ConvNorm" and m.int8)
    n_lin = sum(1 for m in int8.runtime.module.modules() if type(m).__name__ == "Int8Linear" and m.int8)
    sizes = {f: os.path.getsize(os.path.join(int8_dir, f)) / 1e6 for f in (ArtifactName.WEIGHTS.value,
                                                                            ArtifactName.WEIGHTS_INT8.value)}
    raw8, c8 = counted(lambda: int8.runtime(x1), total)
    assert c8["msda_forward"] == n_dec and c8["fused_resnet_stem"] == 0, f"int8 launches {c8}"
    assert int8.runtime.num_static_scales == int8.runtime.num_int8_layers == n_conv + n_lin > 0
    t0 = time.perf_counter()
    cpu8 = InferModel(int8_dir, RuntimeType.CUDA_INT8, device="cpu")
    cpu16 = ModelManager.get(int8_dir, device="cpu", dtype="bfloat16")
    # three seeded images: the phase's uniform-noise image, another, and one of drawn shapes
    g8 = np.random.default_rng(14)
    shapes, _ = draw_shapes(g8, size, size)
    int8_images = {"noise": x1, "noise 2": g8.integers(0, 256, (1, size, size, 3), dtype=np.uint8),
                   "shapes": shapes[None].astype(np.uint8)}
    e8s, e16s = {}, {}
    for label, xi in int8_images.items():
        xc = torch.from_numpy(xi)
        with torch.inference_mode():
            idx8, _ = selection(cpu8.runtime.module, xc)
            with carried_selection(cpu8.runtime.module.predictor, idx8):
                ref8, _ = cpu8.runtime.module(xc)
            idx16, _ = selection(cpu16.module, xc)
            with carried_selection(cpu16.module.predictor, idx16):
                ref16, _ = cpu16.module(xc)
        e8s[label] = compare_to_cpu({"int8": int8.runtime.module}, (ref8.boxes.float(), ref8.logits.float(), idx8),
                                    xi)["int8"]
        e16s[label] = compare_to_cpu({"bf16": model16.module}, (ref16.boxes.float(), ref16.logits.float(), idx16),
                                     xi)["bf16"]
    cpu_s = time.perf_counter() - t0
    pairs = lambda errs: "; ".join(f"{k}: boxes {b:.3e}, scores {c:.3e}" for k, (b, c) in errs.items())  # noqa: E731
    log(f"[export] fai-detr-l CUDA_INT8: quantized, calibrated on {EXPORT_CALIB_IMAGES} JPEGs and exported in"
        f" {quant_s:.1f}s; weights {sizes[ArtifactName.WEIGHTS.value]:.1f} MB fp32 model_final.npz,"
        f" {sizes[ArtifactName.WEIGHTS_INT8.value]:.1f} MB model_int8.npz; {n_conv} int8 ConvNorms +"
        f" {n_lin} Int8Linears, all with calibrated scales; launches a forward msda_forward {c8['msda_forward']},"
        f" fused_resnet_stem {c8['fused_resnet_stem']}; card int8 against the CPU's int8 (B=1, the CPU's"
        f" selection, {len(int8_images)} images, {cpu_s:.1f}s on the CPU; tol {INT8_TOL:.0e}): {pairs(e8s)};"
        f" card bf16 against the CPU's bf16 beside it: {pairs(e16s)}")
    assert max(max(e) for e in e8s.values()) <= INT8_TOL, f"card int8 and CPU int8 disagree: {e8s}"
    del cpu8, cpu16

    # 5. every other family: export(CUDA_BF16) → InferModel.infer equals FocoosModel.infer in bf16
    for card, card_size in EXPORT_FAMILIES:
        t0 = time.perf_counter()
        m = ModelManager.get(card, device=dev, dtype="bfloat16", seed=0)
        if card.startswith("rtmo"):
            perturb_rtmo(m.module, seed=6)
        im = m.export(RuntimeType.CUDA_BF16, out_dir=os.path.join(root, card))
        got, want = im.infer(request, threshold=0.0), m.infer(request, threshold=0.0)
        same_detections(got, want, card)
        log(f"[export] {card} {card_size}² CUDA_BF16: infer() of a 480x640 request equals FocoosModel.infer():"
            f" {len(got.detections)} detections ({time.perf_counter() - t0:.1f}s)")
        del m, im

    # 6. times, in turns in one process: each runtime against FocoosModel's forward
    with direct_launches():
        direct_out = model.forward(x1)
    assert torch.equal(direct_out.boxes, model.forward(x1).boxes), "the direct launches changed the forward"
    runners = {
        "FocoosModel fp32": model.forward, "FocoosModel fp32 no ops": without_ops(model.forward),
        "InferModel fp32": served["fp32"].runtime,
        "FocoosModel bf16": model16.forward, "FocoosModel bf16 no ops": without_ops(model16.forward),
        "InferModel bf16": served["bf16"].runtime,
        "InferModel int8": served["int8"].runtime, "InferModel .pt2 fp32": served["pt2"].runtime,
    }
    rounds = {k: {"b1": [], "b16": []} for k in runners}
    for _ in range(EXPORT_ROUNDS):
        for k, run in runners.items():
            for b, x in (("b1", x1), ("b16", batch16)):
                run(x)
                torch.cuda.synchronize()
                ts = []
                for _ in range(5 if b == "b1" else 2):
                    t = time.perf_counter()
                    run(x)
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t)
                rounds[k][b].append(float(np.median(ts)))
    nb = EXPORT_BATCH
    log(f"[export] {smi}, TF32 off: per call incl. the H2D copy of the uint8 batch, median of {EXPORT_ROUNDS} rounds in turns"
        f" (.pt2 serves b{nb} as {nb} calls of its b1 program):")
    for k, r in rounds.items():
        log(f"[export]   {k:22s} b1 p50 {np.median(r['b1']) * 1e3:8.2f} ms (rounds {min(r['b1']) * 1e3:.2f}-"
            f"{max(r['b1']) * 1e3:.2f}); b{nb} {nb / np.median(r['b16']):7.1f} images/s")
    costs = op_dispatch_costs(dev, model, model16, x1)
    log(f"[export]   the ops' dispatch on the host, µs a call at b1 (op / its CUDA implementation called directly):"
        + "".join(f" {k} {costs[k]['op']:.1f} / {costs[k]['direct']:.1f};"
                  for k in ("msda_forward", "fused_resnet_stem", "nms_keep"))
        + f" a fai-detr-l forward calls msda 6x and the stem once, rtmo's NMS once; torch.compiler.is_exporting()"
        f" {costs['is_exporting_us']:.3f} µs a call, {costs['is_exporting_calls_fp32']} calls a b1 fp32 forward,"
        f" {costs['is_exporting_calls_bf16']} a bf16 one. \"no ops\": FocoosModel with the wrappers calling the CUDA"
        f" implementations directly, as before the ops")
    log("[export]   FocoosModel b1 forward with the ops minus without, 40 pairs in alternating order: "
        + "; ".join(f"{tag} median {d:+.3f} ms (quartiles {q1:+.3f} to {q3:+.3f}) of a {t:.2f} ms p50"
                    for tag, (d, q1, q3, t) in ((k, costs[f"paired_{k}"]) for k in ("fp32", "bf16"))))
    for k in ("fp32", "bf16", "int8", "pt2"):
        bd = e2e_breakdown(served[k], request)
        log(f"[export]   InferModel {k} end to end, one 480x640 request, p50 of 10: {bd['total']:.2f} ms ="
            f" preprocess {bd['preprocess']:.2f} + inference {bd['inference']:.2f} + postprocess"
            f" {bd['postprocess']:.2f} ms")
    log(f"[export] InferModel.benchmark() int8: {served['int8'].benchmark(iterations=10)};"
        f" end2end_benchmark() bf16: {served['bf16'].end2end_benchmark(iterations=5)}")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    log(f"[export] phase done in {time.perf_counter() - t_phase:.1f}s; launches of its counted runs {total}")
    return total


# ---------------------------------------------------------------------------
# distributed: data-parallel and FSDP training, rank-sharded evaluation
DIST_CARD = "fai-detr-l-coco"
DIST_SIZE = 640
DIST_BATCH = 8  # the global batch of every run of the phase
DIST_STEPS = 4  # (a), (b): FocoosModel.train steps a run
DIST_BACKEND = "nccl"  # (a), (b): a launched world of 1; (c), (d) run over gloo (NCCL takes one rank a device)
DIST_PARAM_SHARE = 0.02  # (a), (b): max |Δparam| within this share of the steps' max |θ4 − θ0| (user_data's gate)
# (a), (b): after the first step a gate also passes within this many times the gap of two one-process runs: the
# MSDA backward's atomics make those differ (7.75e-4 in one per-layer VFL loss at step 2 in about half the runs on
# an H100 80GB HBM3 at 700 W, fp32: a discrete flip), so past the first step the losses are gated on their total
DIST_GAP_FACTOR = 3.0
DIST_EVAL_IMAGES, DIST_EVAL_BATCH, DIST_EVAL_SPLIT = 16, 8, (9, 7)
DIST_AP_TOL = 1e-9
DIST_RANK_DEVICE = "cuda:0"  # (c), (d): both ranks on the one card


def dist_sgd_args(**kw):
    """SGD at lr 1e-2 with momentum (user_data's K gate: AdamW runs part after their first call)."""
    from focoos_tpu_torch.ports import TrainerArgs

    return TrainerArgs(optimizer="SGD", learning_rate=UD_SGD_LR, optimizer_extra={"momentum": 0.9}, **kw)


def dist_step(model, images: torch.Tensor, targets, assign: torch.Tensor, selection: torch.Tensor,
              sharding=None) -> dict:
    """One SGD step of ``model`` on this rank's ``images`` and ``targets``
    on a carried query selection ([b, Q]) and assignment ([L+1, b, N]),
    through the trainer's step module wrapped for ``sharding`` when given →
    the metrics (the ranks' mean). Carried: the global batch's statistics
    summed in another order move the encoder's scores by ~1e-6, and a
    near-tie at the top-300 cut-off then reorders the queries."""
    from focoos_tpu_torch.models.fai_detr.loss import detr_criterion
    from focoos_tpu_torch.parallel.sharding import apply_sharding
    from focoos_tpu_torch.trainer.solver import Solver
    from focoos_tpu_torch.trainer.train_step import build_train_step, create_train_state
    from focoos_tpu_torch.trainer.trainer import _StepModule

    module, dev = model.module, model.device

    def loss_fn(x, t):
        _, aux = module(x)
        losses = detr_criterion(aux, t, model.config, assign.to(dev))
        total = losses.pop("total")
        return total, losses

    run = loss_fn if sharding is None else apply_sharding(_StepModule(module, loss_fn), module, sharding, dev)
    state = create_train_state(module, Solver(module, dist_sgd_args(run_name="step", max_iters=1)))
    with carried_selection(module.predictor, selection):
        keys, packed = build_train_step(run)(state, images.to(dev), targets.to(dev))
    module.eval()
    return dict(zip(keys, packed.cpu().tolist()))


@contextlib.contextmanager
def planted(fault):
    """One of the two faults the 2-rank gate must catch: ``count``, each
    rank's own box count as the loss normalizer; ``bn``, each rank's own
    BatchNorm statistics."""
    from focoos_tpu_torch.parallel import mesh

    real_count, real_sum = mesh.global_count, mesh.all_reduce_sum
    if fault == "count":
        mesh.global_count = lambda x, floor: x.clamp(min=floor)
    elif fault == "bn":
        mesh.all_reduce_sum = lambda t: t
    try:
        yield
    finally:
        mesh.global_count, mesh.all_reduce_sum = real_count, real_sum


def dist_ranks(inputs_path: str) -> dict:
    """A rank of phases (c) and (d), both ranks on cuda:0 over gloo: the
    one-step 2-rank gate and its two planted faults on this rank's half of
    the batch, then the evaluation of this rank's share (9 and 7 images) →
    on rank 0, every rank's results."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from focoos_tpu_torch.models.focoos_model import FocoosModel
    from focoos_tpu_torch.ops import cuda_build
    from focoos_tpu_torch.parallel import mesh
    from focoos_tpu_torch.trainer import evaluation

    cuda_build.load_libraries(("msda", "msda_bwd", "stem"))  # built by the parent: the cache's
    blob = torch.load(inputs_path, weights_only=False)
    rank, dev = mesh.get_rank(), torch.device(DIST_RANK_DEVICE)
    # the parent's model, built from its config and holding its weights (no random init to redo)
    model = FocoosModel._on_device(blob["initial"], blob["config"], blob["model_info"], dev, torch.float32)
    rows = slice(rank * DIST_BATCH // 2, (rank + 1) * DIST_BATCH // 2)
    t = blob["targets"]
    images, targets = blob["images"][rows], type(t)(t.labels[rows], t.boxes[rows], t.valid[rows])
    assign, selection = blob["assign"][:, rows], blob["selection"][rows]
    out = {"rank": rank, "steps": {}, "counts": {}}
    for name, fault in (("2 ranks", None), ("rank-local num_boxes", "count"), ("rank-local BatchNorm statistics", "bn")):
        model.module.load_state_dict(blob["initial"])
        with planted(fault):
            out["steps"][name], counts = counted(lambda: dist_step(model, images, targets, assign, selection, "dp"),
                                                 {k: 0 for k in kernel_counts()})
        out["counts"][name] = counts
    model.module.load_state_dict(blob["initial"])
    split = [list(range(DIST_EVAL_SPLIT[0])), list(range(DIST_EVAL_SPLIT[0], sum(DIST_EVAL_SPLIT)))]
    real_shard = evaluation._shard_indices
    evaluation._shard_indices = lambda n, r, w: split[r]  # 9 and 7: rank 0 runs two forwards, rank 1 one
    try:
        (out["eval"], out["eval_s"]), out["counts"]["eval"] = counted(
            lambda: evaluate_timed(model, blob["eval_entries"], DIST_EVAL_BATCH), {k: 0 for k in kernel_counts()})
    finally:
        evaluation._shard_indices = real_shard
    return mesh.all_gather_objects(out)


def phase_distributed(dev, smi: str) -> dict:
    """Data-parallel and FSDP training and rank-sharded evaluation of
    fai-detr-l-coco at full width, 640², fp32 (``perturb``,
    ``condition_for_training``): (a) FocoosModel.train under ``dp`` in a
    launched NCCL world of 1 against the same steps with no process group;
    (b) the same under ``fsdp``, its model_final.npz keys and shapes against
    (a)'s; (c) one step on two ranks over gloo on this one card (4 images a
    rank) against one process at B=8 on the same images in the same order,
    on one carried assignment, and two planted faults (rank-local box count,
    rank-local BatchNorm statistics) that must fail that gate; (d) two ranks
    evaluating 16 images at batch 8 split 9 and 7, against one process's
    ``evaluate_dataset``. Every gate beside the gap between two one-process
    runs (the MSDA backward's atomics) → the kernels' launches."""
    import os
    import shutil
    import tempfile

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.models.fai_detr.loss import match
    from focoos_tpu_torch.parallel.launch import free_port, launch
    from focoos_tpu_torch.trainer.trainer import FocoosTrainer

    tag, phase_t0 = "distributed", time.perf_counter()
    total = {k: 0 for k in kernel_counts()}
    root = tempfile.mkdtemp(prefix="chip_smoke_distributed_")
    model = ModelManager.get(DIST_CARD, device=dev, seed=0)
    perturb(model.module, seed=71)
    condition_for_training(model.module)
    n_dec = model.config.transformer_predictor_dec_layers
    initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    ds = train_dataset(DIST_BATCH * DIST_STEPS, DIST_SIZE, seed=72)

    # (a), (b): FocoosModel's trainer, DIST_STEPS steps a run from the same weights and loader order
    def train_run(sharding=None) -> dict:
        model.module.load_state_dict(initial)
        args = dist_sgd_args(run_name=f"dist_{sharding}", output_dir=root, batch_size=DIST_BATCH,
                             max_iters=DIST_STEPS, sharding=sharding or "dp", workers=0, ema_enabled=True, seed=0,
                             checkpointer_period=10**6, log_period=DIST_STEPS, eval_period=0, samples=0)

        def train():
            trainer = FocoosTrainer(model, args, ds)
            res = trainer.train()
            keys = [k_ for k_ in trainer.loop.storage.histories() if "loss" in k_ or k_ == "grad_norm"]
            return res, history(trainer, keys)

        t0 = time.perf_counter()
        run = train if sharding is None else (
            lambda: launch(train, num_devices=1, dist_url=f"tcp://localhost:{free_port()}", backend=DIST_BACKEND))
        (res, metrics), counts = counted(run, total)
        assert res["iterations"] == DIST_STEPS, res
        assert counts["msda_forward"] == counts["msda_backward"] == n_dec * DIST_STEPS, (sharding, counts)
        with np.load(os.path.join(res["run_dir"], "model_final.npz")) as data:
            shapes = {k: data[k].shape for k in data.files}
        return dict(metrics=metrics, counts=counts, shapes=shapes, s=time.perf_counter() - t0,
                    params={n: p.detach().clone() for n, p in model.module.named_parameters()})

    runs = {"one process": train_run(), "one process again": train_run(), "dp": train_run("dp"),
            "fsdp": train_run("fsdp")}
    ref = runs["one process"]
    scale = max(float(p.abs().max()) for p in ref["params"].values())
    moved = max(float((ref["params"][n] - initial[n]).abs().max()) for n in ref["params"]) / scale

    def errs(run: dict) -> dict:
        key_err, where, total, norm, loss0, norm0 = 0.0, None, 0.0, 0.0, 0.0, 0.0
        for it, got in run["metrics"].items():
            for key, v in got.items():
                r = ref["metrics"][it][key]
                rel = abs(v - r) / max(abs(r), 1e-12)
                if key == "grad_norm":
                    norm = max(norm, rel)
                    norm0 = max(norm0, rel if it == 0 else 0.0)
                    continue
                loss0 = max(loss0, rel if it == 0 else 0.0)
                total = max(total, rel if key == "total_loss" else 0.0)
                if rel >= key_err:
                    key_err, where = rel, f"{key} at {it}"
        param = max(float((run["params"][n] - ref["params"][n]).abs().max()) for n in ref["params"]) / scale
        bit = run["metrics"] == ref["metrics"] and all(torch.equal(run["params"][n], ref["params"][n])
                                                      for n in ref["params"])
        return {"loss0": loss0, "norm0": norm0, "loss": total, "key": key_err, "where": where, "norm": norm,
                "param": param, "bit_equal": bit}

    gate = {name: errs(runs[name]) for name in ("one process again", "dp", "fsdp")}
    gap = gate["one process again"]
    param_tol = DIST_PARAM_SHARE * moved
    tols = {"loss": max(TRAIN_LOSS_RTOL, DIST_GAP_FACTOR * gap["loss"]),
            "norm": max(TRAIN_GRAD_NORM_RTOL, DIST_GAP_FACTOR * gap["norm"]),
            "param": max(param_tol, DIST_GAP_FACTOR * gap["param"])}
    log(f"[{tag}] {smi}: (a) dp and (b) fsdp, FocoosModel.train in a launched {DIST_BACKEND} world of 1, against"
        f" the same {DIST_STEPS} steps (B={DIST_BATCH}, {DIST_SIZE}², SGD lr {UD_SGD_LR:g}, EMA) with no process"
        f" group; the steps moved the parameters max |θ{DIST_STEPS} − θ0| / max |θ| = {moved:.3e}; "
        + "; ".join(f"{n}: first step losses {e['loss0']:.3e}, grad_norm {e['norm0']:.3e}; all steps total_loss"
                    f" {e['loss']:.3e}, every loss key {e['key']:.3e} ({e['where']}), grad_norm {e['norm']:.3e},"
                    f" Δparam {e['param']:.3e}, bit-equal {e['bit_equal']}, {runs[n]['s']:.1f}s" for n, e in gate.items())
        + f"; one process {ref['s']:.1f}s; gates: first step every loss ≤ {TRAIN_LOSS_RTOL:.0e}, grad_norm ≤"
        f" {TRAIN_GRAD_NORM_RTOL:.0e}; all steps the larger of those and {DIST_GAP_FACTOR:g}x the one-process gap:"
        f" total_loss ≤ {tols['loss']:.3e}, grad_norm ≤ {tols['norm']:.3e}, Δparam ≤ {tols['param']:.3e}"
        f" ({DIST_PARAM_SHARE} x {moved:.3e} = {param_tol:.3e}); the loss keys past the first step reported")
    for name in ("dp", "fsdp"):
        e = gate[name]
        assert e["loss0"] <= TRAIN_LOSS_RTOL and e["norm0"] <= TRAIN_GRAD_NORM_RTOL, (name, e)
        assert all(e[k] <= tols[k] for k in tols), (name, e, tols)
    assert runs["fsdp"]["shapes"] == runs["dp"]["shapes"] == ref["shapes"], "model_final.npz keys or shapes differ"
    log(f"[{tag}] (b) fsdp's model_final.npz: the same {len(ref['shapes'])} keys and shapes as dp's and one"
        f" process's (JAX layout)")

    # (c), (d): two ranks on this card over gloo, against one process on the same 8 images in the same order
    images, targets = model.processor.train(True).preprocess_entries(ds[:DIST_BATCH], max_instances=100)
    model.processor.train(False)
    images = torch.from_numpy(images)
    model.module.load_state_dict(initial)
    model.module.train()
    pred, chosen = model.module.predictor, []
    real_select = type(pred).select_queries
    pred.select_queries = lambda memory, ss: (lambda out: chosen.append(out[0]) or out)(real_select(pred, memory, ss))
    try:
        with torch.no_grad():  # the one process's own query selection and assignment, carried to every run
            _, aux = model.module(images.to(dev))
            assign = match(aux, targets.to(dev), model.config).cpu()
    finally:
        del pred.select_queries
    selection = chosen[0].cpu()
    model.module.eval()
    one = []
    for _ in range(2):  # the one-process step twice: the gap of the MSDA backward's atomics
        model.module.load_state_dict(initial)
        one.append(counted(lambda: dist_step(model, images, targets, assign, selection), total)[0])
    model.module.load_state_dict(initial)
    with torch.inference_mode():
        eval_images = [np.ascontiguousarray(x) for x in
                       np.random.default_rng(73).integers(0, 256, (DIST_EVAL_IMAGES, DIST_SIZE, DIST_SIZE, 3),
                                                          dtype=np.uint8)]
    eval_entries = entries_with_gt(eval_images, pseudo_gt(model, eval_images))
    (ref_eval, ref_eval_s), ref_eval_counts = counted(
        lambda: evaluate_timed(model, eval_entries, DIST_EVAL_BATCH), total)
    inputs = os.path.join(root, "dist_inputs.pt")
    torch.save({"initial": initial, "images": images, "targets": targets, "assign": assign,
                "selection": selection, "eval_entries": eval_entries, "config": model.config,
                "model_info": model.model_info}, inputs)
    t0 = time.perf_counter()
    ranks = launch(dist_ranks, num_devices=2, args=(inputs,), backend="gloo")
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        for k in total:
            total[k] += sum(c[k] for c in r["counts"].values())
    for r in ranks:
        for name, counts in r["counts"].items():
            if name != "eval":
                assert counts["msda_forward"] == counts["msda_backward"] == n_dec, (r["rank"], name, counts)
        forwards = math.ceil(DIST_EVAL_SPLIT[r["rank"]] / DIST_EVAL_BATCH)
        assert r["counts"]["eval"]["fused_resnet_stem"] == forwards, (r["rank"], r["counts"]["eval"])
        assert r["counts"]["eval"]["msda_forward"] == n_dec * forwards, (r["rank"], r["counts"]["eval"])

    def step_errs(got: dict) -> tuple:
        loss = max((abs(got[k] - one[0][k]) / max(abs(one[0][k]), 1e-12), k) for k in one[0] if k != "grad_norm")
        return loss[0], abs(got["grad_norm"] - one[0]["grad_norm"]) / one[0]["grad_norm"], loss[1]

    floor = step_errs(one[1])
    checks = {name: step_errs(ranks[0]["steps"][name]) for name in ranks[0]["steps"]}
    passes = {n: l <= TRAIN_LOSS_RTOL and g <= TRAIN_GRAD_NORM_RTOL for n, (l, g, _) in checks.items()}
    same_on_ranks = all(r["steps"] == ranks[0]["steps"] for r in ranks)
    log(f"[{tag}] {smi}: (c) one dp step on 2 ranks (gloo, both on cuda:0, {DIST_BATCH // 2} images a rank) against"
        f" one process at B={DIST_BATCH} on the same images in the same order, on its query selection and assignment"
        f" (total {one[0]['total_loss']:.6f}, grad_norm {one[0]['grad_norm']:.6f}); the one-process step again:"
        f" losses {floor[0]:.3e}, grad_norm {floor[1]:.3e}; "
        + "; ".join(f"{n}: losses {l:.3e} ({k}), grad_norm {g:.3e}, gate {'passed' if passes[n] else 'failed'}"
                    for n, (l, g, k) in checks.items())
        + f" (gate: losses ≤ {TRAIN_LOSS_RTOL:.0e}, grad_norm ≤ {TRAIN_GRAD_NORM_RTOL:.0e}); every rank logged the"
        f" same metrics: {same_on_ranks}; the 2-rank launch took {spawn_s:.1f}s (two processes reaching the card)")
    assert passes["2 ranks"] and same_on_ranks, checks
    assert not passes["rank-local num_boxes"] and not passes["rank-local BatchNorm statistics"], checks

    ap = {r["rank"]: r["eval"]["bbox"]["AP"] for r in ranks}
    ap_err = max(abs(v - ref_eval["bbox"]["AP"]) for v in ap.values())
    log(f"[{tag}] (d) {DIST_EVAL_IMAGES} images evaluated at batch {DIST_EVAL_BATCH} on 2 ranks split"
        f" {DIST_EVAL_SPLIT[0]} and {DIST_EVAL_SPLIT[1]} ({[r['eval_s'] for r in ranks]}s): bbox {ap_line(ranks[0]['eval']['bbox'])};"
        f" one process {ap_line(ref_eval['bbox'])} ({ref_eval_s:.2f}s, stem launches {ref_eval_counts['fused_resnet_stem']});"
        f" |ΔAP| {ap_err:.3e} (tol {DIST_AP_TOL:.0e}); the ranks returned the same dict:"
        f" {all(r['eval'] == ranks[0]['eval'] for r in ranks)}; stem launches a rank"
        f" {[r['counts']['eval']['fused_resnet_stem'] for r in ranks]} (one an eval forward)")
    assert ap_err <= DIST_AP_TOL, (ap, ref_eval["bbox"]["AP"])
    assert all(r["eval"] == ranks[0]["eval"] for r in ranks)
    shutil.rmtree(root, ignore_errors=True)
    log(f"[{tag}] phase done in {time.perf_counter() - phase_t0:.1f}s; launches of its counted runs, every rank {total}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} visible, using cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[device] TF32 off for cuDNN convolutions and matmuls: every comparison and time below is full fp32")

    from focoos_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    names = ("msda", "msda_bwd", "stem", "nms")
    cuda_build.load_libraries(names)
    for name in names:
        regs = [ln.strip() for ln in cuda_build.build_log[name].splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu: nvcc {cuda_build.build_seconds[name]:.2f}s; ptxas: {' / '.join(regs)}")
    log(f"[build] {len(names)} kernels ready in {time.perf_counter() - t0:.2f}s (one nvcc each, in parallel)")

    if sys.argv[1:] == ["--only-export"]:  # the serving layer alone: no kernels line and no result line
        phase_export(dev, smi)
        return 0
    msda = phase_msda(dev)
    msda_bwd = phase_msda_backward(dev)
    stem = phase_stem(dev)
    launches, slice_ctx = phase_slice(dev, smi)
    launches16 = phase_slice_bf16(dev, smi, slice_ctx)
    b16_images_per_s = 16 / slice_ctx["timings"]["b16"]
    del slice_ctx
    train_launches, train_launches16 = phase_train(dev, smi)
    nms = phase_nms(dev)
    rtmo_launches, rtmo_ctx = phase_rtmo(dev, smi)
    launches.update(rtmo_launches)
    launches16.update(phase_rtmo_bf16(dev, smi, rtmo_ctx))
    del rtmo_ctx
    lifecycle = phase_lifecycle(dev, smi, b16_images_per_s)
    finetune_m = phase_finetune_m(dev, smi)
    fai_mf = phase_mf(dev, smi)
    segm_train = phase_segm_train(dev, smi)
    fai_cls = phase_fai_cls(dev, smi)
    rtmo_train = phase_rtmo_train(dev, smi)
    user_data = phase_user_data(dev, smi)
    export = phase_export(dev, smi)
    distributed = phase_distributed(dev, smi)

    # library_ms: no single PyTorch call computes any of these functions (MSDA needs a
    # grid_sample per level and a weighted sum; the stem three convs, BN, ReLU and a
    # pool; torchvision's NMS is absent on the card's machine and takes one image)
    # the fp32 record's keys, then the bf16 path's: its launches (counted on the bf16 main
    # paths) and the kernel's bf16 time, plain time, bound and share at the same shapes
    def bf16(rec: dict, n: int) -> dict:
        return {"launches_bf16": n, "bf16_ms": rec["ms"], "bf16_plain_ms": rec["plain_ms"],
                "bf16_max_abs_err": rec["max_abs_err"], "bf16_bound_ms": rec["bound_ms"],
                "bf16_bound_by": rec["bound_by"], "bf16_share": rec["bound_ms"] / rec["ms"]}

    f32, b16 = torch.float32, torch.bfloat16
    kernels = [
        {"name": "msda_forward", "route": "cuda", "source": "focoos_tpu_torch/csrc/msda.cu",
         "replaces": "focoos_tpu/ops/pallas/msda.py:132", "launches": launches["msda_forward"], **msda[f32],
         **bf16(msda[b16], launches16["msda_forward"])},
        {"name": "msda_backward", "route": "cuda", "source": "focoos_tpu_torch/csrc/msda_bwd.cu",
         "replaces": "focoos_tpu/ops/pallas/msda.py:177", "launches": train_launches["msda_backward"],
         **msda_bwd[f32], **bf16(msda_bwd[b16], train_launches16["msda_backward"])},
        {"name": "fused_resnet_stem", "route": "cuda", "source": "focoos_tpu_torch/csrc/stem.cu",
         "replaces": "focoos_tpu/ops/pallas/stem.py:224", "launches": launches["fused_resnet_stem"], **stem[f32],
         **bf16(stem[b16], launches16["fused_resnet_stem"]), "path": None,
         **{f"b{b}_1024_{str(dt)[6:]}_{key}": v for (b, dt), rec in stem["1024"].items() for key, v in rec.items()}},
        # a bf16 rtmo forward hands NMS fp32 boxes and scores: the same fp32 kernel
        {"name": "nms_keep", "route": "cuda", "source": "focoos_tpu_torch/csrc/nms.cu",
         "replaces": "focoos_tpu/ops/pallas/nms_kernel.py:59", "launches": launches["nms_keep"], **nms, "path": None,
         **bf16(nms, launches16["nms_keep"])},
    ]
    for k in kernels:
        k["library_ms"] = None
        k["launches_lifecycle"] = lifecycle[k["name"]]
        k["launches_finetune_m"] = finetune_m.get(k["name"], 0)
        k["launches_fai_mf"] = fai_mf.get(k["name"], 0)
        k["launches_segm_train"] = segm_train.get(k["name"], 0)
        k["launches_fai_cls"] = fai_cls[k["name"]]
        k["launches_rtmo_train"] = rtmo_train[k["name"]]
        k["launches_user_data"] = user_data[k["name"]]
        k["launches_export"] = export[k["name"]]
        k["launches_distributed"] = distributed[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
