#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (focoos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with an H100

Phases, each printing its own lines; any failure raises and the exit code is
non-zero:

1. device — asserts CUDA, prints the card and its power limit, turns TF32 off
   for cuDNN convolutions and matmuls (every number below is full fp32);
2. build  — compiles both kernels from focoos_tpu_torch/csrc with nvcc;
3. msda   — the MSDA kernel against its plain PyTorch version at the main
   path's shapes (B=16, f32 and bf16 values, locations in [-0.2, 1.2]) and at
   one odd shape; errors and kernel/plain times (CUDA events, median of 20);
4. stem   — the fused stem kernel against its plain version at 640², B=1 and
   16, f32 and bf16; errors and both times;
5. slice  — ModelManager.get("fai-detr-l-coco") at full width (ResNet-50,
   300 queries, 6 decoder layers) with seeded random weights, the MSDA
   sampling kernels and the BatchNorms perturbed so that they do work;
   answers infer() on three 480x640 images and model(batch) on 16 at 640²,
   checks each kernel ran 6x / 1x per forward, compares a B=2 forward against
   the same weights on the CPU (plain versions), and times b1 and b16.

The last three lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi reports them, and the result JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MSDA_SHAPES = ((20, 20), (40, 40), (80, 80))  # fai-detr-l at 640²: p5, p4, p3
# × max|ref|: fp32 sums in another order; bf16 output rounded once (2^-8) by the kernel
MSDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
STEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
# card vs CPU on the whole model, fp32 both sides: ResNet-50 + 7 transformer
# layers of differently ordered sums; scores are sigmoids, boxes normalized
SLICE_TOL = 1e-3
# two queries whose selection scores differ by less than this (relative to
# the score spread) may swap between devices without either being wrong
NEAR_TIE = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(out: torch.Tensor, ref: torch.Tensor, tol: float, what: str) -> float:
    assert out.shape == ref.shape, f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)}"
    err = float((out.float() - ref.float()).abs().max())
    bound = tol * float(ref.float().abs().max())
    assert err <= bound, f"{what}: max_abs_err {err} > tolerance {bound}"
    return err


# ---------------------------------------------------------------------------
def phase_msda(dev) -> dict:
    from focoos_tpu_torch.ops.deformable import ms_deform_attn
    from focoos_tpu_torch.ops.msda import msda_forward

    g = torch.Generator().manual_seed(0)
    record = {}
    for b, lq, hh, d, ss, label in (
        (16, 300, 8, 32, MSDA_SHAPES, "main path B=16 Lq=300 Hh=8 D=32 levels 20²,40²,80² P=4"),
        (2, 37, 3, 8, ((9, 11), (5, 6), (3, 2)), "odd B=2 Lq=37 Hh=3 D=8 levels 9x11,5x6,3x2 P=4"),
    ):
        s = sum(h * w for h, w in ss)
        v32 = (torch.rand(b, s, hh, d, generator=g) - 0.5).to(dev)
        loc = (torch.rand(b, lq, hh, len(ss), 4, 2, generator=g) * 1.4 - 0.2).to(dev)
        aw = torch.softmax(torch.randn(b, lq, hh, len(ss) * 4, generator=g), -1).reshape(b, lq, hh, len(ss), 4).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            v = v32.to(dtype)
            out = msda_forward(v, ss, loc, aw)
            torch.cuda.synchronize()
            err = max_err(out, ms_deform_attn(v.float(), ss, loc, aw), MSDA_TOL[dtype], f"msda {label} {dtype}")
            ms = time_ms(lambda: msda_forward(v, ss, loc, aw))
            plain_ms = time_ms(lambda: ms_deform_attn(v, ss, loc, aw))
            log(f"[msda] {label} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {MSDA_TOL[dtype]:.1e} x max|ref|)"
                f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if b == 16 and dtype == torch.float32:
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_stem(dev) -> dict:
    from focoos_tpu_torch.ops.stem import fused_resnet_stem, resnet_stem_reference

    g = torch.Generator().manual_seed(1)
    params = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        params += [
            (torch.randn(3, 3, cin, cout, generator=g) * (2.0 / (9 * cin)) ** 0.5).to(dev),
            (1 + 0.1 * torch.randn(cout, generator=g)).to(dev),
            (0.1 * torch.randn(cout, generator=g)).to(dev),
        ]
    record = {}
    for b in (1, 16):
        x32 = torch.randn(b, 640, 640, 3, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            out = fused_resnet_stem(x, *params)
            torch.cuda.synchronize()
            err = max_err(out, resnet_stem_reference(x.float(), *params), STEM_TOL[dtype], f"stem B={b} {dtype}")
            ms = time_ms(lambda: fused_resnet_stem(x, *params))
            plain_ms = time_ms(lambda: resnet_stem_reference(x, *params))
            log(f"[stem] 640x640 B={b} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol {STEM_TOL[dtype]:.1e} x max|ref|)"
                f" | kernel {ms:.4f} ms, plain (cuDNN convs) {plain_ms:.4f} ms")
            if b == 16 and dtype == torch.float32:
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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


def compare_devices(gpu_model, cpu_model, x_uint8: np.ndarray) -> int:
    """Forward the same batch on both modules; compare the selected query
    indices first, then boxes and scores row by row. Rows are matched by
    query index, so two near-tied queries that swap rank compare as
    themselves. An image whose selected set differs (a near-tie at the
    cut-off) is reported and left out. Returns the images compared."""
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
    return compared


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
    fused_resnet_stem.launches = 0
    single = [model.infer(img, threshold=0.0) for img in images]
    multi = model(batch, threshold=0.0)
    torch.cuda.synchronize()
    launches = {"msda_forward": msda_forward.launches, "fused_resnet_stem": fused_resnet_stem.launches}
    forwards = len(images) + 1
    log(f"[slice] served {len(images)} infer() requests and one batch of {len(batch)}: {forwards} forwards,"
        f" launches msda_forward {launches['msda_forward']}, fused_resnet_stem {launches['fused_resnet_stem']}")
    assert launches["msda_forward"] == n_dec * forwards, "MSDA kernel did not run once per decoder layer"
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
    compared = compare_devices(model.module, cpu_model.module, batch[:2])
    assert compared >= 1, "no image could be compared between card and CPU"
    log(f"[slice] card vs CPU: {compared}/2 images compared ({time.perf_counter() - t0:.1f}s)")

    # latency and throughput of the forward (host clock around synchronized calls)
    x1 = torch.from_numpy(batch[:1]).to(dev)
    x16 = torch.from_numpy(batch).to(dev)
    timings = {}
    for name, x, reps in (("b1", x1, 30), ("b16", x16, 10)):
        with torch.inference_mode():
            for _ in range(3):
                model.module(x)
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                model.module(x)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
        timings[name] = float(np.median(ts))
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
    return launches


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
    for name in ("msda", "stem"):
        cuda_build.load_library(name)
        regs = [ln.strip() for ln in cuda_build.build_log[name].splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu: nvcc {cuda_build.build_seconds[name]:.2f}s; ptxas: {' / '.join(regs)}")
    log(f"[build] both kernels ready in {time.perf_counter() - t0:.2f}s")

    msda = phase_msda(dev)
    stem = phase_stem(dev)
    launches = phase_slice(dev, smi)

    kernels = [
        {"name": "msda_forward", "route": "cuda", "source": "focoos_tpu_torch/csrc/msda.cu",
         "replaces": "focoos_tpu/ops/pallas/msda.py:132", "launches": launches["msda_forward"], **msda},
        {"name": "fused_resnet_stem", "route": "cuda", "source": "focoos_tpu_torch/csrc/stem.cu",
         "replaces": "focoos_tpu/ops/pallas/stem.py:224", "launches": launches["fused_resnet_stem"], **stem},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
