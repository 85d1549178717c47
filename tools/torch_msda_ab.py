#!/usr/bin/env python3
"""Time the port's MSDA forward and backward kernels against other versions
of their sources, turn by turn, in one process on one NVIDIA GPU.

    python3 tools/torch_msda_ab.py [--earlier OLD_CSRC_DIR] [--variants]

``--earlier OLD_CSRC_DIR``: an earlier ``msda.cu``, ``msda_bwd.cu`` and
``common.cuh`` whose backward takes an fp32 gradient and accumulates d value
in an fp32 buffer, which its wrapper then converts to value's dtype in a
separate pass (``focoos_tpu_torch/csrc`` of a parent commit before the
in-kernel conversion, unpacked with ``git archive`` into a gitignored
directory); that wrapper is reproduced here. With bf16 values the backward
is also timed as ``tools/msda_bwd_bf16_atomics.cu`` builds it (d value
accumulated in bf16 by vector reductions: its error against the current
kernel is printed, not held to the tolerance, which it misses on rows that
many samples share). ``--variants``: copies of the current sources
with one design choice of the vector kernels undone each (``VARIANTS``
below: the level table read from the kernel parameter, the forward's FMAs
in the reverse of load order, loads skipped for zero-weight corners, warps
in (b, h, q) order) or one cost removed
(the backward's atomics, its value loads), to attribute the kernels' time;
a removed cost gives wrong gradients, so those are timed only. Every
version is built with the port's nvcc flags.

Cases, at fai-detr-l's decoder shape (Lq=300, Hh=8, D=32, levels 20², 40²,
80², P=4), each with fp32 and with bf16 values: B=16 and B=8 with uniform
locations in [-0.2, 1.2], and B=16 with the loc/aw that the last decoder
layer of fai-detr-l samples in a b16 forward (seeded random weights
perturbed as chip_smoke.py does). Each
version is timed in turn, then again in the reverse order (device time,
``chip_smoke.time_ms``; the backward includes the zero fill of d value),
beside the bound (``chip_smoke.msda_bound``: value rows touched, counted on
the card); the current and earlier kernels also one call at a time, host
included, the way kernel times were taken before ``time_ms``. The zero
fill alone is timed too.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from focoos_tpu_torch.ops import cuda_build, msda  # noqa: E402

# name -> {file: [(text in the current source, replacement)]}
VARIANTS = {
    "level table from the kernel parameter": {
        f: [("const LevelTable& lv = focoos::shared_level_table(lv_param);", "const LevelTable& lv = lv_param;")]
        for f in ("msda.cu", "msda_bwd.cu")
    },
    "forward FMAs last load first": {"msda.cu": [("for (int k = 0; k < R; ++k) {\n      float f[kVec];",
                                                  "for (int k = R - 1; k >= 0; --k) {\n      float f[kVec];")]},
    # timing only: a valid corner whose bilinear weight is exactly 0 (a pixel coordinate on an
    # integer) still needs its value for d loc
    "loads skipped for zero-weight corners (timing only)": {
        "msda.cu": [("__ldg(reinterpret_cast<const uint4*>(vb + off))",
                     "(w[k] != 0.f ? __ldg(reinterpret_cast<const uint4*>(vb + off)) : make_uint4(0, 0, 0, 0))")],
        "msda_bwd.cu": [("focoos::ldg4(vb + off[k])", "(w[k] != 0.f ? focoos::ldg4(vb + off[k]) : decltype(focoos::ldg4(vb)){})")],
    },
    "warps in (b, h, q) order (forward)": {
        f: [("  const int h = warp % Hh;\n  const int b = warp / (Hh * Lq);",
             "  const int q_ = warp % Lq, h = (warp / Lq) % Hh, b = warp / (Lq * Hh);\n"
             "  const int bqh = (b * Lq + q_) * Hh + h;"),
            ("loc + (size_t)warp * n * 2;", "loc + (size_t)bqh * n * 2;"),
            ("aw + (size_t)warp * n;", "aw + (size_t)bqh * n;")]
        + ([("out + (size_t)warp * D + lane * kVec", "out + (size_t)bqh * D + lane * kVec")] if f == "msda.cu" else
           [("grad + (size_t)warp * D + r * 4", "grad + (size_t)bqh * D + r * 4"),
            ("lane, base, n, warp, lv, d_loc, d_aw);\n  }\n}\n\n__device__", "lane, base, n, bqh, lv, d_loc, d_aw);\n  }\n}\n\n__device__")])
        for f in ("msda.cu",)
    },
    "backward without its atomics (timing only)": {
        "msda_bwd.cu": [("if (dvb != nullptr && w[k] != 0.f)", "if (false)")]},
    "backward without its value loads (timing only)": {
        "msda_bwd.cu": [("focoos::ldg4(vb + off[k])", "decltype(focoos::ldg4(vb)){}")]},
}


def _build(src_dir: str, out_dir: str, bwd_ptrs: int = 8, sources=None) -> dict:
    """Compile msda.cu and msda_bwd.cu (or ``sources``: {library name: path})
    from ``src_dir``; their C functions with argtypes set. ``bwd_ptrs``: the
    backward's pointer arguments (7 before the fp32 scratch argument)."""
    os.makedirs(out_dir, exist_ok=True)
    sources = sources or {n: os.path.join(src_dir, f"{n}.cu") for n in ("msda", "msda_bwd")}
    fns = {}
    for name, fn_name, n_ptrs in (("msda", "msda_forward", 4), ("msda_bwd", "msda_backward", bwd_ptrs)):
        if name not in sources:
            continue
        so = os.path.join(out_dir, f"lib{name}.so")
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", so,
                        sources[name]], check=True, capture_output=True, text=True)
        fn = getattr(ctypes.CDLL(so), fn_name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def build_variants(work_dir: str) -> dict:
    """Each entry of VARIANTS as a patched copy of the current sources, built."""
    out = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = os.path.join(work_dir, f"variant{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, d)
        for fname, edits in patches.items():
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            for old, new in edits:
                if old not in text:
                    raise ValueError(f"variant {name!r}: {fname} no longer holds {old!r}")
                text = text.replace(old, new, 1)  # the first kernel of each file: its vector path
            with open(path, "w") as f:
                f.write(text)
        out[name] = _build(d, d)
    return out


def earlier_forward(fn, v, ss, loc, aw):
    b, s, hh, d = v.shape
    out = torch.empty((b, loc.shape[1], hh * d), dtype=v.dtype, device=v.device)
    err = fn(v.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(), msda._level_hw(ss), len(ss), b, s,
             loc.shape[1], hh, d, loc.shape[4], msda._dtype_code(v), int(msda.vector_path("forward", v)),
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "earlier msda_forward")
    return out


def earlier_backward(fn, v, ss, loc, aw, grad, bf16_atomics: bool = False):
    """The earlier wrapper: an fp32 gradient, an fp32 d value zero-filled and
    accumulated by the kernel, then converted to value's dtype. With
    ``bf16_atomics`` (tools/msda_bwd_bf16_atomics.cu): the gradient and a
    zero-filled d value in value's dtype, accumulated by the kernel."""
    b, s, hh, d = v.shape
    g = grad.to(v.dtype).contiguous() if bf16_atomics else grad.float().contiguous()
    d_value = torch.zeros((b, s, hh, d), dtype=v.dtype if bf16_atomics else torch.float32, device=v.device)
    d_loc, d_aw = torch.empty_like(loc), torch.empty_like(aw)
    err = fn(v.data_ptr(), loc.data_ptr(), aw.data_ptr(), g.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
             d_aw.data_ptr(), msda._level_hw(ss), len(ss), b, s, loc.shape[1], hh, d, loc.shape[4],
             msda._dtype_code(v), int(msda.vector_path("backward", v, g)), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "earlier msda_backward")
    return d_value.to(v.dtype), d_loc, d_aw


def call_ms(fn, reps: int = 20) -> float:
    """One call at a time between two CUDA events, the wrapper's host time
    included: median of ``reps``."""
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


BF16_ATOMICS = "bf16 accumulation (tools/msda_bwd_bf16_atomics.cu; error reported, not held)"


def compare(kernel: str, label: str, earlier, variants: dict, v, ss, loc, aw, grad) -> None:
    """Every version on one case: outputs against the current kernel's, then
    device times in turn and in the reverse order."""
    fn_name = "msda_" + kernel
    current = msda._kernel(fn_name)

    def run(version):
        if version == "earlier":
            return (earlier_forward(earlier[fn_name], v, ss, loc, aw) if kernel == "forward"
                    else earlier_backward(earlier[fn_name], v, ss, loc, aw, grad))
        if version == BF16_ATOMICS:
            return earlier_backward(variants[version][fn_name], v, ss, loc, aw, grad, bf16_atomics=True)
        msda._fns[fn_name] = current if version == "current" else variants[version][fn_name]
        try:
            return msda.msda_forward(v, ss, loc, aw) if kernel == "forward" else msda.msda_backward(v, ss, loc, aw, grad)
        finally:
            msda._fns[fn_name] = current

    versions = ["current"] + (["earlier"] if earlier else []) + [
        k for k in variants if k != BF16_ATOMICS or (kernel == "backward" and v.dtype == torch.bfloat16)]
    ref = run("current")
    ref = (ref,) if kernel == "forward" else ref
    tols = (chip_smoke.MSDA_TOL[v.dtype],) if kernel == "forward" else chip_smoke.MSDA_BWD_TOL[v.dtype]
    for version in versions[1:]:
        if "timing only" in version:
            continue
        got = run(version)
        if version == BF16_ATOMICS:
            err = float((got[0].float() - ref[0].float()).abs().max()) / (2.0**-8 * float(ref[0].float().abs().max()))
            print(f"[ab] {kernel} {label}: {version}: d value {err:.2f} x 2^-8 max|ref| from the current kernel's",
                  flush=True)
            continue
        for a, b, t in zip((got,) if kernel == "forward" else got, ref, tols):
            chip_smoke.max_err(a, b, t, f"{kernel} {label}: {version} vs current")
    times = {k: [] for k in versions}
    for version in versions + versions[::-1]:
        times[version].append(chip_smoke.time_ms(lambda: run(version)))
    bd = chip_smoke.msda_bound(kernel, v, ss, loc, aw)
    print(f"[ab] {kernel} {label}: bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {bd['rows_touched']} of"
          f" {bd['rows']} value rows touched)", flush=True)
    for version, ts in times.items():
        one = f"; one call at a time {call_ms(lambda: run(version)):.4f} ms" if version in ("current", "earlier") else ""
        print(f"[ab]     {version}: {ts[0]:.4f} / {ts[1]:.4f} ms, at {bd['bound_ms'] / np.mean(ts):.1%} of the"
              f" bound{one}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--earlier", help="a csrc directory whose MSDA C functions have no path argument")
    parser.add_argument("--variants", action="store_true", help="time the VARIANTS of the current sources too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_msda_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[ab] {smi}", flush=True)
    dev = torch.device("cuda:0")
    cuda_build.load_libraries(("msda", "msda_bwd"))
    work = os.path.join(cuda_build.BUILD_DIR, "ab")
    earlier = _build(args.earlier, os.path.join(work, "earlier"), bwd_ptrs=7) if args.earlier else None
    variants = build_variants(work) if args.variants else {}
    variants[BF16_ATOMICS] = _build(REPO, os.path.join(work, "bf16_atomics"), bwd_ptrs=7, sources={
        "msda_bwd": os.path.join(REPO, "tools", "msda_bwd_bf16_atomics.cu")})

    ss = chip_smoke.MSDA_SHAPES
    g = torch.Generator().manual_seed(0)
    cases = [("B=16 uniform", chip_smoke.msda_case(g, 16, 300, 8, 32, ss, dev)),
             ("B=8 uniform", chip_smoke.msda_case(g, 8, 300, 8, 32, ss, dev))]
    from focoos_tpu_torch import ModelManager

    model = ModelManager.get("fai-detr-l-coco", device=dev, seed=0)
    chip_smoke.perturb(model.module, seed=1)
    x16 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (16, 640, 640, 3), dtype=np.uint8)).to(dev)
    n_dec = model.config.transformer_predictor_dec_layers
    vc, ssc, locc, awc = chip_smoke.capture_msda_inputs(model.module, x16, n_dec - 1)
    del model
    gc = torch.randn(vc.shape[0], locc.shape[1], vc.shape[2] * vc.shape[3], generator=g).to(dev)
    cases.append((f"B=16 captured (decoder layer {n_dec - 1})", (vc, locc, awc, gc)))

    zero_fill = chip_smoke.time_ms(lambda: torch.zeros(cases[0][1][0].shape, device=dev))
    print(f"[ab] zero fill of d value at B=16 ({cases[0][1][0].numel() * 4 / 1e6:.1f} MB): {zero_fill:.4f} ms", flush=True)
    for label, (v, loc, aw, grad) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for kernel in ("forward", "backward"):
                compare(kernel, f"{label} {str(dtype)[6:]}", earlier, variants, v.to(dtype), ss, loc, aw, grad.to(dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main())
