#!/usr/bin/env python3
"""Time the port's greedy NMS kernel against other versions of its source,
turn by turn, in one process on one NVIDIA GPU.

    python3 tools/torch_nms_ab.py [--earlier OLD_CSRC_DIR] [--variants] [--rtmo]

Versions, each built with the port's nvcc flags:
- ``current``: ``focoos_tpu_torch/csrc/nms.cu`` (one thread-block cluster per
  image, the bitmask gathered in rank 0, 32 boxes a sweep step);
- ``earlier``: the ``nms.cu`` (and ``common.cuh``) of ``--earlier OLD_CSRC_DIR``,
  whose C function takes the same arguments (for example
  ``focoos_tpu_torch/csrc`` of a parent commit, unpacked with ``git archive``
  into a gitignored directory);
- ``two launches``: ``tools/nms_two_pass.cu`` (a build kernel of B x ceil(K/32)
  blocks into a global scratch, then a sweep kernel, one block per image);
- with ``--variants``, the ``VARIANTS`` below: copies of the current source
  with one design choice changed, or one phase removed to attribute the time
  (those give wrong keep masks and are timed only).

Cases: clustered boxes as ``chip_smoke.py`` makes them at K=300, thr 0.65,
B=16 (rtmo-l's batched forward) and B=1 (one ``infer()`` request); with
``--rtmo``, also the top-300 candidates that rtmo-l's decode hands to NMS
in a b16 forward and for its first image alone (seeded random weights
perturbed as ``chip_smoke.perturb_rtmo`` does). For each case: every
version's keep mask against the plain version's, then device times
(``chip_smoke.time_ms``) in the order earlier, current, ..., then reversed,
beside the launch floor (``time_ms`` of ``torch.cuda._sleep(0)``) and the
bound (``chip_smoke.bound``). Last, the wrapper's host time per call (host
clock over 1000 calls, no sync in between) with the current, the earlier
and the one-block-per-image kernel behind it, in turn and reversed. With
``--rtmo`` and ``--earlier``, rtmo-l's b1 and b16 forward p50 (host clock
around synchronized forwards, as ``chip_smoke.py`` times them) with the
earlier kernel, the current one and the earlier one again behind the
wrapper (the last an A/A control), in rounds that rotate which runs first:
the same process, weights and inputs, so only the kernel differs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from focoos_tpu_torch.ops import cuda_build, nms  # noqa: E402

# name -> [(text in csrc/nms.cu, replacement)]
VARIANTS = {
    "cluster of 4 blocks": [("constexpr int kCluster = 8;", "constexpr int kCluster = 4;")],
    "cluster of 2 blocks": [("constexpr int kCluster = 8;", "constexpr int kCluster = 2;")],
    "one block per image": [("constexpr int kCluster = 8;", "constexpr int kCluster = 1;")],
    "256 threads a block": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
    "tiles of 32 rows": [("constexpr int kTileRows = 8;", "constexpr int kTileRows = 32;")],
    "a division for every pair": [("  if (inter == 0.f) return 0.f > thr && uni == uni;", "")],
    "NaN max/min by compare and select": [
        ('  float d;\n  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));\n  return d;',
         "  return (a != a || b != b) ? a + b : fmaxf(a, b);"),
        ('  float d;\n  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));\n  return d;',
         "  return (a != a || b != b) ? a + b : fminf(a, b);"),
    ],
    "cluster of 16 blocks (non-portable)": [
        ("constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
        ("  nms_keep_kernel<<<", "  cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                                 "  nms_keep_kernel<<<")],
    # row block w's words stay in rank w % kCluster (at the same offsets); the sweep
    # reads them through distributed shared memory, and every block waits for it
    "bitmask spread over the cluster, read remotely": [
        ("build_tile(box_s, area_s, K, S, r0, l, thr, mask0);",
         "build_tile(box_s, area_s, K, S, r0, l, thr, cluster.map_shared_rank(mask_s, (r0 / 32) % kCluster));"),
        ("    const uint4* dp = reinterpret_cast<const uint4*>(mask + (size_t)w * S + 32 * w);  // a broadcast\n"
         "    const uint4* mp = reinterpret_cast<const uint4*>(column + 32 * w);",
         "    const uint32_t* src = cg::this_cluster().map_shared_rank(const_cast<uint32_t*>(mask), w % kCluster);\n"
         "    const uint4* dp = reinterpret_cast<const uint4*>(src + (size_t)w * S + 32 * w);\n"
         "    const uint4* mp = reinterpret_cast<const uint4*>(src + (size_t)min(lane, W - 1) * S + 32 * w);"),
        ("  if (rank != 0) return;\n\n  if (threadIdx.x < 32) sweep(mask_s, word_s, W, S);",
         "  if (rank == 0 && threadIdx.x < 32) sweep(mask_s, word_s, W, S);\n  cluster.sync();\n"
         "  if (rank != 0) return;"),
    ],
    "no sweep (timing only)": [("  if (threadIdx.x < 32) sweep(mask_s, word_s, W, S);", "")],
    "no IoUs in the build (timing only)": [("c > r && overlaps(box_s[r], area_s[r], cb, ca, thr)", "c > r && c < 0")],
    "load, barriers and keep only (timing only)": [
        ("  if (threadIdx.x < 32) sweep(mask_s, word_s, W, S);", ""),
        ("const int n_tiles = (32 / kTileRows) * W * (W + 1) / 2;", "const int n_tiles = 0;"),
    ],
}
SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def _nvcc(src: str, so: str, include: str) -> str:
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", include, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    return "; ".join(ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln or "spill" in ln)


def _function(so: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(so), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def build_all(work: str, earlier: str | None, variants: bool) -> dict:
    """Every version's C function, one nvcc each, all started together."""
    jobs = {}  # version -> (source, .so, include dir, C function, argtypes)
    jobs["two launches"] = (os.path.join(REPO, "tools", "nms_two_pass.cu"), os.path.join(work, "libtwo_pass.so"),
                            str(cuda_build.CSRC_DIR), "nms_keep_two_pass",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    if earlier:
        jobs["earlier"] = (os.path.join(earlier, "nms.cu"), os.path.join(work, "libearlier.so"), earlier, "nms_keep", SIG)
    for i, (name, edits) in enumerate(VARIANTS.items() if variants else ()):
        d = os.path.join(work, f"variant{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, d)
        path = os.path.join(d, "nms.cu")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise ValueError(f"variant {name!r}: nms.cu no longer holds {old!r}")
            text = text.replace(old, new, 1)
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = (path, os.path.join(d, "libnms.so"), d, "nms_keep", SIG)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: _nvcc(*j[:3]), jobs.values())))
    fns = {}
    for version, (_, so, _, fn_name, argtypes) in jobs.items():
        print(f"[ab] built {version}: ptxas {logs[version]}", flush=True)
        fns[version] = _function(so, fn_name, argtypes)
    return fns


def runner(version: str, fns: dict, boxes, scores, thr):
    """A call of one version, through the port's wrapper where the C function has its arguments."""
    if version == "two launches":
        b, k = scores.shape
        w = (k + 31) // 32
        mask = torch.empty((b, w, 32 * w + 4), dtype=torch.int32, device=boxes.device)

        def call():
            keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
            err = fns[version](boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), mask.data_ptr(), b, k,
                               float(thr), torch.cuda.current_stream().cuda_stream)
            cuda_build.check(err, "nms_keep_two_pass")
            return keep
        return call

    def call():
        nms._fn = fns[version]
        return nms.nms_keep(boxes, scores, thr)
    return call


def compare(label: str, fns: dict, boxes, scores, thr: float, floor_ms: float) -> list:
    """Time every version on one case; the versions whose keep mask differs from the plain version's."""
    versions = (["earlier"] if "earlier" in fns else []) + ["current"] + [v for v in fns if v not in ("earlier", "current")]
    calls = {v: runner(v, fns, boxes, scores, thr) for v in versions}
    ref = nms.nms_keep_reference(boxes, scores, thr)
    wrong = []
    for v in versions:
        if "timing only" not in v:
            keep = calls[v]()
            torch.cuda.synchronize()
            if not torch.equal(keep, ref):
                wrong.append(v)
                print(f"[ab] {label}: {v} DIFFERS from the plain version in {int((keep != ref).sum())} entries", flush=True)
    times = {v: [] for v in versions}
    for v in versions + versions[::-1]:
        times[v].append(chip_smoke.time_ms(calls[v]))
    nms._fn = fns["current"]
    b, k = scores.shape
    bd = chip_smoke.bound(boxes.numel() * 4 + scores.numel() * 4 + b * k, 15 * b * k * (k - 1) / 2)
    print(f"[ab] {label}: {int(ref.sum())} kept of {int((scores > 0).sum())} valid; bound {bd['bound_ms']:.6f} ms"
          f" ({bd['bound_by']}), launch floor {floor_ms:.4f} ms", flush=True)
    for v, ts in times.items():
        mean = sum(ts) / len(ts)
        print(f"[ab]     {v}: {ts[0]:.4f} / {ts[1]:.4f} ms; {mean - floor_ms:.4f} ms above the floor,"
              f" {bd['bound_ms'] / mean:.2%} of the bound", flush=True)
    return wrong


def captured_cases(model, x: torch.Tensor) -> list:
    """The top-300 candidates rtmo-l's decode hands to NMS in a b16 forward."""
    from focoos_tpu_torch.ops.nms import pre_topk

    cfg = model.config
    with torch.inference_mode():
        boxes, scores, _ = model.module.candidates(model.module.raw_outputs(x))
        tb, ts, _ = pre_topk(boxes.float(), scores.float(), cfg.nms_pre_topk, cfg.score_thr)
    tb, ts = tb.clone(), ts.clone()
    return [(f"rtmo-l candidates B=16 K={tb.shape[1]}", tb, ts, cfg.nms_thr),
            (f"rtmo-l candidates B=1 K={tb.shape[1]}", tb[:1].contiguous(), ts[:1].contiguous(), cfg.nms_thr)]


def forward_p50(model, x: torch.Tensor, reps: int) -> float:
    """p50 of ``reps`` forwards in ms, host clock around each synchronized forward, after 3 warm-ups."""
    times = []
    with torch.inference_mode():
        for i in range(3 + reps):
            t0 = time.perf_counter()
            model.module(x)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def forward_rounds(model, x: torch.Tensor, fns: dict, rounds: int = 20) -> None:
    """rtmo-l's b1 and b16 forward p50 with the earlier kernel, the current one
    and the earlier one again (an A/A control: the spread of this procedure
    when nothing differs), in ``rounds`` rounds that rotate which runs first."""
    slots = [("earlier", fns["earlier"]), ("current", fns["current"]), ("earlier again", fns["earlier"])]
    for name, xb, reps, n in (("b1", x[:1], 30, rounds), ("b16", x, 5, rounds // 2)):
        p50 = {label: [] for label, _ in slots}
        for i in range(n):
            for label, fn in slots[i % 3:] + slots[:i % 3]:
                nms._fn = fn
                p50[label].append(forward_p50(model, xb, reps))
        nms._fn = fns["current"]
        base = np.array(p50["earlier"])
        for label, ts in p50.items():
            ts = np.array(ts)
            q75, q25 = np.percentile(ts, [75, 25])
            vs = "" if label == "earlier" else (
                f"; against earlier: median difference {np.median(ts - base):+.2f} ms, faster in"
                f" {int((ts < base).sum())} of {n} rounds")
            print(f"[ab] rtmo-l {name} forward p50 over {n} rounds, {label} kernel: median {np.median(ts):.2f} ms"
                  f" (IQR {q75 - q25:.2f}){vs}", flush=True)
            print(f"[ab]     {' '.join(f'{t:.2f}' for t in ts)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--earlier", help="a csrc directory whose nms.cu exports nms_keep with the same arguments")
    parser.add_argument("--variants", action="store_true", help="time the VARIANTS of the current source too")
    parser.add_argument("--rtmo", action="store_true",
                        help="add rtmo-l's own NMS inputs as cases; with --earlier, time its forward with each kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_nms_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[ab] {smi}", flush=True)
    dev = torch.device("cuda:0")
    cuda_build.load_libraries(("nms",))
    work = os.path.join(cuda_build.BUILD_DIR, "nms_ab")
    os.makedirs(work, exist_ok=True)
    fns = {"current": nms._kernel(), **build_all(work, os.path.abspath(args.earlier) if args.earlier else None,
                                                 args.variants)}

    g = torch.Generator().manual_seed(3)
    cases = []
    for b in (16, 1):
        boxes, scores = chip_smoke.clustered_boxes(g, b, 300)
        cases.append((f"clustered B={b} K=300", boxes.to(dev), scores.to(dev), 0.65))
    model = x = None
    if args.rtmo:
        from focoos_tpu_torch import ModelManager

        model = ModelManager.get("rtmo-l-coco", device=dev, seed=0)
        chip_smoke.perturb_rtmo(model.module, seed=4)
        x = torch.randint(0, 256, (16, 640, 640, 3), generator=torch.Generator().manual_seed(5), dtype=torch.uint8)
        x = x.to(dev)
        cases += captured_cases(model, x)
    floor_ms = chip_smoke.time_ms(lambda: torch.cuda._sleep(0))
    wrong = set()
    for label, boxes, scores, thr in cases:
        wrong.update(compare(label, fns, boxes, scores, thr, floor_ms))

    _, boxes, scores, thr = cases[1]
    hosts = [v for v in ("current", "earlier", "one block per image") if v in fns]
    times = {v: [] for v in hosts}
    for v in hosts + hosts[::-1]:
        times[v].append(chip_smoke.host_ms(runner(v, fns, boxes, scores, thr)))
    for v, ts in times.items():
        print(f"[ab] the wrapper's host time, {v} kernel, B=1 K=300: {ts[0]:.4f} / {ts[1]:.4f} ms a call"
              f" (1000 calls, no sync)", flush=True)
    nms._fn = fns["current"]
    if model is not None and "earlier" in fns:
        forward_rounds(model, x, fns)
    if wrong:
        print(f"[ab] keep masks differ from the plain version for: {sorted(wrong)}", flush=True)
    return 1 if wrong & {"current", "earlier", "two launches"} else 0


if __name__ == "__main__":
    sys.exit(main())
