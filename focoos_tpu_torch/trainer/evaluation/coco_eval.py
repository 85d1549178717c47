"""COCO-style AP computation in pure numpy (copy of
``focoos_tpu/trainer/evaluation/coco_eval.py``; the port keeps its own copy so
that it runs without ``focoos_tpu``).

The reference delegates to the ``faster_coco_eval`` C++ extension
(SURVEY.md §2.13); this module implements the COCOeval protocol directly:
greedy per-image matching at IoU thresholds 0.5:0.05:0.95, 101-point
interpolated precision, area ranges (all/small/medium/large), maxDets=100,
-1 for a slice without ground truth. The IoU kernel is pluggable (bbox IoU,
mask IoU on the host C++ of ``utils/native.py``, a precomputed matrix, or
OKS), so the detection, instance-segmentation and keypoint evaluators share
one core.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100


def bbox_iou_matrix(dt_boxes: np.ndarray, gt_boxes: np.ndarray, gt_crowd: np.ndarray) -> np.ndarray:
    """[D, 4] × [G, 4] xyxy → [D, G] IoU (IoA for crowd gts, COCO convention)."""
    d, g = len(dt_boxes), len(gt_boxes)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    lt = np.maximum(dt_boxes[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(dt_boxes[:, None, 2:], gt_boxes[None, :, 2:])
    wh = (rb - lt).clip(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_d = ((dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1]))[:, None]
    area_g = ((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]))[None, :]
    union = np.where(gt_crowd[None, :], area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-9)


def mask_iou_matrix(dt_masks: Sequence[np.ndarray], gt_masks: Sequence[np.ndarray], gt_crowd: np.ndarray) -> np.ndarray:
    from focoos_tpu_torch.utils.native import mask_iou

    return mask_iou(dt_masks, gt_masks, gt_crowd).astype(np.float64)


# COCO keypoint sigmas (person)
COCO_KPT_SIGMAS = np.array(
    [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072, 0.062,
     0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089]
)


def oks_matrix(
    dt_kpts: np.ndarray,  # [D, K, 3] (x, y, score)
    gt_kpts: np.ndarray,  # [G, K, 3] (x, y, vis)
    gt_areas: np.ndarray,  # [G]
    sigmas: Optional[np.ndarray] = None,
) -> np.ndarray:
    d, g = len(dt_kpts), len(gt_kpts)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    k = gt_kpts.shape[1]
    sigmas = sigmas if sigmas is not None else (COCO_KPT_SIGMAS if k == 17 else np.full(k, 0.05))
    var = (2 * sigmas) ** 2
    out = np.zeros((d, g))
    for j in range(g):
        vis = gt_kpts[j, :, 2] > 0
        if not vis.any():
            continue
        dx = dt_kpts[:, :, 0] - gt_kpts[j, :, 0]
        dy = dt_kpts[:, :, 1] - gt_kpts[j, :, 1]
        e = (dx**2 + dy**2) / var / (gt_areas[j] + np.spacing(1)) / 2
        out[:, j] = np.exp(-e[:, vis]).sum(1) / vis.sum()
    return out


class CocoStyleEvaluator:
    """Accumulates per-image (class-keyed) dets/gts and computes AP."""

    def __init__(
        self,
        num_classes: int,
        iou_fn: str = "bbox",  # "bbox" | "mask" | "oks"
        class_names: Optional[List[str]] = None,
        kpt_sigmas: Optional[np.ndarray] = None,
    ):
        self.num_classes = num_classes
        self.iou_fn = iou_fn
        self.class_names = class_names
        self.kpt_sigmas = kpt_sigmas
        # per (image, class): dict with det arrays + gt arrays
        self._entries: List[dict] = []

    def add_image(
        self,
        dt_classes: np.ndarray,
        dt_scores: np.ndarray,
        gt_classes: np.ndarray,
        gt_areas: np.ndarray,
        gt_crowd: Optional[np.ndarray] = None,
        dt_boxes: Optional[np.ndarray] = None,
        gt_boxes: Optional[np.ndarray] = None,
        dt_masks: Optional[Sequence[np.ndarray]] = None,
        gt_masks: Optional[Sequence[np.ndarray]] = None,
        dt_kpts: Optional[np.ndarray] = None,
        gt_kpts: Optional[np.ndarray] = None,
        iou_matrix: Optional[np.ndarray] = None,
    ) -> None:
        """``iou_matrix``: an optional precomputed [n_dt, n_gt] IoU (the mask
        IoU on the device, ops/mask_iou.py), sliced per class in place of an
        IoU from dense masks."""
        gt_crowd = gt_crowd if gt_crowd is not None else np.zeros(len(gt_classes), bool)
        for c in np.unique(np.concatenate([dt_classes, gt_classes])).astype(int):
            dsel = dt_classes == c
            gsel = gt_classes == c
            # maxDets caps per (image, category) AFTER the score sort — the
            # pycocotools convention (COCOeval.evaluateImg slices dt[:maxDet]
            # per img+cat), NOT top-100 per image across categories.
            if int(dsel.sum()) > MAX_DETS:
                didx = np.flatnonzero(dsel)
                keep_local = np.argsort(-dt_scores[didx], kind="stable")[:MAX_DETS]
                dsel = np.zeros_like(dsel)
                dsel[didx[keep_local]] = True
            if iou_matrix is not None:
                iou = np.asarray(iou_matrix, np.float64)[np.ix_(dsel, gsel)]
            elif self.iou_fn == "bbox":
                iou = bbox_iou_matrix(dt_boxes[dsel], gt_boxes[gsel], gt_crowd[gsel])
            elif self.iou_fn == "mask":
                dm = [m for m, s in zip(dt_masks or [], dsel) if s]
                gm = [m for m, s in zip(gt_masks or [], gsel) if s]
                iou = mask_iou_matrix(dm, gm, gt_crowd[gsel])
            else:
                iou = oks_matrix(dt_kpts[dsel], gt_kpts[gsel], gt_areas[gsel], self.kpt_sigmas)
            # det areas for area-range filtering (use boxes if available)
            if dt_boxes is not None:
                db = dt_boxes[dsel]
                d_areas = (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1])
            elif dt_masks is not None:
                d_areas = np.array([m.sum() for m, s in zip(dt_masks, dsel) if s], dtype=np.float64)
            else:
                d_areas = np.full(int(dsel.sum()), 50.0**2)
            self._entries.append(
                dict(
                    cls=int(c),
                    scores=dt_scores[dsel],
                    d_areas=np.asarray(d_areas, np.float64).reshape(-1),
                    g_areas=gt_areas[gsel],
                    g_crowd=gt_crowd[gsel],
                    iou=iou,
                )
            )

    # ------------------------------------------------------------------
    def _evaluate_entry(self, e: dict, area_rng) -> tuple:
        """Greedy COCO matching for one (image, class) → per-threshold det
        match flags + ignore flags + number of non-ignored gts."""
        lo, hi = area_rng
        g_ignore = e["g_crowd"] | (e["g_areas"] < lo) | (e["g_areas"] > hi)
        order_g = np.argsort(g_ignore, kind="stable")  # non-ignored first
        order_d = np.argsort(-e["scores"], kind="stable")
        iou = e["iou"][order_d][:, order_g]
        gi = g_ignore[order_g]
        nd, ng = iou.shape
        T = len(IOU_THRS)
        dt_match = np.zeros((T, nd), bool)
        dt_ignore = np.zeros((T, nd), bool)
        gt_matched = np.zeros((T, ng), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(nd):
                best, bj = thr - 1e-10, -1
                for gj in range(ng):
                    if gt_matched[ti, gj] and not gi[gj]:
                        continue
                    # stop at ignored gts if a real match was already found
                    if bj > -1 and not gi[bj] and gi[gj]:
                        break
                    if iou[di, gj] < best:
                        continue
                    best, bj = iou[di, gj], gj
                if bj == -1:
                    continue
                gt_matched[ti, bj] = True
                dt_match[ti, di] = True
                dt_ignore[ti, di] = gi[bj]
        # unmatched dets outside the area range are ignored
        d_out = (e["d_areas"][order_d] < lo) | (e["d_areas"][order_d] > hi)
        dt_ignore |= (~dt_match) & d_out[None, :]
        return e["scores"][order_d], dt_match, dt_ignore, int((~gi).sum())

    def summarize(self, prefix: str = "bbox") -> Dict[str, float]:
        T = len(IOU_THRS)
        results: Dict[str, float] = {}
        per_class_ap: Dict[int, float] = {}
        ap_all_cls: Dict[str, List[float]] = {k: [] for k in AREA_RANGES}
        ap50_cls, ap75_cls = [], []

        entries_by_cls: Dict[int, List[dict]] = {}
        for e in self._entries:
            entries_by_cls.setdefault(e["cls"], []).append(e)

        for c, entries in sorted(entries_by_cls.items()):
            for area_name, area_rng in AREA_RANGES.items():
                scores_l, match_l, ignore_l, npos = [], [], [], 0
                for e in entries:
                    s, m, ig, np_ = self._evaluate_entry(e, area_rng)
                    scores_l.append(s)
                    match_l.append(m)
                    ignore_l.append(ig)
                    npos += np_
                if npos == 0:
                    continue
                scores = np.concatenate(scores_l)
                order = np.argsort(-scores, kind="stable")
                match = np.concatenate(match_l, axis=1)[:, order]
                ignore = np.concatenate(ignore_l, axis=1)[:, order]

                aps = np.zeros(T)
                for ti in range(T):
                    keep = ~ignore[ti]
                    tp = np.cumsum(match[ti][keep])
                    fp = np.cumsum(~match[ti][keep])
                    rc = tp / npos
                    pr = tp / np.maximum(tp + fp, 1e-9)
                    # monotone precision envelope + 101-pt interp
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    idx = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(len(RECALL_THRS))
                    valid = idx < len(pr)
                    q[valid] = pr[idx[valid]]
                    aps[ti] = q.mean()

                if area_name == "all":
                    per_class_ap[c] = float(aps.mean())
                    ap50_cls.append(float(aps[0]))
                    ap75_cls.append(float(aps[5]))
                ap_all_cls[area_name].append(float(aps.mean()))

        def mean_or_nan(vals):
            # pycocotools reports -1 when an (area, category) slice has no
            # GTs (COCOeval.summarize) — and NaN is not valid strict JSON,
            # which breaks downstream metric-line parsers
            return float(np.mean(vals)) * 100 if vals else -1.0

        # Bare keys: callers namespace the dict under "bbox"/"segm"/"keypoints",
        # so these flatten to e.g. "bbox/AP" in the event storage — the exact
        # name BestCheckpointer / EarlyStopping / TASK_METRICS watch.
        results["AP"] = mean_or_nan(ap_all_cls["all"])
        results["AP50"] = mean_or_nan(ap50_cls)
        results["AP75"] = mean_or_nan(ap75_cls)
        results["APs"] = mean_or_nan(ap_all_cls["small"])
        results["APm"] = mean_or_nan(ap_all_cls["medium"])
        results["APl"] = mean_or_nan(ap_all_cls["large"])
        if self.class_names:
            for c, ap in per_class_ap.items():
                if c < len(self.class_names):
                    results[f"AP-{self.class_names[c]}"] = ap * 100
        return results
