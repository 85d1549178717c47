"""Training-metrics parsing + visualization (copy of focoos_tpu/utils/metrics.py;
reference: focoos/utils/metrics.py:58,193). matplotlib is imported only to plot."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Metrics:
    train_metrics: List[dict] = field(default_factory=list)
    valid_metrics: List[dict] = field(default_factory=list)
    best_valid_metric: Optional[dict] = None
    infer_metrics: List[dict] = field(default_factory=list)

    @property
    def iterations(self) -> Optional[int]:
        if not self.train_metrics:
            return None
        return max(int(m.get("iteration", -1)) for m in self.train_metrics)


def parse_metrics(metrics_path: str) -> Metrics:
    """Parse a metrics.json JSONL file (reference: utils/metrics.py:58)."""
    m = Metrics()
    if not os.path.isfile(metrics_path):
        return m
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            is_valid = any(("/AP" in k) or k.startswith(("mIoU", "f1", "sem_seg", "bbox", "segm", "keypoints"))
                           for k in row)
            if is_valid:
                m.valid_metrics.append(row)
            if "total_loss" in row or any(k.startswith("loss") for k in row):
                m.train_metrics.append(row)
    # best = max primary metric across eval rows
    def primary(row):
        for k in ("bbox/AP", "segm/AP", "keypoints/AP", "sem_seg/mIoU", "mIoU", "classification/f1", "f1"):
            if k in row:
                return row[k]
        return None

    best = None
    for row in m.valid_metrics:
        p = primary(row)
        if p is not None and (best is None or p > primary(best)):
            best = row
    m.best_valid_metric = best
    return m


class MetricsVisualizer:
    """Plot loss/metric curves from parsed metrics (reference: utils/metrics.py:193)."""

    def __init__(self, metrics: Metrics):
        self.metrics = metrics

    def notebook_plot_training_metrics(self, out_path: Optional[str] = None):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            raise RuntimeError("matplotlib not available for plotting")

        rows = self.metrics.train_metrics
        if not rows:
            return None
        iters = [r.get("iteration", i) for i, r in enumerate(rows)]
        keys = sorted({k for r in rows for k in r if "loss" in k and not k[-1].isdigit()})
        fig, ax = plt.subplots(figsize=(10, 5))
        for k in keys[:8]:
            ys = [r.get(k) for r in rows]
            xs = [i for i, y in zip(iters, ys) if y is not None]
            ys = [y for y in ys if y is not None]
            ax.plot(xs, ys, label=k)
        ax.set_xlabel("iteration")
        ax.legend()
        if out_path:
            fig.savefig(out_path, dpi=100, bbox_inches="tight")
        return fig
