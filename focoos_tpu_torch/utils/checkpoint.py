"""Weight files and tolerant loads (port of focoos_tpu/utils/checkpoint.py).

The exchange format is the JAX package's: a ``.npz`` of '/'-joined paths
(``params/...``, ``batch_stats/...``) → numpy arrays, the analog of the
reference's ``model_final.pth``. ``utils/weights.py`` maps it to and from a
port ``state_dict``. A torch ``state_dict`` is already flat, so the JAX
module's tree flatten / unflatten have no counterpart here. Training
checkpoints are torch's own files (``trainer/checkpointer.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch


def save_variables_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_variables_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def merge_compatible(
    target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor], strict: bool = False
) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Shape-tolerant merge (reference: focoos/models/base_model.py:98-143):
    a source tensor replaces the target's where name and shape match (cast to
    the target's dtype) → (merged, skipped: shape differs, missing: not in
    source). ``strict`` raises on either."""
    merged, skipped, missing = dict(target), [], []
    for k, v in target.items():
        if k not in source:
            missing.append(k)
        elif tuple(source[k].shape) != tuple(v.shape):
            skipped.append(k)
        else:
            merged[k] = source[k].to(v.dtype)
    if strict and (skipped or missing):
        raise ValueError(f"strict load failed: skipped={skipped[:5]} missing={missing[:5]}")
    return merged, skipped, missing
