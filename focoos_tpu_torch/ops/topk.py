"""Top-k in ``jax.lax.top_k``'s order.

``torch.topk`` leaves the order of equal values unspecified: on the CPU it
returns [2, 4, 1] for the three 3s of [1, 3, 3, 2, 3] at k=3, where
``jax.lax.top_k`` returns [1, 2, 4], the lower index first. bf16 scores tie
often, so every top-k of the port that stands for a ``jax.lax.top_k`` of the
JAX package goes through ``topk_lowest_index_first`` (fai_detr's query
selection and decode, rtmo's NMS pre-top-k and output top-k). Plain PyTorch:
no TPU kernel stands behind it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_lowest_index_first(x: torch.Tensor, k: int, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along ``dim``: values
    descending and, among equal values, the lower index first (a stable
    descending sort, cut at ``k``)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)
