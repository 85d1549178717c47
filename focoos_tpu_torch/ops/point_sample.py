"""Normalized-coordinate point sampling (PointRend-style) on tensors.

Port of ``focoos_tpu/ops/point_sample.py`` (the reference's ``grid_sample``-based
``point_sample`` and uncertainty-driven point selection,
focoos/nn/layers/point_rend.py:29,:73). The bilinear gather is the JAX
package's own formula, not ``F.grid_sample``, so its edge handling is the same
by construction: four clipped corners, a corner outside the map weighs 0.
The random draws are split from the deterministic pick
(``pick_uncertain_coords``), so that a test can feed the JAX package's
draws in. Plain PyTorch: no TPU kernel stands behind it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from focoos_tpu_torch.ops.topk import topk_lowest_index_first
from focoos_tpu_torch.parallel import mesh


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of [M, H, W] maps at [M, P, 2] normalized (x, y)
    coordinates in [0, 1]² (``align_corners=False``, zero padding) → [M, P].
    Any leading dims work, and ``coords``' broadcast to the maps' (the
    matcher samples every query of an image at one [1, P, 2] set): the
    corners and weights are then computed once per point set."""
    h, w = masks.shape[-2:]
    lead = masks.shape[:-2]
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    flat = masks.reshape(*lead, h * w)
    out = masks.new_zeros((*lead, coords.shape[-2]))
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yi = y0 + dy
        y_ok = (yi >= 0) & (yi <= h - 1)
        yi_c = yi.clamp(0, h - 1)
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xi = x0 + dx
            ok = y_ok & (xi >= 0) & (xi <= w - 1)
            idx = (yi_c * w + xi.clamp(0, w - 1)).long()
            g = torch.gather(flat, -1, idx.expand(*lead, idx.shape[-1]))
            out = out + g * torch.where(ok, wx * wy, 0.0).to(masks.dtype)
    return out


def pick_uncertain_coords(
    coarse_logits: torch.Tensor,  # [M, H, W]
    coords: torch.Tensor,  # [M, S, 2] the oversampled uniform draw
    num_uncertain: int,
    extra: Optional[torch.Tensor] = None,  # [M, P - num_uncertain, 2] the top-up draw
) -> torch.Tensor:
    """The deterministic half of the point selection: the ``num_uncertain``
    points of ``coords`` where |logit| is smallest (``jax.lax.top_k``'s order,
    equal values lower index first), then ``extra`` → [M, P, 2]."""
    uncertainty = -point_sample(coarse_logits.float(), coords).abs()
    _, idx = topk_lowest_index_first(uncertainty, num_uncertain, dim=1)
    picked = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    return picked if extra is None else torch.cat([picked, extra], 1)


def uncertainty_sampled_coords(
    generator: Optional[torch.Generator],
    coarse_logits: torch.Tensor,  # [M, H, W]
    num_points: int,
    oversample_ratio: float = 3.0,
    importance_sample_ratio: float = 0.75,
    span: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """PointRend point selection (reference: point_rend.py:73-129): draw
    ``int(num_points · oversample_ratio)`` uniform points, keep the
    ``int(importance_sample_ratio · num_points)`` most uncertain, top up with
    fresh uniform points → [M, P, 2] fp32 on the logits' device. The draws
    come from ``generator``, which lives on that device (None: torch's
    default generator there). With the batch split over ranks, the M rows
    are this rank's of every rank's rows (``span``: ``mesh.row_span``'s), and
    each draw is the global batch's, of which this rank keeps its rows."""
    m, dev = coarse_logits.shape[0], coarse_logits.device
    n_unc = int(importance_sample_ratio * num_points)
    coords = mesh.global_rand((m, int(num_points * oversample_ratio), 2), generator, dev, span=span)
    extra = None
    if num_points > n_unc:
        extra = mesh.global_rand((m, num_points - n_unc, 2), generator, dev, span=span)
    return pick_uncertain_coords(coarse_logits, coords, n_unc, extra)
