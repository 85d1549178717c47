"""Multi-scale deformable attention, plain PyTorch version.

Port of ``focoos_tpu/ops/deformable.py:59 ms_deform_attn`` (the four-corner
gather formulation of ``:22-85``). It and its autograd (``ms_deform_attn_backward_reference``)
are the references the CUDA kernels in ``csrc/msda.cu`` and
``csrc/msda_bwd.cu`` are held against, and what ``ops/msda.py`` runs for
tensors on the CPU. Semantics: bilinear sampling with zeros padding
and ``align_corners=False`` (pixel = loc * size - 0.5), weighted by the
already-softmaxed attention weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _bilinear_gather_level(
    value_l: torch.Tensor,  # [B, Hh, S_l, D] head-major, flattened spatial
    loc: torch.Tensor,  # [B, Lq, Hh, P, 2] normalized (x, y)
    h: int,
    w: int,
) -> torch.Tensor:
    """Sample one level bilinearly → [B, Lq, Hh, P, D]."""
    b, lq, hh, p, _ = loc.shape
    d = value_l.shape[-1]
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0

    out = value_l.new_zeros((b, hh, lq * p, d))
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yi = y0 + dy
        y_ok = (yi >= 0) & (yi <= h - 1)
        yi_c = yi.clamp(0, h - 1)
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xi = x0 + dx
            ok = y_ok & (xi >= 0) & (xi <= w - 1)
            xi_c = xi.clamp(0, w - 1)
            wgt = torch.where(ok, wx * wy, torch.zeros_like(wx)).to(value_l.dtype)  # [B, Lq, Hh, P]
            idx = (yi_c * w + xi_c).long()
            idx_hm = idx.permute(0, 2, 1, 3).reshape(b, hh, lq * p, 1).expand(b, hh, lq * p, d)
            g = torch.gather(value_l, 2, idx_hm)  # [B, Hh, Lq*P, D]
            wgt_hm = wgt.permute(0, 2, 1, 3).reshape(b, hh, lq * p, 1)
            out = out + g * wgt_hm
    return out.reshape(b, hh, lq, p, d).permute(0, 2, 1, 3, 4)


def ms_deform_attn(
    value: torch.Tensor,  # [B, S, Hh, D], S = sum(H_l * W_l)
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, Hh, L, P, 2] in [0, 1]
    attention_weights: torch.Tensor,  # [B, Lq, Hh, L, P]
) -> torch.Tensor:
    """Multi-scale deformable attention → [B, Lq, Hh * D]."""
    b, _, hh, d = value.shape
    lq = sampling_locations.shape[1]
    out = value.new_zeros((b, lq, hh, d))
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        value_l = value[:, start : start + h * w].permute(0, 2, 1, 3)  # [B, Hh, S_l, D]
        start += h * w
        sampled = _bilinear_gather_level(value_l, sampling_locations[:, :, :, lid], h, w)
        w_l = attention_weights[:, :, :, lid].to(value.dtype)  # [B, Lq, Hh, P]
        out = out + torch.einsum("blhpd,blhp->blhd", sampled, w_l)
    return out.reshape(b, lq, hh * d)


def ms_deform_attn_backward_reference(
    value: torch.Tensor,  # [B, S, Hh, D]
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, Hh, L, P, 2]
    attention_weights: torch.Tensor,  # [B, Lq, Hh, L, P]
    grad_out: torch.Tensor,  # [B, Lq, Hh * D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d value, d sampling_locations, d attention_weights): autograd of
    ``ms_deform_attn`` — the plain version of ``csrc/msda_bwd.cu``, the
    counterpart of ``focoos_tpu/ops/pallas/msda.py:177 _fused_bwd``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn(inputs[0], spatial_shapes, inputs[1], inputs[2])
        return torch.autograd.grad(out, inputs, grad_out.to(out.dtype))
