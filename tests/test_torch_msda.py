"""Port parity: the plain PyTorch MSDA (what ``focoos_tpu_torch.ops.msda.
msda_forward`` runs on the CPU) against the JAX package's three MSDA
formulations, on the same numpy inputs. Tolerance 2e-5 absolute: fp32 on
both sides, the same samples summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focoos_tpu.ops.deformable import ms_deform_attn, ms_deform_attn_dispatch_levels
from focoos_tpu.ops.pallas.msda import msda_pallas
from focoos_tpu_torch.ops import msda as msda_mod
from focoos_tpu_torch.ops.msda import msda_forward

TOL = 2e-5

# (B, Lq, Hh, D, P, spatial shapes): tests/test_ops.py:275-280 and :245
SHAPES = {
    "square": (1, 12, 2, 8, 4, ((8, 8), (4, 4))),
    "odd": (2, 7, 3, 8, 4, ((9, 11), (5, 6))),
}


def _inputs(shape_key, lo, hi, seed=1):
    b, lq, hh, d, p, ss = SHAPES[shape_key]
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in ss)
    v = rng.random((b, s, hh, d), np.float32) - 0.5
    loc = rng.uniform(lo, hi, (b, lq, hh, len(ss), p, 2)).astype(np.float32)
    aw = rng.random((b, lq, hh, len(ss), p), np.float32)
    return v, ss, loc, aw


def _jax_gather(v, ss, loc, aw):
    return ms_deform_attn(jnp.asarray(v), ss, jnp.asarray(loc), jnp.asarray(aw))


def _jax_levels(v, ss, loc, aw):
    b, _, hh, d = v.shape
    levels, start = [], 0
    for h, w in ss:
        levels.append(jnp.asarray(v[:, start : start + h * w].reshape(b, h, w, hh, d)))
        start += h * w
    return ms_deform_attn_dispatch_levels(levels, ss, jnp.asarray(loc), jnp.asarray(aw))


def _jax_pallas(v, ss, loc, aw):
    return msda_pallas(jnp.asarray(v), ss, jnp.asarray(loc), jnp.asarray(aw), interpret=True)


@pytest.mark.parametrize("jax_fn", [_jax_gather, _jax_levels, _jax_pallas], ids=["gather", "levels", "pallas"])
@pytest.mark.parametrize("shape_key", sorted(SHAPES))
@pytest.mark.parametrize("lo,hi", [(0.05, 0.95), (-0.2, 1.2)], ids=["inside", "outside"])
def test_plain_msda_matches_jax(jax_fn, shape_key, lo, hi):
    v, ss, loc, aw = _inputs(shape_key, lo, hi)
    ref = np.asarray(jax_fn(v, ss, loc, aw))
    got = msda_forward(torch.from_numpy(v), ss, torch.from_numpy(loc), torch.from_numpy(aw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_plain_msda_reaches_zeros_padding():
    """Every sample far outside the map reads only padding: the output is 0."""
    v, ss, loc, aw = _inputs("odd", 0.05, 0.95)
    loc[...] = 3.0
    got = msda_forward(torch.from_numpy(v), ss, torch.from_numpy(loc), torch.from_numpy(aw))
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda v, ss, loc, aw: (v[0], ss, loc, aw), ValueError),
        (lambda v, ss, loc, aw: (v, ss[:1], loc, aw), ValueError),
        (lambda v, ss, loc, aw: (v.double(), ss, loc, aw), TypeError),
        (lambda v, ss, loc, aw: (v, ss, loc.half(), aw), TypeError),
        (lambda v, ss, loc, aw: (v, ss, loc, aw[..., :2]), ValueError),
        (lambda v, ss, loc, aw: (v.transpose(1, 2).contiguous().transpose(1, 2), ss, loc, aw), ValueError),
    ],
    ids=["rank", "levels", "value-dtype", "loc-dtype", "aw-shape", "strides"],
)
def test_kernel_argument_checks_raise(mutate, err):
    """What the CUDA kernel does not take is refused before any launch."""
    v, ss, loc, aw = _inputs("odd", 0.05, 0.95)
    args = mutate(torch.from_numpy(v), list(ss), torch.from_numpy(loc), torch.from_numpy(aw))
    with pytest.raises(err):
        msda_mod._check(*args)
