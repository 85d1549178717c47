"""MSDA gradients: the port against the JAX package on the CPU, fp32.

The JAX fai_detr model differentiates ``ms_deform_attn_dispatch`` (the
separable form under ``remat``), and the Pallas kernel's custom VJP
(``focoos_tpu/ops/pallas/msda.py:177 _fused_bwd``) is ``jax.vjp`` of
``ms_deform_attn_separable``: both are held against the port's plain backward
(``ms_deform_attn_backward_reference``), its ``_MSDAFunction`` route and the
``msda_backward`` wrapper, which on CPU tensors run the plain version.

Tolerances, × max|ref|: d value and d aw 1e-5 (sums in another order); d loc
1e-4 (a difference of corner values scaled by the map size). Pixel
coordinates keep a fraction in [0.05, 0.95], away from the integers where
``floor`` makes the derivative one-sided, and reach one pixel outside every
edge, so some corners are out of range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focoos_tpu.ops.deformable import ms_deform_attn, ms_deform_attn_dispatch, ms_deform_attn_separable
from focoos_tpu_torch.ops.deformable import ms_deform_attn as ms_deform_attn_torch
from focoos_tpu_torch.ops.deformable import ms_deform_attn_backward_reference
from focoos_tpu_torch.ops.msda import _MSDAFunction, msda_backward

TOL = (1e-5, 1e-4, 1e-5)  # d value, d loc, d aw
SHAPES = {
    "three-levels": (2, 10, 4, 8, ((6, 5), (3, 3), (2, 2))),
    "two-levels-d48": (1, 7, 2, 48, ((9, 11), (4, 3))),
}


def _inputs(b, lq, hh, d, ss, seed=0):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in ss)
    value = rng.standard_normal((b, s, hh, d)).astype(np.float32)
    size = np.array([[w, h] for h, w in ss], np.float32)[:, None, :]  # [L, 1, 2] as (W, H)
    pix = np.floor(rng.uniform(-1.0, 1.0, (b, lq, hh, len(ss), 4, 2)) * (size + 2) / 2 + size / 2 - 0.5)
    pix = pix + rng.uniform(0.05, 0.95, pix.shape)
    loc = ((pix + 0.5) / size).astype(np.float32)
    aw = rng.uniform(0.0, 1.0, (b, lq, hh, len(ss), 4)).astype(np.float32)
    grad = rng.standard_normal((b, lq, hh * d)).astype(np.float32)
    assert (loc < 0).any() and (loc > 1).any(), "no location outside the map: the case tests nothing"
    return value, loc, aw, grad


def _jax_grads(fn, value, ss, loc, aw, grad, jit=True):
    def vjp(v, l, a, g):
        return jax.vjp(lambda v, l, a: fn(v, ss, l, a), v, l, a)[1](g)

    return [np.asarray(g) for g in (jax.jit(vjp) if jit else vjp)(*(jnp.asarray(x) for x in (value, loc, aw, grad)))]


def _assert_close(got, ref):
    for name, g, r, tol in zip(("d value", "d loc", "d aw"), got, ref, TOL):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("jax_fn", [ms_deform_attn_separable, ms_deform_attn_dispatch], ids=["separable", "dispatch"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_matches_jax_vjp(shape, jax_fn):
    b, lq, hh, d, ss = SHAPES[shape]
    value, loc, aw, grad = _inputs(b, lq, hh, d, ss)
    ref = _jax_grads(jax_fn, value, ss, loc, aw, grad)
    t = [torch.from_numpy(x) for x in (value, loc, aw, grad)]
    _assert_close(ms_deform_attn_backward_reference(t[0], ss, t[1], t[2], t[3]), ref)
    _assert_close(msda_backward(t[0], ss, t[1], t[2], t[3]), ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_autograd_function_cpu_route_matches_jax_vjp(shape):
    """``_MSDAFunction`` on CPU tensors: the plain forward, the plain backward
    through ``msda_backward``, and no gradient where none is asked."""
    b, lq, hh, d, ss = SHAPES[shape]
    value, loc, aw, grad = _inputs(b, lq, hh, d, ss, seed=1)
    ref = _jax_grads(ms_deform_attn_separable, value, ss, loc, aw, grad)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (value, loc, aw)]
    out = _MSDAFunction.apply(leaves[0], ss, leaves[1], leaves[2])
    out.backward(torch.from_numpy(grad))
    _assert_close([t.grad for t in leaves], ref)

    v = torch.from_numpy(value)  # value needs no gradient: only loc and aw get one
    lc, a = (torch.from_numpy(x).requires_grad_() for x in (loc, aw))
    _MSDAFunction.apply(v, ss, lc, a).backward(torch.from_numpy(grad))
    assert v.grad is None
    np.testing.assert_allclose(lc.grad.numpy(), ref[1], rtol=0, atol=TOL[1] * np.abs(ref[1]).max())


def test_plain_version_at_a_pixel_edge_matches_jax():
    """A location one ulp below a pixel edge: at W=80 the fp32 location
    0.10625 - 1 ulp gives loc * W = 8.4999995, and minus 0.5 rounds to 8.0.
    JAX's gather (``ms_deform_attn``) as written, op by op, and the port's
    plain version both round after the product and after the difference, so
    both take the cell [8, 9]: on a value |x - 8| the output is 0 and d loc is
    that cell's slope, +1 a pixel. The CUDA kernels round the same way (the
    card test ``test_msda_backward_at_a_pixel_edge_matches_plain``). Under
    ``jax.jit`` XLA's CPU compiler contracts the product and the difference
    into one fused multiply-add, which rounds once, to 7.9999995, and takes
    the cell [7, 8]: the JAX package's compiled result departs from its own
    source at such a point, so the reference here runs uncompiled."""
    w, h = 80, 4
    loc_x = np.float32(0.10624999552965164)
    assert np.float32(np.float32(loc_x * np.float32(w)) - np.float32(0.5)) == 8.0  # rounded twice
    assert np.float32(np.float64(loc_x) * w - 0.5) < 8.0  # rounded once, it would be in the cell [7, 8]
    value = np.tile(np.abs(np.arange(w) - 8.0), h).astype(np.float32).reshape(1, h * w, 1, 1)
    loc = np.array([loc_x, 1.5 / h], np.float32).reshape(1, 1, 1, 1, 1, 2)  # y on row 1
    aw = np.ones((1, 1, 1, 1, 1), np.float32)
    grad = np.ones((1, 1, 1), np.float32)
    ref = _jax_grads(ms_deform_attn, value, [(h, w)], loc, aw, grad, jit=False)
    t = [torch.from_numpy(x) for x in (value, loc, aw, grad)]
    got = ms_deform_attn_backward_reference(t[0], [(h, w)], t[1], t[2], t[3])
    assert ref[1][0, 0, 0, 0, 0, 0] == got[1][0, 0, 0, 0, 0, 0] == w
    _assert_close(got, ref)
    out = ms_deform_attn_torch(t[0], [(h, w)], t[1], t[2])
    ref_out = ms_deform_attn(jnp.asarray(value), [(h, w)], jnp.asarray(loc), jnp.asarray(aw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=0, atol=1e-6)
