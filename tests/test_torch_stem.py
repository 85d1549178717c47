"""Port parity: the plain fused ResNet-D stem (what ``focoos_tpu_torch.ops.
stem.fused_resnet_stem`` runs on the CPU) against a JAX ConvNorm×3 +
``nn.max_pool`` stem and against the Pallas ``fused_resnet_stem`` in interpret
mode, on the same numpy weights and inputs. Tolerance 1e-4 × max|ref|: fp32
on both sides, 3x3 convolutions summed in another order."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focoos_tpu.nn.layers.common import ConvNorm
from focoos_tpu.ops.pallas.stem import fused_resnet_stem as jax_fused_resnet_stem
from focoos_tpu_torch.ops import stem as stem_mod
from focoos_tpu_torch.ops.stem import fused_resnet_stem

REL_TOL = 1e-4
CHANNELS = ((3, 32), (32, 32), (32, 64))


class _JaxStem(fnn.Module):
    """The JAX ResNet-D stem in eval (resnet.py:154-168)."""

    @fnn.compact
    def __call__(self, x):
        for name, (_, cout), stride in zip(("conv1_1", "conv1_2", "conv1_3"), CHANNELS, (2, 1, 1)):
            x = ConvNorm(cout, 3, stride, act="relu", name=name)(x, False)
        return fnn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])


def _stem_params(rng):
    """HWIO kernels + folded BN (scale, bias) per conv, and the same BN as raw
    (gamma, beta, mean, var) for the JAX module."""
    folded, raw = [], []
    for cin, cout in CHANNELS:
        k = (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        gamma = rng.uniform(0.8, 1.2, cout).astype(np.float32)
        beta = rng.normal(0, 0.1, cout).astype(np.float32)
        mean = rng.normal(0, 0.1, cout).astype(np.float32)
        var = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        scale = (gamma / np.sqrt(var + 1e-5)).astype(np.float32)
        folded += [k, scale, (beta - mean * scale).astype(np.float32)]
        raw.append((k, gamma, beta, mean, var))
    return folded, raw


def _port(x, folded):
    return fused_resnet_stem(torch.from_numpy(x), *[torch.from_numpy(p) for p in folded]).numpy()


@pytest.mark.parametrize("b,h,w", [(1, 33, 47), (2, 64, 64), (1, 30, 31), (1, 5, 6), (1, 1, 1), (1, 2, 3), (1, 9, 17)])
def test_plain_stem_matches_jax_convnorm_stem(b, h, w):
    rng = np.random.default_rng(h * 100 + w)
    folded, raw = _stem_params(rng)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    params, stats = {}, {}
    for name, (k, gamma, beta, mean, var) in zip(("conv1_1", "conv1_2", "conv1_3"), raw):
        params[name] = {"conv": {"kernel": k}, "norm": {"bn": {"scale": gamma, "bias": beta}}}
        stats[name] = {"norm": {"bn": {"mean": mean, "var": var}}}
    ref = np.asarray(_JaxStem().apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    got = _port(x, folded)
    h4, w4 = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2  # conv s2 then pool s2, both padded
    assert got.shape == ref.shape == (b, h4, w4, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


def test_plain_stem_matches_pallas_interpret():
    """H=32: one band, the only height at which the Pallas wrapper works
    (stem.py:199 drops a factor of 2 on the band padding)."""
    rng = np.random.default_rng(7)
    folded, _ = _stem_params(rng)
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    ref = np.asarray(jax_fused_resnet_stem(jnp.asarray(x), *[jnp.asarray(p) for p in folded], interpret=True))
    got = _port(x, folded)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda x, p: (x[..., :2], p), ValueError),
        (lambda x, p: (x.double(), p), TypeError),
        (lambda x, p: (x.permute(0, 2, 1, 3), p), ValueError),
        (lambda x, p: (x, [p[0][..., :16]] + p[1:]), ValueError),
        (lambda x, p: (x, p[:1] + [p[1].double()] + p[2:]), TypeError),
        (lambda x, p: (x, p[:3] + [p[3].transpose(0, 1)] + p[4:]), ValueError),
    ],
    ids=["channels", "x-dtype", "x-strides", "k-shape", "s-dtype", "k-strides"],
)
def test_kernel_argument_checks_raise(mutate, err):
    """What the CUDA kernel does not take is refused before any launch."""
    rng = np.random.default_rng(3)
    folded, _ = _stem_params(rng)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 3)).astype(np.float32))
    x, params = mutate(x, [torch.from_numpy(p) for p in folded])
    with pytest.raises(err):
        stem_mod._check(x, params)
