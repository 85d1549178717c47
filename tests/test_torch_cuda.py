"""Kernel tests that need the card. They skip where ``torch.cuda.is_available()``
is false. On a machine with an NVIDIA H100 and nvcc, run them without the JAX
test configuration (tests/conftest.py imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same inputs
on the card, with TF32 off. Tolerances, × max|ref|: fp32, 1e-5 for MSDA and
1e-4 for the stem's three chained 3x3 convs (its tensor-core products carry
each fp32 operand as a bf16 hi + lo pair, ~16 bits: ~1e-5 over the chain);
bf16 values, 2^-7 (the kernels accumulate in fp32 and round the output to
bf16 once; the stem also rounds its weights and y1/y2 to bf16, ~5e-3 at
most, against the plain version in fp32 on the same bf16 inputs). The NMS
kernel's keep mask must equal the plain version's exactly.
"""

import numpy as np
import pytest
import torch

from focoos_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_backward_reference
from focoos_tpu_torch.ops.msda import msda_backward, msda_forward
from focoos_tpu_torch.ops.nms import nms_keep, nms_keep_reference
from focoos_tpu_torch.ops.stem import fused_resnet_stem, resnet_stem_reference

pytestmark = pytest.mark.cuda

MSDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
# (d value, d loc, d aw) x max|ref|. fp32: d value and d aw 1e-5 (sums in
# another order, and the kernel's atomics add in a run-dependent order); d loc
# 1e-4 (a difference of corner values scaled by the map size). bf16 values:
# 2^-7 for all three (d value accumulates in fp32 and is rounded to bf16 once,
# inside the kernel).
MSDA_BWD_TOL = {torch.float32: (1e-5, 1e-4, 1e-5), torch.bfloat16: (2.0**-7,) * 3}
STEM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,lq,hh,d,ss",
    [(16, 300, 8, 32, ((20, 20), (40, 40), (80, 80))), (2, 37, 3, 8, ((9, 11), (5, 6), (3, 2)))],
    ids=["main-path", "odd"],
)
def test_msda_kernel_matches_plain(cuda, dtype, b, lq, hh, d, ss):
    g = torch.Generator().manual_seed(0)
    s = sum(h * w for h, w in ss)
    v = (torch.rand(b, s, hh, d, generator=g) - 0.5).to(cuda, dtype)
    loc = (torch.rand(b, lq, hh, len(ss), 4, 2, generator=g) * 1.4 - 0.2).to(cuda)
    aw = torch.rand(b, lq, hh, len(ss), 4, generator=g).to(cuda)
    before = msda_forward.launches
    out = msda_forward(v, ss, loc, aw)
    torch.cuda.synchronize()
    assert msda_forward.launches == before + 1
    ref = ms_deform_attn(v.float(), ss, loc, aw)
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref).abs().max()) <= MSDA_TOL[dtype] * float(ref.abs().max())


def _stem_params(device, seed=1):
    g = torch.Generator().manual_seed(seed)
    params = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        params += [
            (torch.randn(3, 3, cin, cout, generator=g) * (2.0 / (9 * cin)) ** 0.5).to(device),
            (1 + 0.1 * torch.randn(cout, generator=g)).to(device),
            (0.1 * torch.randn(cout, generator=g)).to(device),
        ]
    return g, params


def _check_stem(x, params):
    before = fused_resnet_stem.launches
    out = fused_resnet_stem(x, *params)
    torch.cuda.synchronize()
    assert fused_resnet_stem.launches == before + 1
    ref = resnet_stem_reference(x.float(), *params)
    assert out.dtype == x.dtype and out.shape == ref.shape
    assert float((out.float() - ref).abs().max()) <= STEM_TOL[x.dtype] * float(ref.abs().max())
    return ref


# 640²: the main path; 1x1, 2x3: a single pixel / a sub-tile image; 9x17 and
# 97x70: the CPU parity shapes, tiles ragged in both directions; 641x479, B=3:
# odd sizes and several images in the persistent grid; 75x101: 19x26 pooled
# outputs, ragged 8x8 tiles in both directions; inputs x64: activations reach
# ~4e2, so at the f32 tolerance the lo half of every split operand counts
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,scale",
    [(2, 640, 640, 1), (1, 97, 70, 1), (1, 5, 6, 1), (1, 1, 1, 1), (1, 2, 3, 1), (1, 9, 17, 1), (3, 641, 479, 1),
     (2, 75, 101, 1), (2, 131, 67, 64)],
)
def test_stem_kernel_matches_plain(cuda, dtype, b, h, w, scale):
    g, params = _stem_params(cuda)
    _check_stem((torch.randn(b, h, w, 3, generator=g) * scale).to(cuda, dtype), params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stem_kernel_all_negative_pool_windows(cuda, dtype):
    """conv3's bias lowered by 3 on half the channels: on those, most 3x3 pool
    windows are negative throughout before the ReLU, and their output is 0."""
    g, params = _stem_params(cuda, seed=3)
    params[8] = params[8].clone()
    params[8][:32] -= 3.0
    ref = _check_stem(torch.randn(1, 160, 96, 3, generator=g).to(cuda, dtype), params)
    assert float((ref[..., :32] == 0).float().mean()) > 0.5, "too few all-negative windows: the case tests nothing"


def _msda_inputs(device, b, lq, hh, d, ss, dtype=torch.float32, seed=0):
    """Values, locations in [-0.2, 1.2] (some corners outside), softmaxed weights, a gradient."""
    g = torch.Generator().manual_seed(seed)
    s = sum(h * w for h, w in ss)
    v = (torch.rand(b, s, hh, d, generator=g) - 0.5).to(device, dtype)
    loc = (torch.rand(b, lq, hh, len(ss), 4, 2, generator=g) * 1.4 - 0.2).to(device)
    aw = torch.softmax(torch.randn(b, lq, hh, len(ss) * 4, generator=g), -1).reshape(b, lq, hh, len(ss), 4).to(device)
    grad = torch.randn(b, lq, hh * d, generator=g).to(device, dtype)
    return v, loc, aw, grad


def _assert_msda_grads(got, ref, dtype):
    for name, gt, rf, tol in zip(("d value", "d loc", "d aw"), got, ref, MSDA_BWD_TOL[dtype]):
        assert gt.shape == rf.shape, name
        err, bound = float((gt.float() - rf.float()).abs().max()), tol * float(rf.float().abs().max())
        assert err <= bound, f"{name}: {err} > {bound}"


# main path; D=48 (two lane chunks, the second half empty), Lq not a
# multiple of 8, two levels of unequal size; D=16 (half the lanes idle)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,lq,hh,d,ss",
    [(16, 300, 8, 32, ((20, 20), (40, 40), (80, 80))), (8, 300, 8, 32, ((20, 20), (40, 40), (80, 80))),
     (2, 37, 3, 48, ((9, 11), (5, 6))), (3, 13, 2, 16, ((7, 3), (4, 9), (2, 2)))],
    ids=["main-path", "train-batch", "odd-d48", "odd-d16"],
)
def test_msda_backward_kernel_matches_plain(cuda, dtype, b, lq, hh, d, ss):
    v, loc, aw, grad = _msda_inputs(cuda, b, lq, hh, d, ss, dtype)
    before = msda_backward.launches
    got = msda_backward(v, ss, loc, aw, grad)
    torch.cuda.synchronize()
    assert msda_backward.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _assert_msda_grads(got, ms_deform_attn_backward_reference(v.float(), ss, loc, aw, grad.float()), dtype)


def _check_msda_both(v, ss, loc, aw, grad, path):
    """Forward and backward kernels against the plain versions; both took ``path``."""
    f0, b0 = dict(msda_forward.paths), dict(msda_backward.paths)
    out = msda_forward(v, ss, loc, aw)
    got = msda_backward(v, ss, loc, aw, grad)
    torch.cuda.synchronize()
    assert msda_forward.paths[path] == f0[path] + 1 and msda_backward.paths[path] == b0[path] + 1
    ref = ms_deform_attn(v.float(), ss, loc, aw)
    assert out.dtype == v.dtype and out.shape == ref.shape
    assert float((out.float() - ref).abs().max()) <= MSDA_TOL[v.dtype] * float(ref.abs().max())
    _assert_msda_grads(got, ms_deform_attn_backward_reference(v.float(), ss, loc, aw, grad.float()), v.dtype)


# the channel widths of both paths: forward vector for 16/32/64/128-byte
# rows, backward vector for D = 4, 8, 16, 32; D=24 (bf16: 48-byte rows) and
# D=48 take the general path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 48])
def test_msda_kernels_channel_widths(cuda, dtype, d):
    ss = ((9, 11), (5, 6), (3, 2))
    v, loc, aw, grad = _msda_inputs(cuda, 2, 37, 3, d, ss, dtype, seed=d)
    _check_msda_both(v, ss, loc, aw, grad, "vector" if d * v.element_size() in (16, 32, 64, 128) else "general")


# one head; one level; eight levels; one sample a level (a round of eight
# samples spans levels); eight samples a level; B * Hh = 16 below the 132 SMs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,lq,hh,ss,p",
    [(2, 29, 1, ((9, 11), (5, 6)), 4), (2, 29, 4, ((13, 7),), 4),
     (1, 11, 2, tuple((2 + i, 9 - i) for i in range(8)), 4), (2, 23, 3, ((9, 11), (5, 6), (3, 2)), 1),
     (2, 23, 3, ((9, 11), (5, 6)), 8), (2, 300, 8, ((20, 20), (40, 40), (80, 80)), 4)],
    ids=["hh1", "l1", "l8", "p1", "p8", "b2-hh8"],
)
def test_msda_kernels_layouts(cuda, dtype, b, lq, hh, ss, p):
    g = torch.Generator().manual_seed(11)
    v, _, _, grad = _msda_inputs(cuda, b, lq, hh, 32, ss, dtype)
    loc = (torch.rand(b, lq, hh, len(ss), p, 2, generator=g) * 1.4 - 0.2).to(cuda)
    aw = torch.softmax(torch.randn(b, lq, hh, len(ss) * p, generator=g), -1).reshape(b, lq, hh, len(ss), p).to(cuda)
    _check_msda_both(v, ss, loc, aw, grad, "vector")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_msda_kernels_out_of_range_locations(cuda, dtype):
    """Every corner of every sample outside its map (x or y beyond half a
    pixel past the edge, some by 1e6): output and gradients are exactly 0."""
    ss = ((8, 16), (4, 4))
    v, _, aw, grad = _msda_inputs(cuda, 2, 19, 3, 32, ss, dtype)
    g = torch.Generator().manual_seed(12)
    far = torch.rand(2, 19, 3, 2, 4, generator=g) * 3 + 1.5  # [1.5, 4.5): past 1 + 0.5 / size on every level
    far = torch.where(torch.rand(far.shape, generator=g) < 0.5, far, -far)
    far[0, :3] = 1e6
    near = torch.rand(far.shape, generator=g)  # in range on the other axis
    loc = torch.where(torch.rand(far.shape + (1,), generator=g) < 0.5, torch.stack([far, near], -1),
                      torch.stack([near, far], -1)).to(cuda)
    _check_msda_both(v, ss, loc, aw, grad, "vector")
    assert float(msda_forward(v, ss, loc, aw).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_msda_kernels_locations_on_the_edges(cuda, dtype):
    """Locations whose pixel coordinate is exactly -0.5, 0, size - 1 or
    size - 0.5 (maps of power-of-two sizes, so loc * size - 0.5 is exact on
    both sides): one or two corners in, the others out."""
    ss = ((8, 16), (4, 4))
    v, _, aw, grad = _msda_inputs(cuda, 2, 19, 3, 32, ss, dtype)
    g = torch.Generator().manual_seed(13)
    half = 0.5 / torch.tensor([[w, h] for h, w in ss], dtype=torch.float32)  # [L, 2] as (x, y)
    edges = torch.stack([torch.zeros_like(half), half, 1 - half, torch.ones_like(half)], -1)  # [L, 2, 4]
    pick = torch.randint(0, 4, (2, 19, 3, 2, 4, 2, 1), generator=g)
    loc = edges[None, None, None, :, None].expand(2, 19, 3, 2, 4, 2, 4).gather(-1, pick)[..., 0]
    inside = torch.rand(loc.shape, generator=g)
    loc = torch.where(torch.rand(loc.shape, generator=g) < 0.7, loc, inside).to(cuda)
    _check_msda_both(v, ss, loc, aw, grad, "vector")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_msda_kernels_unaligned_value_takes_general_path(cuda, dtype):
    """A contiguous value that starts one element into its buffer is not
    16-byte aligned: both kernels take the general path and still match."""
    ss = ((9, 11), (5, 6), (3, 2))
    v, loc, aw, grad = _msda_inputs(cuda, 2, 37, 3, 32, ss, dtype)
    buf = torch.empty(v.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(v.shape)
    shifted.copy_(v)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    _check_msda_both(shifted, ss, loc, aw, grad, "general")


@pytest.mark.parametrize(
    "b,d,ss,aligned,path",
    [(16, 32, ((20, 20), (40, 40), (80, 80)), True, "vector"), (8, 32, ((20, 20), (40, 40), (80, 80)), True, "vector"),
     (2, 48, ((9, 11), (5, 6)), True, "general"), (2, 32, ((9, 11), (5, 6)), False, "general"),
     (3, 24, ((7, 3), (4, 9)), False, "general")],
    ids=["b16-d32", "b8-d32", "odd-d48", "unaligned-d32", "unaligned-odd-d24"],
)
def test_msda_backward_bf16_d_value_written_in_bf16(cuda, b, d, ss, aligned, path):
    """bf16 values: the kernel takes the bf16 gradient and writes d value in
    bf16 itself (fp32 sums converted in the same launch), on the vector path
    (D=32, B=8 and 16) and the general one (odd D; a value one element into
    its buffer)."""
    v, loc, aw, grad = _msda_inputs(cuda, b, 300 if b >= 8 else 37, 8 if b >= 8 else 3, d, ss, torch.bfloat16)
    if not aligned:
        shifted = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)[1:].view(v.shape)
        v = shifted.copy_(v)
    before = dict(msda_backward.paths)
    got = msda_backward(v, ss, loc, aw, grad)
    torch.cuda.synchronize()
    assert msda_backward.paths[path] == before[path] + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    _assert_msda_grads(got, ms_deform_attn_backward_reference(v.float(), ss, loc, aw, grad.float()), torch.bfloat16)


def test_msda_main_path_shape_takes_vector_path(cuda):
    """fai-detr-l at 640² (B=16, Lq=300, Hh=8, D=32 fp32): both kernels run their vector path."""
    v, loc, aw, grad = _msda_inputs(cuda, 16, 300, 8, 32, ((20, 20), (40, 40), (80, 80)))
    f0, b0 = msda_forward.paths["vector"], msda_backward.paths["vector"]
    msda_forward(v, ((20, 20), (40, 40), (80, 80)), loc, aw)
    msda_backward(v, ((20, 20), (40, 40), (80, 80)), loc, aw, grad)
    assert msda_forward.paths["vector"] == f0 + 1 and msda_backward.paths["vector"] == b0 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_msda_backward_at_a_pixel_edge_matches_plain(cuda, dtype):
    """A location whose pixel coordinate is 8.0 rounded twice and 7.9999995
    rounded once (W=80): the kernels round after the product and after the
    difference, as the plain version does, so both take the cell [8, 9] and
    d loc on a value |x - 8| is that cell's slope on both; the forward is 0
    (tests/test_torch_msda_backward.py holds the plain side against JAX)."""
    w, h, d = 80, 4, 8
    value = torch.from_numpy(np.tile(np.abs(np.arange(w) - 8.0), h).astype(np.float32))
    value = value.reshape(1, h * w, 1, 1).expand(1, h * w, 1, d).contiguous().to(cuda, dtype)
    loc = torch.tensor([0.10624999552965164, 1.5 / h], dtype=torch.float32).reshape(1, 1, 1, 1, 1, 2).to(cuda)
    aw = torch.ones(1, 1, 1, 1, 1, device=cuda)
    grad = torch.ones(1, 1, d, device=cuda, dtype=dtype)
    _, d_loc, _ = msda_backward(value, [(h, w)], loc, aw, grad)
    _, ref, _ = ms_deform_attn_backward_reference(value.float(), [(h, w)], loc, aw, grad.float())
    assert float(ref[..., 0]) == w * d
    torch.testing.assert_close(d_loc.float(), ref, rtol=0, atol=1e-3 * w * d)
    out = msda_forward(value, [(h, w)], loc, aw)
    torch.testing.assert_close(out.float(), ms_deform_attn(value.float(), [(h, w)], loc, aw), rtol=0, atol=1e-6)


def test_msda_backward_kernel_finite_differences(cuda):
    """d loc and d aw against central differences of the forward kernel, fp32
    (the kernels take no fp64). Pixel coordinates keep a fraction in [0.1, 0.9]
    (one corner row or column may lie outside the map), so a step of 1e-3 in
    normalized units never crosses a pixel: the sampled value is linear in
    each coordinate there and the differences are exact up to fp32 rounding of
    the O(1) outputs (~1e-4 relative at this step), hence 5e-3 x max|ref|."""
    b, lq, hh, d, ss = 2, 5, 2, 32, ((6, 7), (3, 4))
    g = torch.Generator().manual_seed(7)
    v, _, _, grad = _msda_inputs(cuda, b, lq, hh, d, ss, seed=7)
    sizes = torch.tensor([[w, h] for h, w in ss], dtype=torch.float32)[:, None, :]  # [L, 1, 2] as (W, H)
    pix = torch.floor(torch.rand(b, lq, hh, len(ss), 4, 2, generator=g) * (sizes + 1)) - 1
    pix = pix + 0.1 + 0.8 * torch.rand(pix.shape, generator=g)
    loc = ((pix + 0.5) / sizes).to(cuda)
    aw = torch.rand(b, lq, hh, len(ss), 4, generator=g).to(cuda)
    _, d_loc, d_aw = msda_backward(v, ss, loc, aw, grad)

    def per_warp(lc, a):  # sum_d g * out for each (b, q, h)
        return (msda_forward(v, ss, lc, a) * grad).reshape(b, lq, hh, d).sum(-1)

    step = 1e-3
    fd_loc, fd_aw = torch.zeros_like(d_loc), torch.zeros_like(d_aw)
    for lvl in range(len(ss)):
        for p in range(4):
            for c in range(2):
                e = torch.zeros_like(loc)
                e[:, :, :, lvl, p, c] = step
                fd_loc[:, :, :, lvl, p, c] = (per_warp(loc + e, aw) - per_warp(loc - e, aw)) / (2 * step)
            e = torch.zeros_like(aw)
            e[:, :, :, lvl, p] = step
            fd_aw[:, :, :, lvl, p] = (per_warp(loc, aw + e) - per_warp(loc, aw - e)) / (2 * step)
    for name, got, ref in (("d loc", d_loc, fd_loc), ("d aw", d_aw, fd_aw)):
        err, bound = float((got - ref).abs().max()), 5e-3 * float(ref.abs().max())
        assert err <= bound, f"{name}: {err} > {bound}"


def test_msda_autograd_launches_both_kernels(cuda):
    """Autograd through msda_forward on the card launches the forward kernel,
    and backward() the backward kernel; no_grad runs the forward alone."""
    ss = ((9, 11), (5, 6), (3, 2))
    v, loc, aw, grad = _msda_inputs(cuda, 2, 37, 3, 32, ss)
    leaves = [t.clone().requires_grad_() for t in (v, loc, aw)]
    f0, b0 = msda_forward.launches, msda_backward.launches
    out = msda_forward(leaves[0], ss, leaves[1], leaves[2])
    assert msda_forward.launches == f0 + 1 and out.grad_fn is not None
    out.backward(grad)
    torch.cuda.synchronize()
    assert msda_backward.launches == b0 + 1
    _assert_msda_grads([t.grad for t in leaves], ms_deform_attn_backward_reference(v, ss, loc, aw, grad),
                       torch.float32)
    with torch.no_grad():
        assert msda_forward(leaves[0], ss, leaves[1], leaves[2]).grad_fn is None
    assert msda_forward.launches == f0 + 2 and msda_backward.launches == b0 + 1


def test_wrappers_refuse_autograd(cuda):
    """The stem stays inference-only: a weight that needs a gradient is refused."""
    _, params = _stem_params(cuda)
    params[3].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fused_resnet_stem(torch.zeros(1, 8, 8, 3, device=cuda), *params)


def test_slice_launches_each_kernel(cuda):
    from focoos_tpu_torch import ModelManager

    model = ModelManager.get(
        "fai-detr-l-coco", device=cuda, image_size=64, num_queries=10, transformer_predictor_dec_layers=2,
    )
    msda0, stem0 = msda_forward.launches, fused_resnet_stem.launches
    res = model.infer(np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8), threshold=0.0)
    assert msda_forward.launches - msda0 == 2 and fused_resnet_stem.launches - stem0 == 1
    assert len(res) == 300


@pytest.mark.parametrize("name", ["fai-detr-l-coco", "rtmo-s-coco"])
def test_model_manager_bf16_forward(cuda, name):
    """ModelManager.get(dtype="bfloat16") on the card: fp32 parameters, fp32
    and finite outputs, the family's kernels launched."""
    from focoos_tpu_torch import ModelManager

    kw = dict(num_queries=10, transformer_predictor_dec_layers=2) if name.startswith("fai") else {}
    model = ModelManager.get(name, device=cuda, image_size=64, dtype="bfloat16", **kw)
    assert model.compute_dtype == "bfloat16" and all(p.dtype == torch.float32 for p in model.module.parameters())
    counts = (msda_forward.launches, fused_resnet_stem.launches, nms_keep.launches)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    out = model.forward(x)
    torch.cuda.synchronize()
    for field, t in vars(out).items():
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            assert t.dtype == torch.float32 and bool(torch.isfinite(t).all()), field
    launched = [a - b for a, b in zip((msda_forward.launches, fused_resnet_stem.launches, nms_keep.launches), counts)]
    assert launched == ([2, 1, 0] if name.startswith("fai") else [0, 0, 1])


def clustered_boxes(g: torch.Generator, b: int, k: int):
    """[B, K, 4] xyxy boxes around K/8 centres (many overlap) with exact
    duplicates, zero-area boxes, and descending scores with a zero tail."""
    centres = torch.rand(b, k // 8 + 1, 2, generator=g) * 600
    pick = torch.randint(0, centres.shape[1], (b, k), generator=g)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) + torch.randn(b, k, 2, generator=g) * 8
    boxes = torch.cat([xy, xy + torch.rand(b, k, 2, generator=g) * 80 + 20], -1)
    boxes[:, 5:9] = boxes[:, 1:5]
    boxes[:, 10:12, 2:] = boxes[:, 10:12, :2]
    scores = torch.sort(torch.rand(b, k, generator=g) * 0.95 + 0.05, -1, descending=True).values
    scores[:, k - k // 6:] = 0
    return boxes, scores


HALF = np.float32(0.5)


def _exact_iou_pairs(boxes: torch.Tensor, at=(0, 31, 100)) -> None:
    """Pairs whose IoU is exactly 0.5 ([0, 0, 2, 1] and [0, 0, 1, 1]), far from
    every other box, at rows s, s+1 (the second pair across a 32-box word)."""
    for p, s in enumerate(at):
        if s + 1 < boxes.shape[1]:
            o = 10000.0 + 100.0 * p
            boxes[:, s] = torch.tensor([o, o, o + 2, o + 1])
            boxes[:, s + 1] = torch.tensor([o, o, o + 1, o + 1])


def _nms_case(kind: str, b: int, k: int):
    boxes, scores = clustered_boxes(torch.Generator().manual_seed(k), b, k)
    if kind == "exact":
        scores = torch.sort(torch.rand(b, k, generator=torch.Generator().manual_seed(1)) + 0.05, -1, descending=True).values
        _exact_iou_pairs(boxes)
    elif kind == "identical":
        boxes = boxes[:, :1].expand(-1, k, -1).clone()
        scores = torch.linspace(1.0, 0.05, k).expand(b, -1).clone()
    elif kind == "disjoint":
        x = torch.arange(k, dtype=torch.float32)[None, :].expand(b, -1) * 10
        boxes = torch.stack([x, x, x + 5, x + 5], -1)
    return boxes, scores


@pytest.mark.parametrize(
    "kind,b,k,thr",
    [
        ("clustered", 16, 300, 0.65), ("clustered", 3, 1024, 0.5), ("clustered", 2, 37, 0.65),
        ("clustered", 1, 300, 0.65), ("clustered", 2, 1, 0.65), ("clustered", 2, 31, 0.65),
        ("clustered", 2, 32, 0.65), ("clustered", 2, 33, 0.65), ("clustered", 2, 1000, 0.65),
        ("clustered", 2, 1024, 0.65),
        ("exact", 2, 300, float(HALF)), ("exact", 2, 300, float(np.nextafter(HALF, np.float32(0)))),
        ("exact", 2, 300, float(np.nextafter(HALF, np.float32(1)))),
        ("identical", 2, 300, 0.65), ("disjoint", 2, 300, 0.65), ("clustered", 2, 300, -0.5),
    ],
    ids=["main-path", "k1024", "odd", "b1", "k1", "k31", "k32", "k33", "k1000", "k1024-thr0.65",
         "iou-at-thr", "iou-above-thr-by-1ulp", "iou-below-thr-by-1ulp", "identical", "disjoint", "negative-thr"],
)
def test_nms_kernel_matches_plain(cuda, kind, b, k, thr):
    """Keep masks equal the plain version's bit for bit: the main path's
    shapes, K on both sides of a 32-box word and up to MAX_K, IoUs exactly at
    the threshold and one ulp either side, one box repeated, disjoint boxes
    and a negative threshold."""
    boxes, scores = _nms_case(kind, b, k)
    boxes, scores = boxes.to(cuda).contiguous(), scores.to(cuda).contiguous()
    before = nms_keep.launches
    keep = nms_keep(boxes, scores, thr)
    torch.cuda.synchronize()
    assert nms_keep.launches == before + 1
    ref = nms_keep_reference(boxes, scores, thr)
    assert keep.dtype == torch.bool and keep.shape == (b, k)
    assert torch.equal(keep, ref)
    valid = int((scores > 0).sum())
    if kind == "exact":  # the second box of a pair falls only where its IoU 0.5 is above the threshold
        assert bool(keep[:, 1].all()) == (thr >= 0.5) and bool(keep[:, 32].all()) == (thr >= 0.5)
    elif kind == "identical":
        assert keep.sum(1).tolist() == [1] * b
    elif kind == "disjoint":
        assert int(keep.sum()) == valid
    elif k >= 37:
        assert int(keep.sum()) < valid, "nothing was suppressed: the case tests nothing"


def test_nms_kernel_non_finite_boxes_match_plain(cuda):
    boxes, scores = clustered_boxes(torch.Generator().manual_seed(3), 1, 64)
    boxes[0, 2] = torch.tensor([float("nan"), 10.0, 50.0, 60.0])
    boxes[0, 3, 2:] = float("inf")
    boxes[0, 20:22] = boxes[0, 2:4]
    boxes[0, 30] = torch.tensor([-float("inf"), -float("inf"), float("inf"), float("inf")])
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    assert torch.equal(nms_keep(boxes, scores, 0.65), nms_keep_reference(boxes, scores, 0.65))


def test_nms_kernel_refuses_large_k(cuda):
    with pytest.raises(ValueError):
        nms_keep(torch.zeros(1, 1025, 4, device=cuda), torch.ones(1, 1025, device=cuda))


def test_rtmo_slice_launches_nms_once_per_forward(cuda):
    from focoos_tpu_torch import ModelManager

    model = ModelManager.get("rtmo-s-coco", device=cuda, image_size=128, nms_pre_topk=50, max_detections=10)
    before = nms_keep.launches
    res = model(np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8), threshold=0.0)
    assert nms_keep.launches - before == 1
    assert len(res) == 2 and all(len(d.keypoints) == 17 for r in res for d in r.detections)


def test_train_step_launches_both_msda_kernels(cuda, tmp_path):
    """FocoosModel.train on the card: each decoder layer launches the MSDA
    forward kernel, and its backward the MSDA backward kernel, once per step."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
    from focoos_tpu_torch.structures import Boxes, Instances

    model = ModelManager.get(
        "fai-detr-l-coco", device=cuda, image_size=64, num_queries=10, transformer_predictor_dec_layers=2,
    )
    rng = np.random.default_rng(0)
    boxes = np.array([[4, 6, 30, 40], [20, 10, 60, 50]], np.float32)
    ds = [DatasetEntry(image=rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), height=64, width=64,
                       instances=Instances((64, 64), boxes=Boxes(boxes), classes=np.array([3, 7]))) for _ in range(2)]
    f0, b0 = msda_forward.launches, msda_backward.launches
    args = TrainerArgs(run_name="t", output_dir=str(tmp_path), batch_size=2, max_iters=2, checkpointer_period=2,
                       workers_timeout=120)
    res = model.train(args, ds)
    torch.cuda.synchronize()
    assert res["iterations"] == 2
    assert msda_forward.launches - f0 == 4 and msda_backward.launches - b0 == 4


def _entries(images, gts):
    from focoos_tpu_torch.ports import DatasetEntry
    from focoos_tpu_torch.structures import Boxes, Instances

    return [DatasetEntry(image=im, height=im.shape[0], width=im.shape[1],
                         instances=Instances(im.shape[:2], boxes=Boxes(b), classes=np.asarray(c, np.int64)))
            for im, (b, c) in zip(images, gts)]


def test_evaluate_dataset_on_the_card_matches_the_cpu(cuda):
    """evaluate_dataset on the card, against pseudo-GT that is the same
    weights' CPU detections (the top 15 of the 3 images together, the cut
    moved past score gaps under 1e-4): AP 99 or more, with the stem and MSDA
    kernels launched once and twice a batch; the CPU's own evaluation of the
    same entries scores within 1 AP point of the card's."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

    kw = dict(image_size=64, num_queries=10, transformer_predictor_dec_layers=2)
    gpu = ModelManager.get("fai-detr-l-coco", device=cuda, seed=1, **kw)
    cpu = ModelManager.get("fai-detr-l-coco", device="cpu", init_weights=False, **kw)
    cpu.module.load_state_dict(gpu.module.state_dict())
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(3)]
    blank = _entries(images, [(np.zeros((0, 4), np.float32), np.zeros(0))] * 3)
    with torch.inference_mode():
        dets = cpu.processor.eval_postprocess(cpu.forward(np.stack(images)), blank)
    scores = np.concatenate([np.asarray(d["instances"].scores) for d in dets])
    order = np.argsort(-scores, kind="stable")
    cut = 15
    while cut < len(order) and scores[order[cut - 1]] - scores[order[cut]] < 1e-4:
        cut += 1
    top = set(order[:cut].tolist())
    gts, start = [], 0
    for d in dets:
        inst = d["instances"]
        sel = [i for i in range(len(inst)) if start + i in top]
        gts.append((inst.boxes.tensor[sel], np.asarray(inst.classes)[sel]))
        start += len(inst)
    entries = _entries(images, gts)
    f0, s0 = msda_forward.launches, fused_resnet_stem.launches
    res = evaluate_dataset(gpu, entries, batch_size=2)["bbox"]
    assert fused_resnet_stem.launches - s0 == 2 and msda_forward.launches - f0 == 4
    ref = evaluate_dataset(cpu, entries, batch_size=2)["bbox"]
    assert res["AP"] >= 99.0 and abs(res["AP"] - ref["AP"]) <= 1.0, (res, ref)


def test_resume_on_the_card(cuda, tmp_path):
    """Two steps with a checkpoint each, then a trainer with resume=True to
    three: it starts at iteration 2, and what Checkpointer.load puts on the
    card equals the saved state bit for bit; the run ends with finite weights."""
    import os

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
    from focoos_tpu_torch.structures import Boxes, Instances
    from focoos_tpu_torch.trainer.checkpointer import Checkpointer
    from focoos_tpu_torch.trainer.solver import Solver
    from focoos_tpu_torch.trainer.train_step import create_train_state
    from focoos_tpu_torch.trainer.trainer import FocoosTrainer

    model = ModelManager.get("fai-detr-l-coco", device=cuda, image_size=64, num_queries=10,
                             transformer_predictor_dec_layers=2)
    rng = np.random.default_rng(0)
    boxes = np.array([[4, 6, 30, 40], [20, 10, 60, 50]], np.float32)
    ds = [DatasetEntry(image=rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), height=64, width=64,
                       instances=Instances((64, 64), boxes=Boxes(boxes), classes=np.array([3, 7]))) for _ in range(2)]
    ckpt = str(tmp_path / "ckpt")

    def args(iters, **kw):
        return TrainerArgs(run_name="r", output_dir=str(tmp_path), batch_size=2, max_iters=iters, checkpointer_period=1,
                           ckpt_dir=ckpt, ema_enabled=True, workers_timeout=120, **kw)

    model.train(args(2), ds)
    saved = torch.load(os.path.join(ckpt, "model_final", "state.pt"), map_location="cpu", weights_only=True)
    state = create_train_state(model.module, Solver(model.module, args(3)), ema_enabled=True)
    Checkpointer(state, ckpt).load("model_final")
    loaded = state.state_dict()
    assert loaded["step"] == saved["step"] == 2
    for k, v in saved["module"].items():
        assert loaded["module"][k].is_cuda and torch.equal(loaded["module"][k].cpu(), v), k
    for a, b in zip(loaded["ema"], saved["ema"], strict=True):
        assert torch.equal(a.cpu(), b)
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(loaded["optimizer"]["state"][i][k]).cpu(), torch.as_tensor(v)), (i, k)
    b0 = msda_backward.launches
    trainer = FocoosTrainer(model, args(3, resume=True), ds)
    res = trainer.train()
    torch.cuda.synchronize()
    assert trainer.loop.start_iter == 2 and res["iterations"] == 3 and msda_backward.launches - b0 == 2
    assert all(bool(torch.isfinite(p).all()) for p in model.module.parameters())


# --------------------------------------------------------------------------- fai-detr-m and the data pipeline
M_TINY = dict(image_size=96, num_queries=20, transformer_predictor_dec_layers=3, num_classes=3)


def test_fai_detr_m_forward_matches_the_cpu(cuda):
    """fai-detr-m (STDC, no AIFI layer) on the card against the same weights
    on the CPU, on the CPU's query selection: every aux output to 1e-3
    (fp32 both sides, TF32 off), the MSDA kernel once per decoder layer."""
    from focoos_tpu_torch import ModelManager

    gpu = ModelManager.get("fai-detr-m-coco", device=cuda, seed=2, **M_TINY)
    cpu = ModelManager.get("fai-detr-m-coco", device="cpu", init_weights=False, **M_TINY)
    cpu.module.load_state_dict(gpu.module.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8))
    pred = gpu.module.predictor
    with torch.inference_mode():
        _, ref = cpu.module(x)
        cp = cpu.module.predictor
        idx = cp.select_queries(*cp.flatten_levels(cpu.module.encode(x)))[0]
        real = type(pred).select_queries
        pred.select_queries = lambda memory, ss: real(pred, memory, ss, idx.to(memory.device))
        try:
            before = msda_forward.launches
            _, got = gpu.module(x.to(cuda))
            torch.cuda.synchronize()
        finally:
            del pred.select_queries
    assert msda_forward.launches - before == 3
    for field in ("dec_logits", "dec_boxes", "enc_logits", "enc_boxes"):
        torch.testing.assert_close(getattr(got, field).cpu(), getattr(ref, field), rtol=0, atol=1e-3)


def test_stdc_stride2_block_gradients_match_the_cpu(cuda):
    """A stride-2 STDC cat block in train mode on a channels-last input (the
    layout the model hands it), card against the CPU in fp64: the input's
    and every parameter's gradient to 1e-5 x max|ref|. Its pooled branch
    goes through _avg_pool_3x3_s2: the card's channels-last avg_pool2d
    backward alone returns wrong input gradients."""
    from focoos_tpu_torch.nn.backbone.stdc import CatBottleneck
    from focoos_tpu_torch.nn.layers.common import set_compute_dtype

    g = torch.Generator().manual_seed(0)
    cpu = CatBottleneck(32, 64, 4, stride=2).double().train()
    set_compute_dtype(cpu, torch.float64)
    for p in cpu.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64) * 0.3 + (1.0 if p.dim() == 1 else 0.0))
    gpu = CatBottleneck(32, 64, 4, stride=2).train().to(cuda)
    gpu.load_state_dict({k: v.float() for k, v in cpu.state_dict().items()})
    x = torch.randn(2, 32, 41, 37, generator=g, dtype=torch.float64)
    dy = torch.randn(2, 64, 21, 19, generator=g, dtype=torch.float64)
    xr = x.clone().requires_grad_()
    cpu(xr).backward(dy)
    xc = x.float().to(cuda).contiguous(memory_format=torch.channels_last).requires_grad_()
    gpu(xc).backward(dy.float().to(cuda).contiguous(memory_format=torch.channels_last))
    pairs = [("input", xc.grad, xr.grad)] + [(n, p.grad, dict(cpu.named_parameters())[n].grad)
                                              for n, p in gpu.named_parameters()]
    for name, got, ref in pairs:
        torch.testing.assert_close(got.double().cpu(), ref, rtol=0, atol=1e-5 * float(ref.abs().max()), msg=name)


def _shapes_split(tmp_path, split: str):
    """A seeded 96² Roboflow-COCO dataset's split through AutoDataset, with
    96² square augmentations (no resize: the mapper needs cv2 only)."""
    import os
    import sys

    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import DatasetAugmentations

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
    from make_synthetic_dataset import make

    root = str(tmp_path / "shapes")
    if not os.path.isdir(root):
        make(root, n_train=4, n_val=2, size=96, seed=0)
    augs = DatasetAugmentations(resolution=96, square=1.0, horizontal_flip=0.5)
    return AutoDataset(root, task="detection").get_split(augs, split=split)


def test_loader_workers_feed_the_card_with_pinned_batches(cuda, tmp_path):
    """Two worker processes map records from disk beside a process that holds
    the card: pinned uint8 batches that copy to the card and go through a
    fai-detr-m forward."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.data.loaders import build_train_loader

    model = ModelManager.get("fai-detr-m-coco", device=cuda, **M_TINY)
    ds = _shapes_split(tmp_path, "train")
    loader = build_train_loader(ds, model.processor.train(True), 2, num_workers=2, pin_memory=True, timeout=120)
    try:
        for _ in range(3):
            images, targets = next(loader)
            assert images.is_pinned() and images.dtype == torch.uint8 and images.shape == (2, 96, 96, 3)
            assert bool(targets.valid.any())
            with torch.inference_mode():
                out = model.forward(images.to(cuda, non_blocking=True))
            assert bool(torch.isfinite(out.boxes).all())
    finally:
        loader.close()
        model.processor.train(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fai_detr_m_train_step_on_the_card(cuda, tmp_path, dtype):
    """FocoosModel.train of fai-detr-m from a dataset on disk, two loader
    workers, two steps: finite losses, both MSDA kernels once per decoder
    layer and step, fp32 parameters."""
    import json
    import os

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ports import TrainerArgs

    model = ModelManager.get("fai-detr-m-coco", device=cuda, dtype=dtype, **M_TINY)
    f0, b0 = msda_forward.launches, msda_backward.launches
    args = TrainerArgs(run_name="m", output_dir=str(tmp_path), batch_size=2, max_iters=2, workers=2, workers_timeout=120,
                       checkpointer_period=2, log_period=1)
    res = model.train(args, _shapes_split(tmp_path, "train"))
    torch.cuda.synchronize()
    assert res["iterations"] == 2
    assert msda_forward.launches - f0 == 6 and msda_backward.launches - b0 == 6
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if "loss" in k)
    assert all(p.dtype == torch.float32 for p in model.module.parameters())


# --------------------------------------------------------------------------- fai_mf
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 8])
def test_stem_kernel_at_1024_matches_plain(cuda, dtype, b):
    """fai-mf-l-coco-ins's stem input: 1024², 256x256 pooled outputs an image."""
    g, params = _stem_params(cuda, seed=5)
    _check_stem(torch.randn(b, 1024, 1024, 3, generator=g).to(cuda, dtype), params)


def test_device_mask_iou_on_the_card_equals_the_library(cuda):
    """The IoU of packed masks on the card equals native.mask_iou bit for bit
    at 1024² (2^20 pixels: the fp32 counts stay exact), crowds included."""
    from focoos_tpu_torch.ops.mask_iou import device_mask_iou_packed_batch
    from focoos_tpu_torch.utils import native

    assert native.available()
    rng = np.random.default_rng(7)
    h = w = 1024
    dt = rng.random((2, 40, h, w)) > 0.7
    gts = [list(rng.random((5, h, w)) > 0.6), list(rng.random((3, h, w)) > 0.2)]
    crowds = [np.array([0, 1, 0, 0, 1]), np.array([0, 0, 1])]
    packed = torch.from_numpy(np.packbits(dt.reshape(2, 40, -1), axis=-1)).to(cuda)
    got = device_mask_iou_packed_batch(list(packed), (h, w), gts, gt_crowds=crowds)
    for i in range(2):
        assert np.array_equal(got[i], native.mask_iou(list(dt[i]), gts[i], crowds[i]))


def test_fai_mf_decodes_on_the_card_match_the_cpu(cuda):
    """The instance decode (scores 1e-5; labels, packed bits and boxes equal)
    and the semantic label map (equal) on the card against the CPU, on
    probabilities away from the threshold and from ties."""
    from focoos_tpu_torch.models.fai_mf.processor import _device_instance_decode, _device_semantic_argmax

    rng = np.random.default_rng(8)
    logits = torch.from_numpy(rng.dirichlet(np.ones(12), (2, 20))[..., :11].astype(np.float32))
    masks = rng.random((2, 20, 96, 80)).astype(np.float32)
    masks = torch.from_numpy(np.where(np.abs(masks - 0.5) < 1e-3, 0.9, masks).astype(np.float32))
    ref = _device_instance_decode(logits, masks, 50, 0.5)
    got = _device_instance_decode(logits.to(cuda), masks.to(cuda), 50, 0.5)
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=1e-5, atol=0)
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g.cpu(), r)
    assert torch.equal(_device_semantic_argmax(logits.to(cuda), masks.to(cuda)).cpu(),
                       _device_semantic_argmax(logits, masks))


@pytest.mark.parametrize("card", ["fai-mf-s-coco-ins", "fai-mf-l-ade"])
def test_fai_mf_forward_on_the_card_matches_the_cpu(cuda, card):
    """A tiny fai_mf on the card against the same weights on the CPU, on the
    CPU's attention masks: class and mask probabilities to 1e-3 (fp32 both
    sides, TF32 off), the stem kernel once a forward; then evaluate_dataset
    on the card leaves the instance masks packed on the card."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.stem import fused_resnet_stem as stem
    from focoos_tpu_torch.ports import DatasetEntry
    from focoos_tpu_torch.structures import BitMasks, Instances
    from focoos_tpu_torch.trainer import evaluation

    kw = dict(num_queries=10, transformer_predictor_dec_layers=2, num_classes=3)
    gpu = ModelManager.get(card, device=cuda, seed=3, **kw)
    cpu = ModelManager.get(card, device="cpu", init_weights=False, **kw)
    cpu.module.load_state_dict(gpu.module.state_dict())
    imgs = np.random.default_rng(9).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    with torch.inference_mode():
        ref, raux = cpu.module(x)
        before = stem.launches
        got, _ = gpu.module(x.to(cuda), allowed=[a.to(cuda) for a in raux.allowed])
        torch.cuda.synchronize()
    assert stem.launches - before == 1
    torch.testing.assert_close(got.logits.cpu(), ref.logits, rtol=0, atol=1e-3)
    torch.testing.assert_close(got.masks.cpu(), ref.masks, rtol=0, atol=1e-3)
    masks = BitMasks(np.random.default_rng(10).random((2, 96, 96)) > 0.5)
    entries = [DatasetEntry(image=img, height=96, width=96, sem_seg=np.zeros((96, 96), np.uint8),
                            instances=Instances((96, 96), boxes=masks.get_bounding_boxes(), classes=np.array([0, 1]),
                                                masks=masks)) for img in imgs]
    seen = []
    real = evaluation._to_host
    evaluation._to_host = lambda out, device: (seen.append(out), real(out, device))[1]
    try:
        res = evaluation.evaluate_dataset(gpu, entries, batch_size=2)
    finally:
        evaluation._to_host = real
    assert len(seen) == 1 and ("segm" in res if card.endswith("-ins") else "sem_seg" in res)
    if card.endswith("-ins"):
        assert seen[0].packed is None and seen[0].packed_on_device.is_cuda
        assert evaluation.stats["host_bytes"] == sum(t.numel() * t.element_size()
                                                     for t in (seen[0].scores, seen[0].labels, seen[0].boxes))


# --------------------------------------------------------------------------- mask-classification training
def test_point_sample_on_the_card_matches_the_cpu(cuda):
    """point_sample at the criterion's shapes (12544 points, 3x oversampled
    for the pick) and one point set shared by every query, card against the
    CPU on the same points: 1e-6 abs."""
    from focoos_tpu_torch.ops.point_sample import point_sample

    g = torch.Generator().manual_seed(11)
    maps = torch.randn(64, 256, 256, generator=g) * 3
    coords = torch.rand(64, 3 * 12544, 2, generator=g) * 1.2 - 0.1
    torch.testing.assert_close(point_sample(maps.to(cuda), coords.to(cuda)).cpu(), point_sample(maps, coords),
                               rtol=0, atol=1e-6)
    shared = torch.rand(2, 1, 12544, 2, generator=g)
    stack = maps.reshape(2, 32, 256, 256)
    torch.testing.assert_close(point_sample(stack.to(cuda), shared.to(cuda)).cpu(), point_sample(stack, shared),
                               rtol=0, atol=1e-6)


def test_mask_criterion_on_the_card_matches_the_cpu(cuda):
    """maskformer_criterion on random predictions of 3 layers x 2 images x 100
    queries at 64x64: the card's matcher on the CPU's points gives the CPU's
    assignment; on the CPU's points and assignment every loss key is within
    1e-5 rel and the gradient of the total within 1e-5 x its max."""
    from focoos_tpu_torch.models.fai_mf.config import MaskFormerConfig
    from focoos_tpu_torch.models.fai_mf.loss import match, maskformer_criterion
    from focoos_tpu_torch.models.fai_mf.ports import MaskFormerAuxOutputs, MaskFormerTargets

    g = torch.Generator().manual_seed(12)
    cfg = MaskFormerConfig(num_classes=20)
    logits = torch.randn(3, 2, 100, 21, generator=g) * 2
    masks = torch.randn(3, 2, 100, 64, 64, generator=g) * 3
    n = 12
    valid = torch.arange(n)[None] < torch.tensor([[7], [12]])
    tmasks = (torch.rand(2, n, 64, 64, generator=g) > 0.7).float() * valid[..., None, None]
    targets = MaskFormerTargets(torch.randint(0, 20, (2, n), generator=g) * valid, tmasks, valid)
    runs = {}
    for dev in ("cpu", cuda):
        lg, mk = logits.clone().to(dev).requires_grad_(), masks.clone().to(dev).requires_grad_()
        carried = None if dev == "cpu" else runs["cpu"][1]
        losses, used = maskformer_criterion(MaskFormerAuxOutputs(lg, mk), targets.to(dev), cfg,
                                            torch.Generator().manual_seed(0), carried=carried and carried.to(dev))
        losses["total"].backward()
        runs["cpu" if dev == "cpu" else "card"] = ({k: float(v) for k, v in losses.items()}, used, lg.grad.cpu(),
                                                   mk.grad.cpu())
    cpu, card = runs["cpu"], runs["card"]
    own = match(MaskFormerAuxOutputs(logits.to(cuda), masks.to(cuda)), targets.to(cuda), cfg,
                cpu[1].match_coords.to(cuda)).cpu()
    assert torch.equal(own[:, valid], cpu[1].assign[:, valid])
    for k, v in cpu[0].items():
        assert abs(card[0][k] - v) <= 1e-5 * abs(v), (k, card[0][k], v)
    for got, ref in zip(card[2:], cpu[2:]):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_fai_mf_stem_runs_in_eval_and_not_in_train(cuda):
    """A ResNet-D fai_mf card launches the stem kernel once an eval forward
    and never in a train-mode forward (the stem wrapper refuses autograd:
    training takes the plain convs), whose loss backpropagates."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.models.fai_mf.loss import make_loss_fn
    from focoos_tpu_torch.models.fai_mf.ports import MaskFormerTargets
    from focoos_tpu_torch.ops.stem import fused_resnet_stem as stem

    model = ModelManager.get("fai-mf-s-coco-ins", device=cuda, num_queries=10, transformer_predictor_dec_layers=2,
                             num_classes=3, criterion_num_points=256)
    x = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(cuda)
    before = stem.launches
    with torch.inference_mode():
        model.module.eval()(x)
    torch.cuda.synchronize()
    assert stem.launches == before + 1
    valid = torch.tensor([[True, False], [True, True]])
    targets = MaskFormerTargets(torch.tensor([[1, 0], [2, 0]]), (torch.rand(2, 2, 32, 32) > 0.5).float(), valid)
    model.module.train()
    total, losses = make_loss_fn(model.module, model.config)(x, targets.to(cuda))
    total.backward()
    torch.cuda.synchronize()
    model.module.eval()
    assert stem.launches == before + 1 and torch.isfinite(total)
    assert all(p.grad is not None for p in model.module.pixel_decoder.backbone.conv1.parameters())


def test_fai_cls_forward_and_step_on_the_card_match_the_cpu(cuda):
    """fai-cls-n at 96² (3 classes): the eval forward's logits to 1e-4 x
    max|ref| (fp32 both sides, TF32 off); one train step on one dropout mask
    carried from the CPU: the loss to 1e-5 rel, every gradient to 1e-3 x its
    max |ref| (train-mode BatchNorms sum in another order), and no kernel of
    the port launched (STDC has no ResNet-D stem)."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.models.fai_cls.loss import classification_loss
    from focoos_tpu_torch.models.fai_cls.ports import ClassificationTargets

    gpu = ModelManager.get("fai-cls-n-coco", device=cuda, num_classes=3, image_size=96, seed=3)
    cpu = ModelManager.get("fai-cls-n-coco", device="cpu", num_classes=3, image_size=96, init_weights=False)
    cpu.module.load_state_dict(gpu.module.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8))
    with torch.inference_mode():
        ref = cpu.module(x)[0].logits
        got = gpu.module(x.to(cuda))[0].logits.cpu()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    feats = gpu.module.backbone.output_shape()[gpu.config.features].channels
    keep = torch.rand(2, feats, 1, 1, generator=torch.Generator().manual_seed(0)) < 0.8
    targets = ClassificationTargets(torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]]))
    before = (fused_resnet_stem.launches, msda_forward.launches, nms_keep.launches)
    runs = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        m.module.train()
        loss = classification_loss(m.module(x.to(dev), keep=keep.to(dev))[0].logits, targets.to(dev), m.config)["loss_cls"]
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad.cpu() for n, p in m.module.named_parameters() if p.grad is not None}))
        m.module.eval()
    assert (fused_resnet_stem.launches, msda_forward.launches, nms_keep.launches) == before
    assert abs(runs[1][0] - runs[0][0]) <= 1e-5 * abs(runs[0][0])
    assert sorted(runs[1][1]) == sorted(runs[0][1])
    for n, r in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][n], r, rtol=0, atol=1e-3 * float(r.abs().max()) + 1e-9, msg=n)


def test_fai_cls_bf16_forward_keeps_fp32_logits(cuda):
    """A bf16 fai-cls-m forward: fp32 logits, within 5e-2 of the fp32 model's
    sigmoid probabilities."""
    from focoos_tpu_torch import ModelManager

    m32 = ModelManager.get("fai-cls-m-coco", device=cuda, seed=4)
    m16 = ModelManager.get("fai-cls-m-coco", device=cuda, dtype="bfloat16", init_weights=False)
    m16.module.load_state_dict(m32.module.state_dict())
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)).to(cuda)
    with torch.inference_mode():
        l32, l16 = m32.module(x)[0].logits, m16.module(x)[0].logits
    assert l16.dtype == l32.dtype == torch.float32 and l16.shape == (2, 80)
    assert float((torch.sigmoid(l16) - torch.sigmoid(l32)).abs().max()) <= 5e-2


def test_rtmo_simota_and_criterion_on_the_card_match_the_cpu(cuda):
    """rtmo-s's SimOTA over [2, 2000 priors (its 640² grid at strides 16 and
    32), 10 people] on the card gives the CPU's assignment; on the CPU's assignment the criterion's
    losses are within 1e-5 rel and the gradients of the raw outputs within
    1e-4 x their max; DCC's batch statistics, recovered from its running
    mean and variance, agree: the mean within 1e-5 of its batch std, the
    variance within 1e-5 rel."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.models.rtmo.loss import rtmo_criterion
    from focoos_tpu_torch.models.rtmo.ports import KeypointTargets, RTMOAuxOutputs

    gpu = ModelManager.get("rtmo-s-coco", device=cuda, seed=5)
    dcc = gpu.module.head["dcc"]
    with torch.no_grad():  # at init DCC's bin logits reach ~4e3: a one-hot softmax (tests/test_torch_rtmo.py)
        dcc.gau.o.weight.mul_(0.05)
        dcc.x_fc.weight.mul_(0.01)
        dcc.y_fc.weight.mul_(0.01)
    cpu = ModelManager.get("rtmo-s-coco", device="cpu", init_weights=False)
    cpu.module.load_state_dict(gpu.module.state_dict())
    with torch.no_grad():
        grid = cpu.module.raw_outputs(torch.zeros(1, 640, 640, 3))
    priors, strides = grid.priors, grid.strides
    g = torch.Generator().manual_seed(7)
    a, k, n = priors.shape[0], 17, 10
    raw = dict(cls_scores=torch.randn(2, a, 1, generator=g), bbox_preds=torch.randn(2, a, 4, generator=g) * 0.3 + 1.5,
               kpt_offsets=torch.randn(2, a, 2 * k, generator=g), kpt_vis=torch.randn(2, a, k, generator=g),
               pose_feats=torch.randn(2, a, gpu.module.head["head_module"].pose_feat_channels, generator=g))
    xy = torch.rand(2, n, 2, generator=g) * 480
    wh = torch.rand(2, n, 2, generator=g) * 120 + 40
    kpts = xy[:, :, None] + torch.rand(2, n, k, 2, generator=g) * wh[:, :, None]
    vis = (torch.rand(2, n, k, generator=g) > 0.3).float()
    valid = torch.arange(n)[None] < torch.tensor([[6], [10]])
    targets = KeypointTargets(torch.zeros(2, n, dtype=torch.long), torch.cat([xy, xy + wh], -1), kpts, vis,
                              wh.prod(-1), valid)
    initial = {k_: v.clone() for k_, v in cpu.module.head["dcc"].pose_to_kpts[1].state_dict().items()}
    runs = {}
    for name, m, dev in (("cpu", cpu, "cpu"), ("card", gpu, cuda)):
        dcc = m.module.head["dcc"].train()
        if name == "card":  # the card's own SimOTA first, then the step on the CPU's assignment
            aux = RTMOAuxOutputs(**{f: t.to(dev) for f, t in raw.items()}, priors=priors.to(dev), strides=strides.to(dev))
            own = rtmo_criterion(dcc, aux, targets.to(dev), m.config)[1].to("cpu")
            ref = runs["cpu"][1]
            assert int(own.pos_mask.sum()) == int(ref.pos_mask.sum()) > 0
            assert torch.equal(own.pos_mask, ref.pos_mask)
            assert torch.equal(own.gt_idx[ref.pos_mask], ref.gt_idx[ref.pos_mask])
            dcc.pose_to_kpts[1].load_state_dict(initial)
        leaves = {f: t.clone().to(dev).requires_grad_() for f, t in raw.items()}
        aux = RTMOAuxOutputs(**leaves, priors=priors.to(dev), strides=strides.to(dev))
        carried = runs["cpu"][1].to(dev) if name == "card" else None
        losses, used = rtmo_criterion(dcc, aux, targets.to(dev), m.config, carried=carried)
        losses["total"].backward()
        runs[name] = ({k_: float(v.detach()) for k_, v in losses.items()}, used.to("cpu"),
                      {f: t.grad.cpu() for f, t in leaves.items()},
                      {s_: getattr(dcc.pose_to_kpts[1], f"running_{s_}").double().cpu() for s_ in ("mean", "var")})
        dcc.eval()
    for k_, v in runs["cpu"][0].items():
        assert abs(runs["card"][0][k_] - v) <= 1e-5 * abs(v) + 1e-9, (k_, runs["card"][0][k_], v)
    for f, r in runs["cpu"][2].items():
        err = float((runs["card"][2][f] - r).abs().max() / r.abs().max())
        assert err <= 1e-4, (f, err)
    mom = gpu.module.head["dcc"].pose_to_kpts[1].momentum
    batch = {s_: [(r[3][s_] - (1 - mom) * initial[f"running_{s_}"].double()) / mom for r in (runs["card"], runs["cpu"])]
             for s_ in ("mean", "var")}
    (gm, rm), (gv, rv) = batch["mean"], batch["var"]
    assert float(((gm - rm).abs() / rv.sqrt()).max()) <= 1e-5
    assert float(((gv - rv).abs() / rv).max()) <= 1e-5


# ---------------------------------------------------------------------------
# export and int8 serving (focoos_tpu_torch/infer, ops/int8.py)


@pytest.mark.parametrize("m,k,n", [(5, 27, 12), (16, 27, 32), (300, 576, 64), (17, 256, 1024)])
def test_int8_matmul_on_the_card_equals_float64(cuda, m, k, n):
    """``torch._int_mm`` on zero-padded operands (M ≤ 16, K = 27 and N not a
    multiple of 8 are padded) against the exact float64 product, bit for bit."""
    from focoos_tpu_torch.ops.int8 import int8_matmul, int8_matmul_reference

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = int8_matmul(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), int8_matmul_reference(a, b))
    assert torch.equal(got, int8_matmul_reference(a.to(cuda), b.to(cuda)))


@pytest.mark.parametrize("k,stride,cin", [(3, 2, 3), (3, 1, 16), (1, 2, 16), (1, 1, 24)])
def test_int8_conv_norm_on_the_card_matches_the_cpu(cuda, k, stride, cin):
    """An int8 ConvNorm: the card's im2col + ``_int_mm`` sums equal the CPU's
    float64 ones; the output (the same sums times the same scales, then
    cuDNN-free BatchNorm) agrees to 1e-6 x max."""
    from focoos_tpu_torch.nn.layers.common import ConvNorm, set_int8_mode
    from focoos_tpu_torch.ops.int8 import int8_conv2d, int8_conv2d_reference

    g = torch.Generator().manual_seed(k * 10 + cin)
    xq = torch.randint(-127, 128, (2, 29, 31, cin), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (40, cin, k, k), generator=g, dtype=torch.int8)
    pad = (k - 1) // 2
    acc = int8_conv2d(xq.to(cuda), wq.to(cuda), stride, pad)
    assert torch.equal(acc.cpu(), int8_conv2d_reference(xq, wq, stride, pad))
    cpu = ConvNorm(cin, 40, k, stride, act="relu").eval()
    torch.nn.init.normal_(cpu.conv.weight, 0.0, 0.2, generator=g)
    card = ConvNorm(cin, 40, k, stride, act="relu").to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    for m in (cpu, card):
        set_int8_mode(m, True)
    x = torch.randn(2, cin, 29, 31, generator=g)
    with torch.no_grad():
        ref, out = cpu(x), card(x.to(cuda)).cpu()
    assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def _op_cases(device):
    from focoos_tpu_torch.ops.msda import msda_forward_op
    from focoos_tpu_torch.ops.nms import nms_keep_op
    from focoos_tpu_torch.ops.stem import fused_resnet_stem_op

    g = torch.Generator().manual_seed(0)
    v = torch.rand(2, 26, 2, 8, generator=g)
    msda = (v, [4, 5, 2, 3], torch.rand(2, 7, 2, 2, 4, 2, generator=g), torch.rand(2, 7, 2, 2, 4, generator=g))
    _, params = _stem_params("cpu")
    stem = (torch.randn(2, 13, 11, 3, generator=g), *params)
    boxes = torch.rand(2, 9, 4, generator=g)
    boxes[..., 2:] += boxes[..., :2]
    nms = (boxes, torch.sort(torch.rand(2, 9, generator=g), descending=True).values, 0.5)
    move = lambda args: tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)  # noqa: E731
    return {"msda_forward": (msda_forward_op, move(msda)), "fused_resnet_stem": (fused_resnet_stem_op, move(stem)),
            "nms_keep": (nms_keep_op, move(nms))}


@pytest.mark.parametrize("op", ["msda_forward", "fused_resnet_stem", "nms_keep"])
def test_custom_op_passes_opcheck_on_the_card(cuda, op):
    fn, args = _op_cases(cuda)[op]
    result = torch.library.opcheck(fn, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_tiny_fai_detr_program_on_the_card_equals_eager(cuda, tmp_path):
    """A tiny fai-detr-l exported on the card: the loaded ``.pt2`` runs the
    MSDA and stem kernels as custom ops, and its outputs equal the eager
    module's (the same kernels and cuBLAS calls, traced)."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ops.msda import msda_forward
    from focoos_tpu_torch.ops.stem import fused_resnet_stem
    from focoos_tpu_torch.ports import RuntimeType

    model = ModelManager.get("fai-detr-l-coco", device=cuda, image_size=96, num_queries=20,
                             transformer_predictor_dec_layers=2,
                             backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False})
    served = model.export(RuntimeType.TORCH_EXPORT, out_dir=str(tmp_path))
    x = torch.randint(0, 256, (1, 96, 96, 3), generator=torch.Generator().manual_seed(1), dtype=torch.uint8)
    msda_forward.launches = fused_resnet_stem.launches = 0
    got = served.runtime(x.numpy())
    torch.cuda.synchronize()
    assert (msda_forward.launches, fused_resnet_stem.launches) == (2, 1)
    with torch.inference_mode():
        out, _ = model.module(x.to(cuda))
    for name, g in zip(["boxes", "logits"], got):
        ref = getattr(out, name)
        assert float((g - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), name


def test_quantizer_benchmark_comparison_on_the_card(cuda, tmp_path):
    """``Quantizer.benchmark_comparison``: the card's forward latency with the
    float weights, then with the int8 store's dequantized ones, and the float
    weights back in the model afterwards."""
    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.infer.quantizer import Quantizer

    model = ModelManager.get("fai-detr-l-coco", device=cuda, image_size=96, num_queries=20,
                             transformer_predictor_dec_layers=2,
                             backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False})
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    quantizer = Quantizer(model)
    times = quantizer.benchmark_comparison(quantizer.quantize(str(tmp_path)), iterations=3)
    assert set(times) == {"fp", "int8"}
    for lat in times.values():
        assert lat.device == torch.cuda.get_device_name(cuda) and lat.im_size == 96 and 0 < lat.min <= lat.max
    after = model.module.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_profiler_hook_traces_the_card(cuda, tmp_path):
    """``ProfilerHook`` around two iterations of card work: its Chrome trace
    holds the card's kernels, and ``parse_trace_busy_us`` of it agrees with
    the union of the profiler's own kernel intervals within 1%."""
    from focoos_tpu_torch.trainer.hooks import ProfilerHook
    from focoos_tpu_torch.trainer.trainer import TrainerLoop
    from focoos_tpu_torch.utils.profiling import busy_us, parse_trace, parse_trace_busy_us

    x = torch.randn(512, 512, device=cuda)

    def step(state, images, targets):
        for _ in range(4):
            torch.mm(x, x)
        return ("total_loss",), torch.ones(1, device=cuda)

    hook = ProfilerHook(str(tmp_path), start_iter=1, num_iters=2)
    loop = TrainerLoop(step, None, iter([(torch.zeros(2), torch.zeros(2))] * 8), 4, cuda)
    loop.register_hooks([hook])
    loop.train()
    dur, _ = parse_trace(hook.trace_path)
    assert dur and sum(dur.values()) > 0
    kern = [e for e in hook.profiler.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    mine = busy_us((e.time_range.start, e.time_range.end) for e in kern)
    assert abs(parse_trace_busy_us(hook.trace_path) - mine) <= 0.01 * mine


def test_retry_if_oom_reraises_a_real_card_oom(cuda):
    """A request for more than the card holds: one retry after emptying the
    cache, then ``torch.OutOfMemoryError``; nothing runs on the CPU."""
    from focoos_tpu_torch.utils.memory import retry_if_oom

    tries, devices = [], []
    total = torch.cuda.get_device_properties(cuda).total_memory

    @retry_if_oom
    def too_big():
        tries.append(1)
        t = torch.empty(2 * total, dtype=torch.uint8, device=cuda)
        devices.append(t.device.type)

    with pytest.raises(torch.OutOfMemoryError):
        too_big()
    assert len(tries) == 2 and devices == []


def _global_batchnorm_rank(x: torch.Tensor, gy: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> list:
    """A rank of the 2-rank BatchNorm test, on cuda:0 over gloo: its half of
    the batch through a train-mode BatchNorm, backward with its half of the
    output gradient → every rank's (y, dx, dweight, dbias, running mean,
    running var), on the CPU."""
    from focoos_tpu_torch.nn.layers.common import BatchNorm
    from focoos_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    dev, rank, half = torch.device("cuda:0"), mesh.get_rank(), x.shape[0] // 2
    rows = slice(rank * half, (rank + 1) * half)
    bn = BatchNorm(x.shape[1]).to(dev).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xr = x[rows].to(dev).requires_grad_()
    y = bn(xr)
    (y * gy[rows].to(dev)).sum().backward()
    return mesh.all_gather_objects(tuple(t.detach().cpu() for t in (y, xr.grad, bn.weight.grad, bn.bias.grad,
                                                                   bn.running_mean, bn.running_var)))


def test_global_batchnorm_on_two_ranks_of_one_card_matches_one_process(cuda):
    """The port's BatchNorm on two ranks over gloo, both on the one card
    (NCCL takes one rank a device), against the one-process BatchNorm on the
    whole batch: the output, the input's gradient, the parameters' gradients
    (the ranks' sum, as DDP's reduction gives it) and the running statistics,
    fp32 × max|ref| 1e-5 (sums in another order; the gradient crosses both
    ``all_reduce``s)."""
    from focoos_tpu_torch.nn.layers.common import BatchNorm
    from focoos_tpu_torch.parallel.launch import launch

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, 12, 10, generator=g) * 2.0 + 0.5
    gy = torch.randn(x.shape, generator=g)
    weight, bias = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g)
    ranks = launch(_global_batchnorm_rank, num_devices=2, args=(x, gy, weight, bias), backend="gloo")

    bn = BatchNorm(16).to(cuda).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xr = x.to(cuda).requires_grad_()
    y = bn(xr)
    (y * gy.to(cuda)).sum().backward()
    ref = [t.detach().cpu() for t in (y, xr.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var)]
    got = [torch.cat([r[0] for r in ranks]), torch.cat([r[1] for r in ranks]), ranks[0][2] + ranks[1][2],
           ranks[0][3] + ranks[1][3], ranks[0][4], ranks[0][5]]
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()), msg=name)
    torch.testing.assert_close(ranks[1][4], ranks[0][4], rtol=0, atol=0)
