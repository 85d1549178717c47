"""Kernel tests that need the card. They skip where ``torch.cuda.is_available()``
is false. On a machine with an NVIDIA H100 and nvcc, run them without the JAX
test configuration (tests/conftest.py imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version on the same inputs
on the card, with TF32 off. Tolerances, × max|ref|: fp32, 1e-5 for MSDA and
1e-4 for the stem's three chained 3x3 convs (the same products summed in
another order); bf16 values, 2^-7 (the kernel accumulates in fp32 and rounds
its output to bf16 once, against the plain version in fp32 on the same bf16
inputs).
"""

import numpy as np
import pytest
import torch

from focoos_tpu_torch.ops.deformable import ms_deform_attn
from focoos_tpu_torch.ops.msda import msda_forward
from focoos_tpu_torch.ops.stem import fused_resnet_stem, resnet_stem_reference

pytestmark = pytest.mark.cuda

MSDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w", [(2, 640, 640), (1, 97, 70), (1, 5, 6)])
def test_stem_kernel_matches_plain(cuda, dtype, b, h, w):
    g = torch.Generator().manual_seed(1)
    params = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        params += [
            (torch.randn(3, 3, cin, cout, generator=g) * (2.0 / (9 * cin)) ** 0.5).to(cuda),
            (1 + 0.1 * torch.randn(cout, generator=g)).to(cuda),
            (0.1 * torch.randn(cout, generator=g)).to(cuda),
        ]
    x = torch.randn(b, h, w, 3, generator=g).to(cuda, dtype)
    before = fused_resnet_stem.launches
    out = fused_resnet_stem(x, *params)
    torch.cuda.synchronize()
    assert fused_resnet_stem.launches == before + 1
    ref = resnet_stem_reference(x.float(), *params)
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref).abs().max()) <= STEM_TOL[dtype] * float(ref.abs().max())


def test_wrappers_refuse_autograd(cuda):
    v = torch.zeros(1, 4, 1, 32, device=cuda, requires_grad=True)
    loc = torch.zeros(1, 1, 1, 1, 1, 2, device=cuda)
    aw = torch.zeros(1, 1, 1, 1, 1, device=cuda)
    with pytest.raises(NotImplementedError):
        msda_forward(v, [(2, 2)], loc, aw)


def test_slice_launches_each_kernel(cuda):
    from focoos_tpu_torch import ModelManager

    model = ModelManager.get(
        "fai-detr-l-coco", device=cuda, image_size=64, num_queries=10, transformer_predictor_dec_layers=2,
    )
    msda0, stem0 = msda_forward.launches, fused_resnet_stem.launches
    res = model.infer(np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8), threshold=0.0)
    assert msda_forward.launches - msda0 == 2 and fused_resnet_stem.launches - stem0 == 1
    assert len(res) == 300
