"""fai-detr-l-coco at full width on the CPU: the port against the JAX package
at 640² (ResNet-50-D, 300 queries, 6 decoder layers), B=1, on the same
weights (the port's seeded init, perturbed as tests/test_torch_fai_detr.py
perturbs it, carried to JAX through ``torch_convert``) and JAX's query
selection carried to the port. Boxes and sigmoid scores ≤ 1e-3 abs, as the
card is held to the port on the CPU. Marked ``slow``: tier-1 leaves it out
(one JAX compile of the full model and two full-width forwards on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import _carry_selection, _record_top_k
from test_torch_fai_detr import _flat, _perturb

from focoos_tpu.model_manager import ModelManager as JaxModelManager
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.utils.weights import from_jax_variables

pytestmark = pytest.mark.slow
SIZE = 640
TOL = 1e-3  # abs, boxes (normalized cxcywh) and sigmoid scores


def test_fai_detr_l_full_width_matches_jax(monkeypatch):
    port = ModelManager.get("fai-detr-l-coco", device="cpu", seed=0)
    cfg = port.config
    assert (cfg.num_queries, cfg.transformer_predictor_dec_layers, port.im_size[0]) == (300, 6, SIZE)
    tree, _ = convert_state_dict({k: v.numpy() for k, v in port.module.state_dict().items()}, "fai_detr",
                                 verbose=False)
    flat = _perturb(_flat(tree), seed=0)
    port.module.load_state_dict(from_jax_variables(flat, "fai_detr"), strict=True)
    port.module.eval()
    x = np.random.default_rng(3).integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)

    jmodel = JaxModelManager.get("fai-detr-l-coco", init_weights=False)
    seen = _record_top_k(monkeypatch)
    out, _ = jax.jit(jmodel.module.apply)(unflatten_tree(flat), jnp.asarray(x))
    jax.effects_barrier()
    sel = seen[-1]
    assert sel.shape == (1, 300)

    _carry_selection(port.module.predictor, sel)
    with torch.inference_mode():
        got, _ = port.module(torch.from_numpy(x))
    ref_boxes, ref_scores = np.asarray(out.boxes), 1 / (1 + np.exp(-np.asarray(out.logits, np.float64)))
    np.testing.assert_allclose(got.boxes.numpy(), ref_boxes, rtol=0, atol=TOL, err_msg="boxes")
    np.testing.assert_allclose(torch.sigmoid(got.logits.double()).numpy(), ref_scores, rtol=0, atol=TOL,
                               err_msg="sigmoid scores")
