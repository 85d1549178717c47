"""``ModelManager.get``: it leaves the registry's cached card as it found it;
it takes a ``ModelInfo`` and ``classes=``, and loads the ``MODELS_DIR`` weight
cache; and ``FocoosModel.end2end_benchmark``.

The JAX package's ``ModelManager.get`` writes ``classes``, ``im_size`` and
``config`` into the card object that ``ModelRegistry`` caches
(``focoos_tpu/model_manager.py:141-142,161-172``), so after a
``get(..., num_classes=5)`` a plain ``get`` of the same name builds 5 classes
instead of the card's 80. The port edits a copy of the card
(``focoos_tpu_torch/model_manager.py``); this test pins that behaviour.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)

from focoos_tpu_torch import ModelManager, ports
from focoos_tpu_torch.model_registry import ModelRegistry

NAME = "fai-detr-l-coco"


def _classifier_width(model) -> int:
    return model.module.head.predictor.enc_score_classifier.weight.shape[0]


def test_get_leaves_the_registry_card_unchanged():
    five = ModelManager.get(NAME, device="cpu", num_classes=5, image_size=64, init_weights=False)
    assert five.config.num_classes == 5 and len(five.classes) == 5 and _classifier_width(five) == 5
    assert five.im_size == (64, 64)

    plain = ModelManager.get(NAME, device="cpu", init_weights=False)
    assert plain.config.num_classes == 80 and len(plain.classes) == 80 and _classifier_width(plain) == 80
    assert plain.im_size == (640, 640)

    card = ModelRegistry.get_model_info(NAME)
    assert len(card.classes) == 80 and card.config["num_classes"] == 80 and card.im_size == 640


TINY = dict(image_size=64, num_queries=10, transformer_predictor_dec_layers=1, pixel_decoder_feat_dim=64,
            pixel_decoder_out_dim=64, pixel_decoder_dim_feedforward=128, transformer_predictor_hidden_dim=64,
            transformer_predictor_out_dim=64, transformer_predictor_dim_feedforward=128, head_out_dim=64,
            backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False})


@pytest.mark.usefixtures("few_threads")
def test_get_takes_a_model_info_and_classes():
    """A ModelInfo is copied before it is edited; ``classes`` names the classes and sets their number."""
    info = ModelRegistry.get_model_info(NAME)
    names = ["cat", "dog", "bird"]
    model = ModelManager.get(info, device="cpu", classes=names, **TINY)
    assert model.model_info is not info and len(info.classes) == 80 and info.im_size == 640
    assert model.classes == names and model.config.num_classes == 3 and _classifier_width(model) == 3
    res = model.infer(np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8), threshold=0.0)
    assert {d.label for d in res.detections} <= set(names) and len(res.detections) > 0
    lat = model.end2end_benchmark(iterations=2)
    assert lat.engine == "torch.cpu.e2e" and lat.device == "cpu" and lat.im_size == 64 and lat.mean > 0


@pytest.mark.usefixtures("few_threads")
def test_models_dir_weight_cache(tmp_path, monkeypatch):
    """A registry model loads MODELS_DIR/<name>/model_final.npz when present
    (JAX model_manager.py:143-151): every weight of a cached model, and with
    other classes every weight whose shape still fits (the classifiers keep
    their seeded init)."""
    monkeypatch.setattr(ports, "MODELS_DIR", str(tmp_path))
    fresh = ModelManager.get(NAME, device="cpu", seed=0, classes=["a", "b"], **TINY).module.state_dict()
    src = ModelManager.get(NAME, device="cpu", seed=3, **TINY)
    src.save_weights(os.path.join(tmp_path, NAME, "model_final.npz"))
    want = src.module.state_dict()
    cached = ModelManager.get(NAME, device="cpu", seed=0, **TINY).module.state_dict()
    assert all(torch.equal(cached[k], v) for k, v in want.items())
    other = ModelManager.get(NAME, device="cpu", seed=0, classes=["a", "b"], **TINY).module.state_dict()
    mismatched = [k for k, v in want.items() if other[k].shape != v.shape]
    assert mismatched and all("score_classifier" in k for k in mismatched)
    for k, v in other.items():
        assert torch.equal(v, fresh[k] if k in mismatched else want[k]), k
