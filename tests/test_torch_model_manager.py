"""``ModelManager.get`` leaves the registry's cached card as it found it.

The JAX package's ``ModelManager.get`` writes ``classes``, ``im_size`` and
``config`` into the card object that ``ModelRegistry`` caches
(``focoos_tpu/model_manager.py:141-142,161-172``), so after a
``get(..., num_classes=5)`` a plain ``get`` of the same name builds 5 classes
instead of the card's 80. The port edits a copy of the card
(``focoos_tpu_torch/model_manager.py``); this test pins that behaviour.
"""

from focoos_tpu_torch import ModelManager
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
