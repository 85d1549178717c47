"""bisenetformer criterion: fai_mf's (port of focoos_tpu/models/bisenetformer/loss.py;
the reference ships a byte-identical SetCriterion copy, focoos/models/bisenetformer/loss.py)."""

from focoos_tpu_torch.models.fai_mf.loss import make_loss_fn, maskformer_criterion  # noqa: F401
