"""Optimizer and LR schedule (port of focoos_tpu/trainer/solver.py;
reference: focoos/trainer/solver/).

The JAX package expresses the reference's per-parameter policy
(solver/build.py:39-103) over flax paths and composes one optax chain:

    clip_by_global_norm → core (Adam / trace / RMS) → + wd·p → × lr_mult → × −lr(step)

Here the policy runs on the port's parameter names, which are the reference's
torch names, and the chain is ``clip_by_global_norm`` (optax's formula)
followed by an optimizer with one parameter group per (lr multiplier, weight
decay) and the group's lr set to ``lr(step) · mult`` each step. ADAMW is
``torch.optim.AdamW``: its ``p ← p·(1 − lr·wd) − lr·adam`` is the chain's
``p − lr·mult·(adam + wd·p)``. SGD and RMSPROP are ``OptaxCore``, because
torch's own differ from the chain: ``torch.optim.SGD(weight_decay=)`` feeds
the decay into the momentum, where optax's ``trace`` takes the momentum of
the gradient alone; ``torch.optim.RMSprop`` divides by ``sqrt(ν) + eps``,
optax 0.2.6's ``scale_by_rms`` by ``sqrt(ν + eps)`` (``eps_in_sqrt``), which
near ν = 0 differ by orders of magnitude.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.parallel.sharding import is_sharded, local_tensors
from focoos_tpu_torch.ports import TrainerArgs

# module types whose parameters take ``weight_decay_norm`` (the reference's
# isinstance test, solver/build.py:53-67)
NORM_TYPES = (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)


def _warmup_factor(step: int, warmup_iters: int, warmup_factor: float) -> float:
    """Linear warmup (reference: solver/lr_scheduler.py:_get_warmup_factor_at_iter)."""
    if warmup_iters <= 0 or step >= warmup_iters:
        return 1.0
    alpha = min(max(step / warmup_iters, 0.0), 1.0)
    return warmup_factor * (1 - alpha) + alpha


def build_schedule(name: str, base_lr: float, max_iters: int, extra: Optional[dict] = None) -> Callable[[int], float]:
    """``step → lr`` for POLY / MULTISTEP / COSINE / FIXED, each with linear
    warmup. MULTISTEP has no default milestones (constant LR unless
    ``extra["milestones"]`` names fractions of ``max_iters``)."""
    extra = dict(extra or {})
    warmup_iters = int(extra.pop("warmup_iters", 0))
    warmup_factor = float(extra.pop("warmup_factor", 1.0))
    extra.pop("warmup_method", None)
    name = name.upper()
    if name == "FIXED":
        return lambda step: base_lr * _warmup_factor(step, warmup_iters, warmup_factor)
    if name == "POLY":
        power = float(extra.pop("power", 0.9))
        constant_ending = float(extra.pop("constant_ending", 0.0))

        def poly(step):
            frac = (1.0 - step / max_iters) ** power
            if constant_ending > 0:
                frac = max(frac, constant_ending)
            return base_lr * _warmup_factor(step, warmup_iters, warmup_factor) * frac

        return poly
    if name == "MULTISTEP":
        milestones = [int(m * max_iters) for m in extra.pop("milestones", [])]
        gamma = float(extra.pop("gamma", 0.1))
        return lambda step: (base_lr * _warmup_factor(step, warmup_iters, warmup_factor)
                             * gamma ** sum(step >= m for m in milestones))
    if name == "COSINE":
        return lambda step: (base_lr * _warmup_factor(step, warmup_iters, warmup_factor)
                             * 0.5 * (1.0 + math.cos(math.pi * step / max_iters)))
    raise NotImplementedError(f"Scheduler {name} not supported (POLY/FIXED/COSINE/MULTISTEP)")


def ema_decay_schedule(decay: float, warmup: int) -> Callable[[int], float]:
    """EMA decay ramp ``decay · (1 − exp(−x / warmup))`` with x the 1-based
    update count (reference solver/ema.py:101-114); ``step`` is 0-based."""
    if warmup <= 0:
        return lambda step: decay
    return lambda step: decay * (1.0 - math.exp(-(step + 1.0) / warmup))


# BatchNorms whose flax path is not under ``/bn/``, so JAX's freeze_bn mask
# spares them (ROADMAP Queue 3): fai_detr's input projections
# (``input_proj_<i>_bn``), STDC's ``avd_bn``, ``skip_dw_bn`` and ``skip_pw_bn``
# (nn/backbone/stdc.py's ``avd_layer`` and ``skip`` Sequentials), fai_mf's FPN
# norms (``adapter_<i>_norm``, ``layer_<i>_norm``), bisenetformer's ARM ``bn_atten``, and rtmo's head
# branches' and neck projector's (``conv_cls_<i>_<j>_bn``, ``conv_pose_<i>_<j>_bn``, ``projector_<i>_bn``)
_UNFROZEN_BN = re.compile(r"\.input_proj\.\d+\.(1|norm)$|\.(avd_layer\.1|skip\.[13])$|^pixel_decoder\.(adapter|layer)_\d\.norm$|\.bn_atten$"
                          r"|^head\.head_module\.conv_(cls|pose)\.\d+\.\d+\.bn$|^neck\.projector\.convs\.\d+\.bn$")


def param_hyperparams(
    module: nn.Module,
    base_wd: float,
    wd_norm: float = 0.0,
    wd_embed: float = 0.0,
    backbone_multiplier: float = 0.1,
    decoder_multiplier: float = 1.0,
    head_multiplier: float = 1.0,
    freeze_prefixes: Sequence[str] = (),
    freeze_bn: bool = False,
) -> Dict[str, Tuple[float, float]]:
    """{parameter name: (lr multiplier, weight decay)}, the reference's policy
    (solver/build.py:81-101) by substrings of the torch name: the multipliers
    stack (``pixel_decoder.backbone.*`` takes the backbone's and the pixel
    decoder's), ``head`` outside the classifiers takes the head's (fai_cls's
    ``cls_head.classifier.*`` too, as JAX's ``cls_head/fc*``); norms by
    module type take ``wd_norm``; a parameter under ``freeze_prefixes`` takes
    0 and 0 (it keeps its gradient, as JAX's masks do, and never moves), and
    so, with ``freeze_bn``, does a BatchNorm's scale and bias, except those
    whose JAX path is not under ``/bn/`` (``_UNFROZEN_BN``)."""
    norm_params = {
        f"{mname}.{pname}" if mname else pname
        for mname, m in module.named_modules() if isinstance(m, NORM_TYPES)
        for pname, _ in m.named_parameters(recurse=False)
    }
    bn_params = {
        f"{mname}.{pname}"
        for mname, m in module.named_modules()
        if isinstance(m, nn.BatchNorm2d) and not _UNFROZEN_BN.search(mname)
        for pname, _ in m.named_parameters(recurse=False)
    } if freeze_bn else set()
    out = {}
    for name, _ in module.named_parameters():
        if any(name.startswith(f) for f in freeze_prefixes) or name in bn_params:
            out[name] = (0.0, 0.0)
            continue
        # JAX's "head" test spares paths with "classifier" in them; fai_cls's convs are JAX's cls_head/fc*, so
        # the head multiplier applies to them there, where the reference's cls_head.classifier.* names (and
        # the reference torch SDK's policy) spare them: the port follows JAX (ROADMAP Queue 3)
        head = "head" in name and ("classifier" not in name or name.startswith("cls_head."))
        mult = 1.0
        if "backbone" in name:
            mult *= backbone_multiplier
        if "pixel_decoder" in name:
            mult *= decoder_multiplier
        if head:
            mult *= head_multiplier
        if name in norm_params or "norm" in name:
            wd = wd_norm
        elif "embed" in name:
            wd = wd_embed
        elif (("backbone" in name or "pixel_decoder" in name) and backbone_multiplier == 0) or (
            head and head_multiplier == 0
        ):
            wd = 0.0  # reference quirk: the pixel_decoder branch checks the backbone multiplier
        else:
            wd = base_wd
        out[name] = (mult, wd)
    return out


class OptaxCore(torch.optim.Optimizer):
    """The rest of the JAX chain after the clip, for SGD and RMSPROP: the
    core (``optax.trace``: t ← g + momentum·t, the update t, or g +
    momentum·t with nesterov; ``optax.scale_by_rms``: ν ← (1 − alpha)·g² +
    alpha·ν, the update g / sqrt(ν + 1e-8)), then + wd·p, then × the group's
    lr (``lr(step) · mult``). Frozen parameters (mult 0) keep their state
    moving and never move themselves, as under JAX's masks."""

    def __init__(self, groups, kind: str, momentum: float = 0.9, nesterov: bool = False, alpha: float = 0.99):
        if kind not in ("SGD", "RMSPROP"):
            raise ValueError(f"OptaxCore takes SGD or RMSPROP, not {kind}")
        self.kind, self.momentum, self.nesterov, self.alpha = kind, momentum, nesterov, alpha
        super().__init__(groups, {"lr": 0.0, "weight_decay": 0.0})

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                g, state = p.grad, self.state[p]
                if self.kind == "SGD":
                    t = state.setdefault("trace", torch.zeros_like(p))
                    t.mul_(self.momentum).add_(g)
                    u = g + self.momentum * t if self.nesterov else t.clone()
                else:
                    nu = state.setdefault("nu", torch.zeros_like(p))
                    nu.copy_((1 - self.alpha) * g * g + self.alpha * nu)
                    u = g * torch.rsqrt(nu + 1e-8)
                p.sub_((u + group["weight_decay"] * p) * group["lr"])


class Solver:
    """The optax chain of the JAX trainer on torch parameters: clip by global
    norm, the optimizer per (lr multiplier, weight decay) group, schedule per step."""

    def __init__(self, module: nn.Module, args: TrainerArgs, freeze_prefixes: Sequence[str] = ()):
        name = args.optimizer.upper()
        if name not in ("ADAMW", "SGD", "RMSPROP"):
            raise NotImplementedError(f"Optimizer {name} not supported (ADAMW/SGD/RMSPROP)")
        self.schedule = build_schedule(args.scheduler, args.learning_rate, args.max_iters, args.scheduler_extra)
        self.clip = float(args.clip_gradients or 0.0)
        hp = param_hyperparams(
            module, args.weight_decay, args.weight_decay_norm, args.weight_decay_embed,
            args.backbone_multiplier, args.decoder_multiplier, args.head_multiplier, freeze_prefixes,
            freeze_bn=args.freeze_bn,
        )
        groups: Dict[Tuple[float, float], List[torch.nn.Parameter]] = {}
        for pname, p in module.named_parameters():
            groups.setdefault(hp[pname], []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        param_groups = [{"params": ps, "mult": m, "weight_decay": wd} for (m, wd), ps in groups.items()]
        extra = args.optimizer_extra or {}
        if name == "ADAMW":
            betas = tuple(extra.get("betas", (0.9, 0.999)))
            self.optimizer = torch.optim.AdamW(param_groups, lr=args.learning_rate, betas=betas, eps=1e-8)
        else:
            self.optimizer = OptaxCore(param_groups, name, momentum=extra.get("momentum", 0.9),
                                       nesterov=extra.get("nesterov", False), alpha=extra.get("alpha", 0.99))

    def step(self, step: int) -> torch.Tensor:
        """One update from the gradients in ``.grad`` → the global norm of the
        unclipped gradients (a 0-d tensor on the parameters' device). Under
        FSDP the norm sums every rank's squares of the sharded gradients, and
        adds once the squares of those it leaves whole (0-d parameters, whose
        averaged gradient every rank holds)."""
        for p in self.params:  # JAX's grad is 0 where torch's is None; 0 still takes weight decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sharded = [is_sharded(p) for p in self.params]
        grads = local_tensors([p.grad for p in self.params])  # in-place ops on a shard act on its DTensor
        if grads[0].is_cuda:  # one fused launch that reduces as a tree
            norms = torch._foreach_norm(grads)
        else:  # torch's CPU norm sums fp32 in sequence (~4e-5 off at 2.4M values); dot sums in a cascade
            norms = [torch.dot(g.flatten(), g.flatten()).sqrt() for g in grads]
        if any(sharded):
            split = torch.linalg.vector_norm(torch.stack([n for n, s in zip(norms, sharded) if s]))
            whole = [n for n, s in zip(norms, sharded) if not s]
            sq = mesh.global_sum(split.square())
            if whole:
                sq = sq + torch.linalg.vector_norm(torch.stack(whole)).square()
            norm = sq.sqrt()
        else:
            norm = torch.linalg.vector_norm(torch.stack(norms))
        if self.clip > 0:
            # optax clip_by_global_norm: g · max / norm where norm >= max
            torch._foreach_mul_(grads, torch.where(norm < self.clip, 1.0, self.clip / norm))
        lr = self.schedule(step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["mult"]
        self.optimizer.step()
        return norm
