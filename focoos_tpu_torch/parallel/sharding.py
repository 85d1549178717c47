"""Data-parallel and fully sharded training (port of
focoos_tpu/parallel/sharding.py; reference: focoos/utils/distributed/dist.py).

Under JAX a sharding mode is a layout only: GSPMD computes the single-device
step (sharding.py:24-26). The port computes the same step in two ways:

- ``dp``: the module replicated on every rank inside
  ``DistributedDataParallel``, which averages the gradients over the ranks
  (the reference's DDP);
- ``fsdp``: FSDP2 ``fully_shard`` on each block of the model, then on the
  root: each parameter, its gradient and its optimizer state live as
  dim-0 shards (DTensors) over the ``data`` mesh, gathered for each
  block's forward, kept to its backward and reduce-scattered after it
  (within a step the gathered blocks add up to the full parameters, as
  under ZeRO-2). JAX shards leaf by leaf (``spec_for``); FSDP2 shards per
  module, every parameter of a block, small ones too, except the 0-d ones,
  which it refuses: those stay whole and their gradients are averaged as
  DDP's. The trainer shards a copy of the model and keeps the full one on
  every rank for the rank-sharded validation (a sharded forward is a
  collective, and the ranks' shares of the validation set differ in
  length), so a rank holds about twice the full parameters during a step:
  the mode saves the gradients' and the optimizer state's memory, not the
  parameters'.

``tp``, ``fsdp_tp`` and a 2-D mesh are not ported (ROADMAP Queue 1 item 9).
Both modes' numerics are the single-process step on the global batch once
the losses and norms reduce over it (``parallel/mesh.py``). The state
helpers below move a module's and an optimizer's state between the sharded
and the full (one-process) layouts, so that a checkpoint written under one
mode, or by one process, loads under another.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

import torch
from torch import nn

MODES = ("dp", "fsdp")
NOT_PORTED = ("tp", "fsdp_tp")


def check_mode(mode: str) -> None:
    if mode in NOT_PORTED:
        raise NotImplementedError(f"sharding {mode!r} is not ported yet (ROADMAP Queue 1 item 9)")
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; the port takes {MODES}")


def blocks(module: nn.Module) -> Iterator[nn.Module]:
    """The model's top-level blocks that hold parameters: its children, and
    the children of a ``ModuleList`` / ``ModuleDict`` child (a container is
    never called, so FSDP's hooks on it would never gather its parameters)."""
    for child in module.children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            yield from blocks(child)
        elif any(True for _ in child.parameters()):
            yield child


def apply_sharding(step_module: nn.Module, model: nn.Module, mode: str, device: torch.device) -> nn.Module:
    """Wrap ``step_module`` (whose forward runs ``model`` and its loss) for
    ``mode`` over the live process group → the callable to train through.
    ``dp``: ``DistributedDataParallel`` (the buffers are not broadcast: the
    BatchNorms' statistics are the global batch's on every rank already).
    ``fsdp``: ``fully_shard`` on each of ``model``'s ``blocks``, then on
    ``step_module``; ``model``'s parameters are DTensors afterwards."""
    check_mode(mode)
    if mode == "dp":
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(
            step_module, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=True)
    from torch.distributed.fsdp import fully_shard

    from focoos_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device.type)
    # FSDP shards no 0-d parameter (rtmo's scales): those stay whole on every rank, their gradients averaged here
    scalars = {p for p in model.parameters() if p.dim() == 0}
    for p in scalars:
        p.register_post_accumulate_grad_hook(_average_grad)
    # a block keeps its gathered parameters from its forward to its backward: its outputs are dataclasses,
    # which FSDP's pre-backward hooks do not look into, so a block resharded after its forward would not be
    # gathered again before autograd reads the parameters it saved
    for block in blocks(model):
        fully_shard(block, mesh=mesh, reshard_after_forward=False, ignored_params=scalars)
    fully_shard(step_module, mesh=mesh, reshard_after_forward=False, ignored_params=scalars)
    return step_module


def _average_grad(p: torch.Tensor) -> None:
    """The ranks' mean of ``p.grad``, in place (DDP's reduction, for a parameter FSDP leaves whole)."""
    import torch.distributed as dist

    dist.all_reduce(p.grad)
    p.grad.div_(dist.get_world_size())


# ---------------------------------------------------------------------------
# full <-> sharded state
# ---------------------------------------------------------------------------


def is_sharded(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full(obj: Any) -> Any:
    """``obj`` (a tensor, or a dict / list / tuple of them) with every
    DTensor gathered to its full tensor: a collective on every rank."""
    if is_sharded(obj):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return {k: full(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full(v) for v in obj)
    return obj


def shard_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A full ``value`` laid out as ``like``: its shard when ``like`` is a
    DTensor, else ``value`` on ``like``'s device and dtype."""
    value = value.to(device=like.device, dtype=like.dtype)
    if is_sharded(like):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(value, like.device_mesh, like.placements)
    return value


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded tensor gathered (every rank calls it)."""
    return full(module.state_dict())


def load_full_state_dict(module: nn.Module, state: Dict[str, torch.Tensor], strict: bool = True) -> None:
    """Load a full state dict into ``module``, sharded or not."""
    own = module.state_dict()
    module.load_state_dict({k: shard_like(v, own[k]) if k in own else v for k, v in state.items()}, strict=strict)


def shard_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """After ``optimizer.load_state_dict`` of a full state: lay each state
    tensor that has its parameter's full shape out as the parameter."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not is_sharded(p):
                continue
            st = optimizer.state.get(p, {})
            for k, v in list(st.items()):
                if isinstance(v, torch.Tensor) and not is_sharded(v) and tuple(v.shape) == tuple(p.shape):
                    st[k] = shard_like(v, p)


def local_tensors(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The local shard of each DTensor (the tensor itself otherwise): in-place
    ops on them act on the DTensor."""
    return [t.to_local() if is_sharded(t) else t for t in tensors]
