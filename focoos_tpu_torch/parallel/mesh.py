"""Ranks, collectives and the data mesh (port of focoos_tpu/parallel/mesh.py;
reference: focoos/utils/distributed/comm.py).

Under JAX one program sees the global batch and GSPMD keeps every reduction
over it (focoos_tpu/parallel/sharding.py:24-26). A torch process group gives
each rank its own slice of the batch instead, so what spans the global batch
under JAX is made global here by hand, with ``all_reduce`` only:

- ``global_count``: a loss normalizer (the count of boxes, masks, positives)
  as the reference's ``all_reduce(count) / world`` (focoos/models/*/loss.py):
  with DistributedDataParallel averaging the gradients, the mean of the
  ranks' losses is the global batch's loss, and so is the update;
- ``all_reduce_sum``: a sum that the gradient flows back through (the
  BatchNorms' statistics, ``nn/layers/common.py``);
- ``global_rand``: a draw for the global batch, of which each rank keeps its
  own rows, so that two ranks with one seed draw what one process draws;
- ``mean_across_ranks``: the logged metrics.

Every helper works in one process without a process group (rank 0 of a world
of 1), where each is the plain single-process computation, bit for bit.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def is_initialized() -> bool:
    """Whether a default process group is live."""
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    """This process's index among the processes of its machine (``LOCAL_RANK``, as torchrun and ``launch`` set it)."""
    return int(os.environ.get("LOCAL_RANK", 0)) if is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def data_parallel() -> bool:
    """Whether the batch is split over more than one rank."""
    return get_world_size() > 1


def local_device(device_type: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:<local rank>`` for ``device_type`` "cuda", else the CPU."""
    if torch.device(device_type).type == "cuda":
        return torch.device("cuda", get_local_rank())
    return torch.device("cpu")


def synchronize() -> None:
    """Barrier across ranks (a no-op without a group of more than one)."""
    if get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (JAX's pickle, pad and
    trim, mesh.py:81-111, is what ``all_gather_object`` does)."""
    world = get_world_size()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def make_mesh(device_type: str = "cuda"):
    """The 1-D ``DeviceMesh`` over the ``data`` axis of every rank (JAX
    mesh.py:24-36)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device_type).type, (get_world_size(),), mesh_dim_names=(DATA_AXIS,))


# ---------------------------------------------------------------------------
# the global batch's reductions
# ---------------------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``t``; the gradient flows back through it (its
    backward is the same sum of the gradients)."""
    if not data_parallel():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def global_count(x: torch.Tensor, floor: float) -> torch.Tensor:
    """A loss normalizer: ``max(Σ_ranks x, floor) / world``, the global
    batch's count divided among the ranks; ``max(x, floor)`` in one process.
    ``x`` takes no gradient."""
    if not data_parallel():
        return x.clamp(min=floor)
    return global_sum(x).clamp(min=floor) / get_world_size()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``x``, which takes no gradient (a metric such as a count of positives)."""
    if not data_parallel():
        return x
    total = x.detach().clone()
    dist.all_reduce(total)
    return total


@torch.no_grad()
def mean_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """The ranks' mean of ``t`` (the logged metrics)."""
    if not data_parallel():
        return t
    total = t.clone()
    dist.all_reduce(total)
    return total / get_world_size()


def row_span(n: int, device: torch.device) -> Tuple[int, int]:
    """(the offset of this rank's ``n`` rows among every rank's, in rank
    order; the rows of every rank): one ``all_reduce`` of the ranks' counts."""
    world = get_world_size()
    if world == 1:
        return 0, n
    counts = torch.zeros(world, dtype=torch.int64, device=device)
    counts[get_rank()] = n
    dist.all_reduce(counts)
    counts = counts.tolist()
    return sum(counts[: get_rank()]), sum(counts)


def global_rand(shape: Sequence[int], generator: Optional[torch.Generator], device: torch.device, dim: int = 0,
                span: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``torch.rand(shape)``, where ``shape[dim]`` counts this rank's rows:
    one draw over every rank's rows (``span`` as ``row_span`` gives it, or
    taken here) of which this rank keeps its own. Ranks that share a seed
    then draw what one process draws for the global batch, not the same
    numbers for different images."""
    if not data_parallel():
        return torch.rand(tuple(shape), generator=generator, device=device)
    offset, total = span if span is not None else row_span(shape[dim], device)
    full = list(shape)
    full[dim] = total
    return torch.rand(full, generator=generator, device=device).narrow(dim, offset, shape[dim])
