"""One process per device (port of focoos_tpu/parallel/launch.py; reference:
focoos/utils/distributed/dist.py:38 ``launch``).

JAX drives every local chip from one process; the reference, and this port,
spawn one process per device instead and join them in a process group:
NCCL between CUDA devices, gloo on the CPU. ``launch`` also runs under
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``):
it then joins the group torchrun describes and calls the function once, in
this process.
"""

from __future__ import annotations

import os
import pickle
import socket
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

TIMEOUT = timedelta(minutes=30)  # a collective's wait (torch's default)


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def free_port() -> int:
    """A TCP port of this machine that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init_group(backend: str, url: str, world: int, rank: int, local_rank: int) -> None:
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank, timeout=TIMEOUT)
    logger.info(f"process group ({backend}) up: rank {rank} of {world}, local rank {local_rank}")


def _run_in_group(main_func: Callable, args: Tuple, backend: str, url: str, world: int, rank: int,
                  local_rank: int) -> Any:
    """``main_func(*args)`` in a process group joined here, with torchrun's
    variables set for its length (and put back after, for a group joined in
    the caller's process)."""
    names = ("RANK", "LOCAL_RANK", "WORLD_SIZE")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world))
    try:
        _init_group(backend, url, world, rank, local_rank)
        try:
            return main_func(*args)
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _worker(local_rank: int, main_func: Callable, args: Tuple, backend: str, url: str, world: int, first_rank: int,
            results) -> None:
    """A spawned rank: rank 0 sends back the function's value, pickled (by
    value: a tensor crosses as its bytes, not as shared memory this process
    would have to keep alive); a rank that raises sends its traceback first."""
    rank = first_rank + local_rank
    try:
        out = _run_in_group(main_func, args, backend, url, world, rank, local_rank)
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise
    if rank == 0:
        results.put(("value", rank, pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)))


def launch(
    main_func: Callable,
    num_devices: int = -1,
    num_machines: int = 1,
    machine_rank: int = 0,
    dist_url: Optional[str] = None,
    args: Tuple = (),
    backend: Optional[str] = None,
) -> Any:
    """Run ``main_func(*args)`` on every rank of a process group → rank 0's
    value (under torchrun: this rank's).

    - A live process group, or a world of 1 without ``dist_url``: a plain
      call, here.
    - Under torchrun (``RANK`` and ``WORLD_SIZE`` set): this process joins
      that group (``env://``), calls the function once and returns its value.
    - Otherwise ``num_devices`` processes on this machine (-1: one per local
      CUDA device, or 1 without one), ranks ``machine_rank · num_devices``
      onward of ``num_devices · num_machines``, joined at ``dist_url``
      (default: a free port of localhost; required across machines); a
      world of 1 with ``dist_url`` joins a group of one, here. ``backend``
      defaults to NCCL where CUDA is available, else gloo.

    A rank that raises makes ``launch`` raise, after the other ranks are
    terminated (none is left waiting in a collective), with the traceback of
    every rank that raised, the first to raise first: a rank whose peer
    died fails too, on the closed connection. ``main_func`` and ``args``
    must pickle (a module-level function), as spawned processes import them.
    """
    if mesh.is_initialized():
        return main_func(*args)
    backend = backend or default_backend()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return _run_in_group(main_func, args, backend, "env://", int(os.environ["WORLD_SIZE"]),
                             int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", 0)))
    n = num_devices if num_devices > 0 else max(torch.cuda.device_count(), 1)
    world = n * num_machines
    if num_machines > 1 and not dist_url:
        raise ValueError("launch across machines needs dist_url (tcp://<rank 0's host>:<port>)")
    if world == 1:
        if dist_url is None:
            return main_func(*args)
        return _run_in_group(main_func, args, backend, dist_url, 1, 0, 0)
    url = dist_url or f"tcp://localhost:{free_port()}"
    import torch.multiprocessing as tmp

    ctx_mp = tmp.get_context("spawn")
    results = ctx_mp.SimpleQueue()
    logger.info(f"launching {n} processes ({backend}) of {world} ranks at {url}")
    ctx = tmp.start_processes(_worker, args=(main_func, args, backend, url, world, machine_rank * n, results),
                              nprocs=n, join=False, start_method="spawn")
    received: List[tuple] = []
    try:
        # read rank 0's value while waiting: a large one fills the pipe before that rank can exit
        while not ctx.join(timeout=0.5):
            while not results.empty():
                received.append(results.get())
    except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
        while not results.empty():
            received.append(results.get())
        errors = [f"rank {rank}:\n{tb}" for kind, rank, tb in received if kind == "error"]
        raise RuntimeError(f"launch: {len(errors) or 'a'} rank(s) failed, the first to fail first:\n"
                           + ("\n".join(errors) or str(e))) from e
    while not results.empty():
        received.append(results.get())
    values = [payload for kind, _, payload in received if kind == "value"]
    return pickle.loads(values[0]) if values else None
