"""Data loaders (port of focoos_tpu/data/loaders.py; reference:
focoos/data/loaders.py:94-141).

``TrainingSampler`` draws the same ``np.random.default_rng(seed)``
permutations as the JAX package's, so one process sees the JAX package's
index stream. In a process group rank r takes the positions ``≡ r (mod
world)`` of that one stream, across the permutations' ends, so the ranks'
batches together are one process's batch at every step. The JAX package's
host r takes ``order[r::world]`` of each permutation, which departs from one
process's batches at an epoch's end where the world does not divide the
dataset's size (ROADMAP Queue 3). ``build_train_loader`` is PyTorch's own
loader, ``torch.utils.data.DataLoader``, over that sampler, with the rank's
share ``total_batch_size / world`` of the batch, which must divide evenly
(JAX trains ``total_batch_size // world`` a host, and so fewer images):

- batches come in sampler order; a finite sampler's trailing partial batch
  is yielded and the stream then ends;
- ``num_workers`` worker processes (DataLoader's default start on Linux,
  fork) map records through the dataset (a ``MapDataset`` reads, augments
  and maps from disk) and collate them with the processor's
  ``preprocess_entries``, which makes CPU tensors only: workers never touch
  CUDA. ``num_workers=0`` maps and collates in the calling thread;
- each worker seeds the global numpy and ``random`` states as the JAX
  package's workers do, with ``seed * 1000 + worker id`` (plus
  ``rank * num_workers`` on rank r, so that no two ranks' workers draw the
  same augmentations, where JAX's hosts would): DataLoader seeds
  torch and ``random`` in its workers but not numpy, and forked workers
  would otherwise all draw the parent's numpy state, and so the same
  augmentations;
- a worker's exception is raised in the parent, naming it; ``close()``
  reaps the workers;
- with ``pin_memory`` the parent pins each image batch for a non-blocking
  copy to the card.

The JAX package's ``_ProcessPrefetcher`` and its ``FOCOOS_WORKER_PROCESSES``
/ ``FOCOOS_WORKER_START`` switches are how the TPU host was fed (JAX has no
DataLoader) and are not ported; neither is aspect-ratio grouping, which no
trainer asks for.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.ports import DatasetEntry


class TrainingSampler:
    """Infinite shuffled index stream, sharded across ranks (reference:
    data/samplers.py:10): rank r of the process group's ``world`` takes the
    positions ``≡ r (mod world)`` of the one stream of permutations."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0):
        self._size = size
        self._shuffle = shuffle
        self._seed = seed
        self._shard = mesh.get_rank()
        self._num_shards = mesh.get_world_size()

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self._seed)
        skip = self._shard  # positions of the global stream before this rank's next one
        while True:
            order = g.permutation(self._size) if self._shuffle else np.arange(self._size)
            mine = order[skip :: self._num_shards]
            yield from mine.tolist()
            skip = (skip - self._size) % self._num_shards


class InferenceSampler:
    """One epoch of every index, in order (reference: data/samplers.py:67):
    the whole dataset; the evaluation shards it itself, contiguously
    (``trainer/evaluation._shard_indices``)."""

    def __init__(self, size: int):
        self._indices = list(range(size))

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class _SeedWorker:
    """``worker_init_fn``: numpy's and ``random``'s global states from
    ``seed * 1000 + worker id`` (focoos_tpu/data/loaders.py:247)."""

    def __init__(self, seed: int, offset: int = 0):
        self.seed = seed
        self.offset = offset

    def __call__(self, worker_id: int) -> None:
        np.random.seed(self.seed * 1000 + self.offset + worker_id)
        random.seed(self.seed * 1000 + self.offset + worker_id)


class _Collate:
    """entries → (uint8 NHWC image tensor, targets) through the processor."""

    def __init__(self, processor, max_instances: int):
        self.processor = processor
        self.max_instances = max_instances

    def __call__(self, entries: List[DatasetEntry]):
        batch, targets = self.processor.preprocess_entries(entries, max_instances=self.max_instances)
        return torch.from_numpy(np.ascontiguousarray(batch)), targets


class TrainLoader:
    """The iterator of a DataLoader, with ``close()``: stop and reap its workers."""

    def __init__(self, loader: DataLoader):
        self._it = iter(loader)

    def __iter__(self) -> "TrainLoader":
        return self

    def __next__(self) -> Tuple[torch.Tensor, object]:
        if self._it is None:
            raise RuntimeError("the loader was closed; build a new one")
        return next(self._it)

    def close(self) -> None:
        it, self._it = self._it, None
        # the iterator of a DataLoader with workers stops them in _shutdown_workers (also run by its __del__)
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()


def build_train_loader(
    dataset,
    processor,
    total_batch_size: int,
    num_workers: int = 4,
    seed: int = 0,
    max_instances: int = 100,
    shuffle: bool = True,
    pin_memory: bool = False,
    timeout: float = 0,
    sampler: Optional[object] = None,
) -> TrainLoader:
    """Stream of (uint8 NHWC image batch, targets) on the CPU, the images
    pinned when ``pin_memory``; infinite over ``TrainingSampler`` (the
    default), one pass over a finite ``sampler``. In a process group each
    rank's batches hold ``total_batch_size / world`` entries; a batch that
    the world does not divide raises. ``timeout`` bounds the wait for a
    worker's batch in seconds (0: no bound)."""
    if total_batch_size < 1:
        raise ValueError(f"batch size must be >= 1, got {total_batch_size}")
    world, rank = mesh.get_world_size(), mesh.get_rank()
    if total_batch_size < world:
        raise ValueError(f"batch size {total_batch_size} is smaller than the {world} ranks")
    if total_batch_size % world:
        raise ValueError(f"batch size {total_batch_size} does not divide among the {world} ranks: each rank would "
                         f"train {total_batch_size // world} images a step, {total_batch_size // world * world} in all")
    per_rank = total_batch_size // world
    loader = DataLoader(
        dataset,
        batch_size=per_rank,
        sampler=TrainingSampler(len(dataset), shuffle=shuffle, seed=seed) if sampler is None else sampler,
        num_workers=num_workers,
        collate_fn=_Collate(processor, max_instances),
        pin_memory=pin_memory,
        timeout=timeout if num_workers > 0 else 0,
        worker_init_fn=_SeedWorker(seed, rank * num_workers),
        generator=torch.Generator().manual_seed(seed),  # the workers' torch seeds, without the global RNG
    )
    return TrainLoader(loader)


def trivial_batch_collator(entries: List[DatasetEntry]) -> List[DatasetEntry]:
    """(reference: datasets/common.py:46)"""
    return entries


def build_test_loader(dataset, batch_size: int = 8) -> DataLoader:
    """One epoch of list-of-entries batches, in order, mapped in the calling
    thread (reference: build_detection_test_loader loaders.py:135)."""
    return DataLoader(dataset, batch_size=batch_size, sampler=InferenceSampler(len(dataset)),
                      collate_fn=trivial_batch_collator)
