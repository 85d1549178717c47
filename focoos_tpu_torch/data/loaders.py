"""The port's training loader: in-process, one host (port of the sampler and
``build_train_loader`` of focoos_tpu/data/loaders.py; reference:
focoos/data/loaders.py:94).

``TrainingSampler`` draws the same ``np.random.default_rng(seed)``
permutations as the JAX package's (one shard: the port runs one process), so
both packages see the same batches. ``build_train_loader`` maps and collates
in the calling thread through the processor's ``preprocess_entries``. The
worker-process prefetcher and the evaluation loader are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from focoos_tpu_torch.ports import DatasetEntry


class TrainingSampler:
    """Infinite shuffled index stream (reference: data/samplers.py:10)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0):
        self._size = size
        self._shuffle = shuffle
        self._seed = seed

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self._seed)
        while True:
            order = g.permutation(self._size) if self._shuffle else np.arange(self._size)
            yield from order.tolist()


def build_train_loader(
    dataset,
    processor,
    total_batch_size: int,
    seed: int = 0,
    max_instances: int = 100,
    shuffle: bool = True,
    pin_memory: bool = False,
) -> Iterator[Tuple[torch.Tensor, object]]:
    """Infinite stream of (uint8 NHWC batch, targets) on the CPU, the batch
    pinned when ``pin_memory`` (for a non-blocking copy to the card)."""
    if total_batch_size < 1:
        raise ValueError(f"batch size must be >= 1, got {total_batch_size}")
    indices = iter(TrainingSampler(len(dataset), shuffle=shuffle, seed=seed))
    while True:
        entries: List[DatasetEntry] = [dataset[next(indices)] for _ in range(total_batch_size)]
        batch, targets = processor.preprocess_entries(entries, max_instances=max_instances)
        images = torch.from_numpy(np.ascontiguousarray(batch))
        yield (images.pin_memory() if pin_memory else images), targets
