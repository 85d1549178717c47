"""EventStorage — global metric store for training (copy of
``focoos_tpu/trainer/events.py``, trimmed to the scalars, images and
histograms the port's trainer and hooks use; reference: focoos/trainer/events.py).

The port keeps its own copy so that it runs without ``focoos_tpu``. Same
stack-based API as the reference (``get_event_storage()`` inside hooks),
with median-smoothing HistoryBuffer.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() must be called inside a 'with EventStorage(...)' context"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Ring buffer of (value, iteration) with median/avg helpers
    (reference: trainer/events.py HistoryBuffer)."""

    def __init__(self, max_length: int = 1000000):
        self._max_length = max_length
        self._data: List[Tuple[float, float]] = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None) -> None:
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int = 20) -> float:
        return float(np.median([x[0] for x in self._data[-window_size:]]))

    def avg(self, window_size: int = 20) -> float:
        return float(np.mean([x[0] for x in self._data[-window_size:]]))

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return self._data


class EventStorage:
    """Scalar/image/histogram event store (reference: trainer/events.py:25-341)."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._vis_data: List[Tuple[str, np.ndarray, int]] = []
        self._histograms: List[dict] = []
        self._iter = start_iter

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, val: int) -> None:
        self._iter = int(val)

    def put_scalar(self, name: str, value: float, smoothing_hint: bool = True) -> None:
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = (value, self._iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None:
            assert existing == smoothing_hint, f"smoothing hint changed for {name}"
        else:
            self._smoothing_hints[name] = smoothing_hint

    def put_image(self, img_name: str, img: np.ndarray) -> None:
        self._vis_data.append((img_name, img, self._iter))

    def clear_images(self) -> None:
        self._vis_data = []

    def put_histogram(self, hist_name: str, values: np.ndarray, bins: int = 1000) -> None:
        counts, edges = np.histogram(np.asarray(values), bins=bins)
        self._histograms.append(dict(tag=hist_name, counts=counts, edges=edges, global_step=self._iter))

    def clear_histograms(self) -> None:
        self._histograms = []

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"No history metric '{name}'")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest(self) -> Dict[str, Tuple[float, int]]:
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int = 20) -> Dict[str, Tuple[float, int]]:
        result = {}
        for k, (v, itr) in self._latest_scalars.items():
            result[k] = (
                self._history[k].median(window_size) if self._smoothing_hints.get(k) else v,
                itr,
            )
        return result

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *a) -> None:
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()
