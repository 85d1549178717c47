"""Evaluation loop and evaluators (port of focoos_tpu/trainer/evaluation/;
reference: focoos/trainer/evaluation/).

``inference_on_dataset`` computes what the JAX package's does, in one process
on the model's device: each entry of the dataset once, in order, in batches
of ``batch_size`` (the last one short: nothing is padded to a static shape).
A producer thread, two batches ahead, reads each entry (a ``MapDataset``
reads and maps it from disk there), preprocesses a batch and copies it to
the card (pinned memory, a side stream, an event the forward waits on). The
consumer runs a software pipeline: batch k's forward is queued, then batch
k-1 is postprocessed and scored on the host. Right behind each batch's
forward the loop queues the device half of the processor's decode
(``Processor.eval_decode``: the output itself for fai_detr and rtmo, the
label map or the packed instance masks for fai_mf), then copies that
decode's tensors to pinned host memory, and an event marks the copy:
waiting on that event after queuing batch k's forward waits for the copy
alone, where a copy queued behind batch k's forward would wait for it. A
field whose metadata says ``device`` stays on the card (fai_mf's packed
masks, which the evaluator's mask IoU reads there). ``stats`` holds the last
run's batches and bytes copied to the host.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from focoos_tpu_torch.trainer.evaluation.evaluators import (
    ClassificationEvaluator,
    DatasetEvaluator,
    DatasetEvaluators,
    DetectionEvaluator,
    InstanceSegmentationEvaluator,
    KeypointEvaluator,
    PanopticEvaluator,
    SemSegEvaluator,
    get_evaluator,
)
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

__all__ = [
    "ClassificationEvaluator",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "DetectionEvaluator",
    "InstanceSegmentationEvaluator",
    "KeypointEvaluator",
    "PanopticEvaluator",
    "SemSegEvaluator",
    "get_evaluator",
    "inference_on_dataset",
    "print_csv_format",
    "evaluate_dataset",
]

_END = object()
stats = {"batches": 0, "host_bytes": 0}


def _to_host(output, device: torch.device):
    """(``output`` with every tensor field, except those marked ``device``,
    copied to pinned host memory, the event that marks the copies) for a card
    output; (``output``, None) on the CPU."""
    if device.type != "cuda":
        return output, None
    fields = {}
    for f in dataclasses.fields(output):
        t = getattr(output, f.name)
        if isinstance(t, torch.Tensor) and not f.metadata.get("device"):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            fields[f.name] = host.copy_(t, non_blocking=True)
            stats["host_bytes"] += t.numel() * t.element_size()
    done = torch.cuda.Event()
    done.record()
    return dataclasses.replace(output, **fields), done


def inference_on_dataset(model, dataset, evaluator: DatasetEvaluator, batch_size: int = 8) -> Dict:
    """Batched evaluation of ``model`` (a FocoosModel in eval mode) on a
    sequence of DatasetEntry, with data and compute timing
    (reference: trainer/evaluation/evaluator.py:115-236) → the evaluator's results."""
    evaluator.reset()
    stats.update(batches=0, host_bytes=0)
    n = len(dataset)
    device = model.device
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    total_compute, total_data = 0.0, 0.0
    start = time.perf_counter()

    def batches():
        for i in range(0, n, batch_size):
            t0 = time.perf_counter()
            entries = [dataset[j] for j in range(i, min(i + batch_size, n))]
            batch, _ = model.processor.preprocess(entries)
            x = torch.from_numpy(np.ascontiguousarray(batch))
            ready = None
            if cuda:
                with torch.cuda.stream(copy_stream):
                    x = x.pin_memory().to(device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record()
            yield entries, x, ready, time.perf_counter() - t0

    q: "queue.Queue" = queue.Queue(maxsize=2)  # two batches ahead
    stop = threading.Event()
    producer_error: List[BaseException] = []

    def producer():
        try:
            for item in batches():
                q.put(item)
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            producer_error.append(e)
        finally:
            q.put(_END)

    thread = threading.Thread(target=producer, name="eval-producer", daemon=True)
    thread.start()

    def consume(pending) -> None:
        """Wait for a batch's copy to the host, postprocess it and score it."""
        nonlocal total_compute
        entries, out, copied = pending
        t1 = time.perf_counter()
        if copied is not None:
            copied.synchronize()
        results = model.processor.eval_postprocess(out, entries)
        total_compute += time.perf_counter() - t1
        evaluator.process(entries, results)

    pending = None
    try:
        while True:
            item = q.get()
            if item is _END:
                if producer_error:
                    raise producer_error[0]
                break
            entries, x, ready, data_time = item
            total_data += data_time
            if ready is not None:
                torch.cuda.current_stream(device).wait_event(ready)
                x.record_stream(torch.cuda.current_stream(device))
            out = model.processor.eval_decode(model.forward(x), entries)
            stats["batches"] += 1
            prev, pending = pending, (entries, *_to_host(out, device))
            if prev is not None:
                consume(prev)
        if pending is not None:
            consume(pending)
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()

    results = evaluator.evaluate()
    logger.info(
        f"Evaluated {n} images in {time.perf_counter() - start:.1f}s "
        f"(compute {total_compute:.1f}s, data {total_data:.1f}s)"
    )
    return results


def evaluate_dataset(model, dataset, batch_size: int = 8, evaluator: Optional[DatasetEvaluator] = None) -> Dict:
    """Build the task evaluator for ``model`` and run inference_on_dataset."""
    if evaluator is None:
        evaluator = get_evaluator(model.task, len(model.classes), model.classes)
    return inference_on_dataset(model, dataset, evaluator, batch_size=batch_size)


def print_csv_format(results: Dict) -> None:
    """Log evaluator results as copy-pasteable task,metric,value lines
    (reference: trainer/evaluation/utils.py:9)."""
    for task in sorted(results):
        res = results[task]
        if not isinstance(res, dict):
            logger.info(f"{task}: {res}")
            continue
        important = {k: v for k, v in res.items() if "-" not in k}
        logger.info(f"copypaste: Task: {task}")
        logger.info("copypaste: " + ",".join(important.keys()))
        logger.info("copypaste: " + ",".join(f"{v:.4f}" if isinstance(v, float) else str(v) for v in important.values()))
