"""The port's profiling, timing, memory and TensorBoard utilities against the
JAX package's, on the CPU: ``utils/profiling.py`` parses one trace's events
as JAX's does; ``utils/timer.py``'s ``Timer`` keeps JAX's arithmetic;
``utils/memory.py``'s ``retry_if_oom`` retries once and re-raises (JAX's
third try on the CPU is left out on purpose); both packages'
``TensorboardWriter``s fed the same events write the same scalars."""

import glob
import gzip
import json
import os
import struct

import numpy as np
import pytest
import torch

from focoos_tpu.trainer import hooks as jax_hooks
from focoos_tpu.trainer.events import EventStorage as JaxEventStorage
from focoos_tpu.utils import profiling as jax_profiling
from focoos_tpu.utils import timer as jax_timer
from focoos_tpu_torch.trainer import hooks
from focoos_tpu_torch.trainer.events import EventStorage
from focoos_tpu_torch.utils import memory, profiling, timer


def _events(seed=0):
    """One trace: a host process with CPU ops and a device process ("GPU 0")
    with kernels on two streams (overlapping, nested and apart), a memcpy and
    a memset; metadata as Kineto writes it."""
    rng = np.random.default_rng(seed)
    ev = [{"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python3"}},
          {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}}]
    t = 1000.0
    for i in range(40):
        ev.append({"ph": "X", "cat": "cpu_op", "name": f"aten::op{i % 5}", "pid": 4242, "tid": 1, "ts": t,
                   "dur": float(rng.uniform(1, 9))})
        start = t + float(rng.uniform(0, 5))
        ev.append({"ph": "X", "cat": "kernel", "name": f"kernel_{i % 7}", "pid": 0, "tid": 7 + i % 2,
                   "ts": start, "dur": float(rng.uniform(0.5, 12)), "args": {"grid": [i, 1, 1]}})
        t += float(rng.uniform(2, 15))
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7, "ts": t, "dur": 4.5})
    ev.append({"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0, "tid": 7, "ts": t + 2, "dur": 1.0})
    return ev


def _write(tmp_path, events):
    """The events as JAX's parser finds them (``*.trace.json.gz`` under a
    directory) → the directory and the file."""
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return tmp_path, d / "host.trace.json.gz"


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_trace_matches_jax(tmp_path, seed):
    """JAX's parser reads the newest trace under a directory; the port's reads the file itself."""
    trace_dir, path = _write(tmp_path, _events(seed))
    ref_dur, ref_meta = jax_profiling.parse_trace(str(trace_dir))
    dur, meta = profiling.parse_trace(str(path))
    assert dict(dur) == dict(ref_dur) and meta == ref_meta
    assert profiling.parse_trace_busy_us(str(path)) == jax_profiling.parse_trace_busy_us(str(trace_dir))
    assert len(dur) == 9 and 0 < profiling.parse_trace_busy_us(str(path)) < sum(dur.values())


def test_busy_is_the_union_and_leaves_annotations_out(tmp_path):
    """A plain ``.json`` trace; an annotated range on the card's track
    (``gpu_user_annotation``, the optimizer's step) is no kernel."""
    events = [{"ph": "X", "cat": "kernel", "name": "a", "pid": 0, "tid": 7, "ts": 0.0, "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "b", "pid": 0, "tid": 8, "ts": 5.0, "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "c", "pid": 0, "tid": 7, "ts": 20.0, "dur": 1.5},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "pid": 0, "tid": 7, "ts": 0.0,
               "dur": 100.0}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.parse_trace_busy_us(str(path)) == 16.5
    assert dict(profiling.parse_trace(str(path))[0]) == {"a": 10.0, "b": 10.0, "c": 1.5}
    assert profiling.busy_us([(0, 10), (5, 15), (20, 21.5), (1, 2)]) == 16.5


def test_device_op_ms_on_the_cpu_runs_under_the_profiler(monkeypatch):
    """No card: there is no device time to read, so ``device_op_ms`` refuses
    before it runs anything (it used to return 0.0 ms of CPU-only profiling)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.device_op_ms(lambda: calls.append(torch.ones(8).sum()), n_calls=3)
    assert calls == []


def test_timer_matches_jax(monkeypatch):
    """The same clock readings give the same seconds, paused and resumed."""
    for mod in (jax_timer, timer):
        ticks = iter([10.0, 11.5, 12.0, 15.0, 16.25, 20.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.Timer()  # 10.0
        t.pause()  # 11.5
        t.resume()  # 12.0: 0.5 paused
        t.pause()  # 15.0
        assert t.seconds() == 15.0 - 10.0 - 0.5
        t.resume()  # 16.25: 1.75 paused in all
        assert t.seconds() == 20.0 - 10.0 - 1.75


def test_timer_and_took_on_the_cpu():
    with timer.Timer() as t:
        torch.ones(4).sum()
    assert t.elapsed >= 0.0

    @timer.took
    def f(x):
        return x + 1

    assert f(1) == 2


def test_retry_if_oom_retries_once_then_raises():
    calls = []

    @memory.retry_if_oom
    def once(n):
        calls.append(n)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return n * 2

    assert once(21) == 42 and calls == [21, 21]

    always = []

    @memory.retry_if_oom
    def never(n):
        always.append(n)
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.OutOfMemoryError):
        never(1)
    assert always == [1, 1]  # two tries, no third (JAX's) on the CPU

    @memory.retry_if_oom
    def other():
        always.append("other")
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        other()
    assert always[-1] == "other" and always.count("other") == 1


def _read_events(log_dir) -> list:
    """The (tag, step, value) scalars, image tags and histogram tags of the
    tfevents files under ``log_dir`` (TFRecord framing: length, CRC, data, CRC)."""
    from tensorboardX.proto import event_pb2

    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))):
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                kind = v.WhichOneof("value")
                out.append((v.tag, ev.step, round(float(v.simple_value), 6) if kind == "simple_value" else kind))
    return out


def test_tensorboard_writers_match_jax(tmp_path):
    pytest.importorskip("tensorboardX")
    img = np.random.default_rng(0).integers(0, 256, (8, 10, 3), dtype=np.uint8)
    got = {}
    for name, mod, storage_cls in (("jax", jax_hooks, JaxEventStorage), ("port", hooks, EventStorage)):
        log_dir = str(tmp_path / name)
        writer = mod.TensorboardWriter(log_dir)
        with storage_cls(0) as storage:
            for it in range(5):
                storage.iter = it
                storage.put_scalar("total_loss", 2.0 / (it + 1))
                storage.put_scalar("lr", 1e-3 * (it + 1), smoothing_hint=False)
                if it == 2:
                    storage.put_scalar("bbox/AP", 12.5, smoothing_hint=False)
                    storage.put_image("val_predictions", img)
                    storage.put_histogram("weights", np.arange(100.0), bins=10)
                if it % 2:
                    writer.write()
            writer.write()
        writer.close()
        got[name] = _read_events(log_dir)
    assert got["port"] == got["jax"]
    assert ("bbox/AP", 2, 12.5) in got["port"]
    assert any(kind == "image" for _, _, kind in got["port"]) and any(kind == "histo" for _, _, kind in got["port"])


def test_profiler_hook_opens_and_closes_on_call_boundaries(tmp_path):
    """Iterations [3, 5) at steps_per_call=2: the window opens before the call
    at iteration 2 (it holds 3) and closes after the call at 4; the Chrome
    trace it writes parses (CPU activity only here)."""
    from focoos_tpu_torch.trainer.trainer import TrainerLoop

    seen = []

    def step(state, batches):
        seen.append((len(batches), hook.profiler is not None and hook._active))
        return ("total_loss",), torch.ones(1)

    hook = hooks.ProfilerHook(str(tmp_path / "prof"), start_iter=3, num_iters=2)
    loop = TrainerLoop(step, None, iter([(torch.zeros(2), torch.zeros(2))] * 16), 8, torch.device("cpu"),
                       steps_per_call=2)
    loop.register_hooks([hook])
    loop.train()
    assert seen == [(2, False), (2, True), (2, True), (2, False)]
    assert hook.trace_path == str(tmp_path / "prof" / "profile_iter_2-5.pt.trace.json")
    dur, _ = profiling.parse_trace(hook.trace_path)
    assert dict(dur) == {}  # no card, no device events
