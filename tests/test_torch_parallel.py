"""The port's parallel layer on the CPU (gloo, two ranks): the samplers' rank
shards and per-rank batch against the JAX package's (``jax.process_index``
and ``process_count`` patched in the test), the evaluation's contiguous
shards against JAX's ``_shard_indices``, the evaluators' gathered states
merged as JAX merges them, ``all_gather_objects`` of ragged objects,
``launch`` (two ranks, a rank that raises, a world of 1 as a plain call),
the BatchNorms' global-batch statistics and the global draws and
normalizers against one process, the sharded evaluation of 7 images on two
ranks against one process (metrics to 1e-9), ``data_parallel`` serving
over two CPU replicas against the plain runtime, and the solver's global
gradient norm under two-rank ``dp`` and ``fsdp`` against one process with a
large gradient on a 0-d parameter that FSDP leaves whole.

One pair of ranks runs every check that needs a live group (``_two_ranks``,
module-level so that the spawned ranks import it); the test module imports
JAX only inside the tests, so that a spawned rank does not."""

import numpy as np
import pytest
import torch

from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.parallel.launch import launch


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads, as tests/test_torch_checkpoint.py's fixture (not
    imported from there: the spawned ranks import this module, and that one
    imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BN_TOL = 1e-5  # x max|ref|: fp32 sums in another order; the gradient crosses both all_reduces
AP_TOL = 1e-9
SIZE = 64
TINY_DETR = dict(image_size=SIZE, num_queries=10, transformer_predictor_dec_layers=1, num_classes=3,
                 backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False})


def _tiny_detr():
    from focoos_tpu_torch import ModelManager

    return ModelManager.get("fai-detr-l-coco", device="cpu", seed=0, **TINY_DETR)


def _norm_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 7, 3, generator=g) * 2.0 + 0.5
    gy = torch.randn(x.shape, generator=g)
    rows = torch.randn(9, 4, generator=g) * 3.0 - 1.0
    mask = torch.tensor([1, 0, 1, 1, 1, 0, 1, 0, 1], dtype=torch.bool)  # 3 valid rows of 5, 3 of 4: ranks differ
    g_rows = torch.randn(rows.shape, generator=g)
    return x, gy, rows, mask, g_rows


def _norm_step(x, gy, rows, mask, g_rows) -> tuple:
    """A BatchNorm and a MaskedBatchNorm1d in training, forward and backward
    → their outputs, input gradients, parameter gradients and statistics."""
    from focoos_tpu_torch.nn.layers.common import BatchNorm, MaskedBatchNorm1d

    torch.manual_seed(0)
    bn, mbn = BatchNorm(x.shape[1]).train(), MaskedBatchNorm1d(rows.shape[1]).train()
    with torch.no_grad():
        for m in (bn, mbn):
            m.weight.uniform_(0.5, 1.5)
            m.bias.normal_()
    x, rows = x.clone().requires_grad_(), rows.clone().requires_grad_()
    y, z = bn(x), mbn(rows, mask)
    ((y * gy).sum() + (z * g_rows).sum()).backward()
    return tuple(t.detach() for t in (y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var,
                                      z, rows.grad, mbn.weight.grad, mbn.bias.grad, mbn.running_mean, mbn.running_var))


GRAD_SCALE = 50.0  # the loss's pull on the 0-d scale: its gradient dominates the global norm


class _ScaledHead(torch.nn.Module):
    """A linear layer times a 0-d scale (as rtmo's ``Scale(())``), which FSDP leaves whole."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 3)
        self.scale = torch.nn.Parameter(torch.tensor(0.5))

    def forward(self, x):
        return self.fc(x) * self.scale


class _ScaledMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.a = torch.nn.Linear(4, 8)
        self.head = _ScaledHead()

    def forward(self, x, gy):
        """The step's loss: the rows' mean of <out, gy>, plus a large pull on the scale."""
        return (self.head(torch.relu(self.a(x))) * gy).sum(1).mean() + GRAD_SCALE * self.head.scale


def _grad_norm(mode, rows: slice) -> float:
    """``Solver.step``'s global gradient norm after one backward of
    ``_ScaledMLP`` on ``rows`` of a seeded batch of 8, under ``mode`` over
    the live group (None: one process)."""
    from focoos_tpu_torch.parallel.sharding import apply_sharding
    from focoos_tpu_torch.ports import TrainerArgs
    from focoos_tpu_torch.trainer.solver import Solver

    g = torch.Generator().manual_seed(4)
    x, gy = torch.randn(8, 4, generator=g), torch.randn(8, 3, generator=g)
    model = _ScaledMLP()
    step = model if mode is None else apply_sharding(model, model, mode, torch.device("cpu"))
    step(x[rows], gy[rows]).backward()
    solver = Solver(model, TrainerArgs(run_name="norm", optimizer="SGD", clip_gradients=0.1))
    return float(solver.step(0))


def _two_ranks(eval_entries: list) -> dict:
    """Every check of this module that needs a live group of two ranks →
    on rank 0, every rank's results."""
    torch.set_num_threads(1)
    from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

    rank = mesh.get_rank()
    out = {"rank": rank, "world": mesh.get_world_size(), "main": mesh.is_main_process()}
    # ragged objects, a different type and size a rank
    out["gathered"] = mesh.all_gather_objects({"rank": rank, "payload": np.arange(rank * 5 + 1)} if rank == 0 else
                                              ["a" * 1000, np.ones((rank + 2, 3))])
    out["broadcast"] = mesh.broadcast_object(f"from rank {rank}")
    # the BatchNorms on this rank's rows (3 and 3 of 6 images; 5 and 4 of 9 rows)
    x, gy, rows, mask, g_rows = _norm_inputs()
    xs, rs = slice(rank * 3, rank * 3 + 3), slice(0, 5) if rank == 0 else slice(5, 9)
    out["norms"] = _norm_step(x[xs], gy[xs], rows[rs], mask[rs], g_rows[rs])
    # a normalizer, a metric's sum, the rows' offsets and a global draw
    count = torch.tensor(float([0, 3][rank]))
    out["count"] = (float(mesh.global_count(count, 1.0)), float(mesh.global_sum(count)))
    out["span"] = mesh.row_span(5 if rank == 0 else 4, torch.device("cpu"))
    g = torch.Generator().manual_seed(7)
    out["rand"] = mesh.global_rand((5 if rank == 0 else 4, 3), g, torch.device("cpu"))
    out["rand_dim1"] = mesh.global_rand((2, 2, 3), torch.Generator().manual_seed(8), torch.device("cpu"), dim=1,
                                        span=(rank * 2, 4))
    out["mean"] = float(mesh.mean_across_ranks(torch.tensor(float(rank + 1))))
    # the clipped step's global gradient norm, rows 4r..4r+3 of 8 a rank
    out["grad_norm"] = {mode: _grad_norm(mode, slice(rank * 4, rank * 4 + 4)) for mode in ("dp", "fsdp")}
    mesh.synchronize()
    # the sharded evaluation: 4 and 3 of 7 images
    out["eval"] = evaluate_dataset(_tiny_detr(), eval_entries, batch_size=2)
    return mesh.all_gather_objects(out)


def _raise_on_rank_one():
    if mesh.get_rank() == 1:
        raise RuntimeError("rank 1 failed on purpose")
    mesh.synchronize()  # rank 0 waits for a rank that never comes: launch must not hang
    return "rank 0 done"


def _pseudo_gt_entries(model, n: int) -> list:
    """n seeded images with the model's own top detections as ground truth:
    a metric far from 0, so that a wrong merge shows."""
    from focoos_tpu_torch.ports import DatasetEntry
    from focoos_tpu_torch.structures import Boxes, Instances

    images = np.random.default_rng(3).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    blank = [DatasetEntry(image=im, height=SIZE, width=SIZE,
                          instances=Instances((SIZE, SIZE), boxes=Boxes(np.zeros((0, 4), np.float32)),
                                              classes=np.zeros(0, np.int64))) for im in images]
    outs = model.processor.eval_postprocess(model.forward(images), blank)
    entries = []
    for im, o in zip(images, outs):
        inst = o["instances"]
        top = np.argsort(-np.asarray(inst.scores), kind="stable")[:4]
        entries.append(DatasetEntry(image=im, height=SIZE, width=SIZE, instances=Instances(
            (SIZE, SIZE), boxes=Boxes(np.asarray(inst.boxes.tensor)[top]), classes=np.asarray(inst.classes)[top])))
    return entries


@pytest.fixture(scope="module")
def two_ranks():
    entries = _pseudo_gt_entries(_tiny_detr(), 7)
    return launch(_two_ranks, num_devices=2, args=(entries,), backend="gloo"), entries


# --------------------------------------------------------------------------- samplers and shards
@pytest.mark.parametrize("world", [2, 3])
def test_training_sampler_rank_shards_match_jax(monkeypatch, world):
    """Within the first epoch rank r of ``world`` takes ``order[r::world]``
    of the seeded permutation, as the JAX package's host ``r`` of ``world``;
    the shards partition it. Past the epoch's end (7 images: no world here
    divides it) the port's rank r goes on with the positions ``≡ r (mod
    world)`` of the one global stream (ROADMAP Queue 3, fixed in the port),
    where JAX's host restarts at ``r`` of the next permutation."""
    import jax

    from focoos_tpu.data.loaders import TrainingSampler as JaxTrainingSampler
    from focoos_tpu_torch.data.loaders import TrainingSampler

    n, per_rank = 7, 10
    one = iter(TrainingSampler(n, seed=5))
    global_stream = [next(one) for _ in range(per_rank * world)]
    streams = []
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(mesh, "get_rank", lambda r=r: r)
        monkeypatch.setattr(mesh, "get_world_size", lambda: world)
        ref, got = iter(JaxTrainingSampler(n, seed=5)), iter(TrainingSampler(n, seed=5))
        stream, jstream = [next(got) for _ in range(per_rank)], [next(ref) for _ in range(per_rank)]
        first = len(range(r, n, world))
        assert stream[:first] == jstream[:first]
        assert stream != jstream  # past the first epoch's end
        assert stream == global_stream[r::world]
        streams.append(stream)
    epoch = np.random.default_rng(5).permutation(n).tolist()
    for r, stream in enumerate(streams):
        assert stream[: len(epoch[r::world])] == epoch[r::world]
    assert sorted(i for r in range(world) for i in epoch[r::world]) == list(range(n))


def test_two_ranks_batches_are_one_process_batches_across_epochs(monkeypatch):
    """A dataset of 7 at B=4 on two ranks (2 a rank), with the rank and
    world set as ``mesh`` reads them and no process group: step by step the
    two ranks' batches together are one process's batch, over 8 steps, which
    cross four epoch ends; B=9 on two ranks raises, naming both numbers."""
    from focoos_tpu_torch.data import loaders

    class Identity:
        def preprocess_entries(self, entries, max_instances=0):
            return np.asarray(entries)[:, None], None

    def batches(rank, world, total):
        monkeypatch.setattr(loaders.mesh, "get_rank", lambda: rank)
        monkeypatch.setattr(loaders.mesh, "get_world_size", lambda: world)
        it = loaders.build_train_loader(list(range(7)), Identity(), total, num_workers=0, seed=3)
        out = [next(it)[0][:, 0].tolist() for _ in range(8)]
        it.close()
        return out

    one = batches(0, 1, 4)
    ranks = [batches(r, 2, 4) for r in range(2)]
    assert sum(len(b) for b in one) == 32  # four passes over the 7 images and more
    for step, b in enumerate(one):
        assert sorted(ranks[0][step] + ranks[1][step]) == sorted(b), step
        assert ranks[0][step] == b[0::2] and ranks[1][step] == b[1::2]
    monkeypatch.setattr(loaders.mesh, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="batch size 9 does not divide among the 2 ranks"):
        loaders.build_train_loader(list(range(7)), Identity(), 9, num_workers=0)


def test_train_loader_per_rank_batch_matches_jax(monkeypatch):
    """In a group of 2 the loader yields ``total_batch_size / 2`` entries a
    batch: rank 1's batch at each step is the odd rows of the JAX package's
    one-process loader's batch (its preprocess of the same entries), across
    the epoch ends of 7 images at B=6; a batch smaller than the ranks
    raises."""
    import jax

    from focoos_tpu.data.loaders import build_train_loader as jax_build_train_loader
    from focoos_tpu_torch.data import loaders
    from test_torch_train import N_TARGETS, _dataset, _tiny_configs

    from focoos_tpu.models.fai_detr.processor import DETRProcessor as JaxDETRProcessor
    from focoos_tpu_torch.models.fai_detr.processor import DETRProcessor

    monkeypatch.setattr(jax, "process_index", lambda: 0)
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    monkeypatch.setattr(loaders.mesh, "get_rank", lambda: 1)
    monkeypatch.setattr(loaders.mesh, "get_world_size", lambda: 2)
    jcfg, pcfg = _tiny_configs()
    ref = jax_build_train_loader(_dataset(7, jax_package=True), JaxDETRProcessor(jcfg, 96).train(True), 6,
                                 num_workers=0, seed=3, max_instances=N_TARGETS)
    got = loaders.build_train_loader(_dataset(7), DETRProcessor(pcfg, 96).train(True), 6, num_workers=0, seed=3,
                                     max_instances=N_TARGETS)
    for _ in range(3):
        images, targets = next(got)
        jb, jt = next(iter(ref))
        assert images.shape[0] == 3
        np.testing.assert_array_equal(images.numpy(), np.asarray(jb)[1::2])
        np.testing.assert_array_equal(targets.valid.numpy(), np.asarray(jt.valid)[1::2])
    got.close()
    with pytest.raises(ValueError, match="smaller than the 2 ranks"):
        loaders.build_train_loader(_dataset(3), DETRProcessor(pcfg, 96), 1, num_workers=0)


@pytest.mark.parametrize("n", [0, 1, 7, 16])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_indices_match_jax(n, world):
    from focoos_tpu.trainer.evaluation import _shard_indices as jax_shard_indices
    from focoos_tpu_torch.trainer.evaluation import _shard_indices

    shards = [_shard_indices(n, r, world) for r in range(world)]
    assert shards == [jax_shard_indices(n, r, world) for r in range(world)]
    assert [i for s in shards for i in s] == list(range(n))  # contiguous, in rank order, each once


def test_evaluator_states_merge_as_jax():
    """Each evaluator scores two halves of a case; the halves' states merged
    in order give the whole case's metrics, as the JAX package's merge does."""
    from test_torch_eval import _det_case, _entry, _kpt_case, _outputs_of

    from focoos_tpu.trainer.evaluation import evaluators as jax_ev
    from focoos_tpu_torch.trainer.evaluation import evaluators as ev

    gts, dets, hw = _det_case(4)
    kgts, kdets, khw = _kpt_case(5)
    cases = [
        ("detection", lambda m: m.DetectionEvaluator(num_classes=5), gts, dets, hw, False),
        ("keypoints", lambda m: m.KeypointEvaluator(), kgts, kdets, khw, True),
    ]
    for name, make, g, d, size, kp in cases:
        for jax_package, m in ((False, ev), (True, jax_ev)):
            entries = [_entry(jax_package, np.zeros((*size, 3), np.uint8), *size, gt[0], gt[1], gt[2],
                              gt[3] if kp else None) for gt in g]
            outputs = _outputs_of(jax_package, d, size, keypoints=kp)
            whole, halves = make(m), [make(m), make(m)]
            whole.process(entries, outputs)
            halves[0].process(entries[:3], outputs[:3])
            halves[1].process(entries[3:], outputs[3:])
            halves[0].load_gathered_states([h.state_for_gather() for h in halves])
            got, ref = halves[0].evaluate(), whole.evaluate()
            assert got == ref, (name, jax_package)
            if not jax_package:
                port_result = got
        assert port_result == got, name  # the port's merged metrics are JAX's
    rng = np.random.default_rng(6)
    for make in (lambda: ev.SemSegEvaluator(4), lambda: ev.ClassificationEvaluator(4)):
        whole, halves = make(), [make(), make()]
        for i in range(6):
            if isinstance(whole, ev.SemSegEvaluator):
                from focoos_tpu_torch.ports import DatasetEntry

                e = [DatasetEntry(sem_seg=rng.integers(0, 4, (8, 8)))]
                o = [{"sem_seg": rng.integers(0, 4, (8, 8))}]
            else:
                from focoos_tpu_torch.ports import DatasetEntry

                e = [DatasetEntry(label=[int(rng.integers(0, 4))])]
                o = [{"logits": rng.random(4)}]
            whole.process(e, o)
            halves[i // 3].process(e, o)
        halves[0].load_gathered_states([h.state_for_gather() for h in halves])
        assert halves[0].evaluate() == whole.evaluate()


# --------------------------------------------------------------------------- one process, no group
def test_world_of_one_is_a_plain_call():
    """No process group: rank 0 of 1, every helper the single-process
    computation, and ``launch`` a plain call in this process."""
    assert not mesh.is_initialized()
    assert (mesh.get_rank(), mesh.get_world_size(), mesh.is_main_process(), mesh.data_parallel()) == (0, 1, True, False)
    assert mesh.all_gather_objects({"a": 1}) == [{"a": 1}] and mesh.broadcast_object(3) == 3
    mesh.synchronize()
    t = torch.tensor(0.25)
    assert mesh.all_reduce_sum(t) is t and float(mesh.global_count(t, 1.0)) == 1.0 and mesh.global_sum(t) is t
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    assert torch.equal(mesh.global_rand((3, 2), g1, torch.device("cpu")), torch.rand((3, 2), generator=g2))
    assert mesh.row_span(4, torch.device("cpu")) == (0, 4)
    pid = []
    assert launch(lambda a, b: pid.append(1) or a + b, num_devices=1, args=(2, 3)) == 5 and pid == [1]
    assert not mesh.is_initialized()


# --------------------------------------------------------------------------- two ranks
def test_launch_two_ranks_and_all_gather_objects(two_ranks):
    ranks, _ = two_ranks
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["world"] == 2 for r in ranks)
    assert [r["main"] for r in ranks] == [True, False]
    for r in ranks:
        g = r["gathered"]
        assert g[0]["rank"] == 0 and np.array_equal(g[0]["payload"], np.arange(1))
        assert g[1][0] == "a" * 1000 and np.array_equal(g[1][1], np.ones((3, 3)))
        assert r["broadcast"] == "from rank 0"
        assert r["mean"] == 1.5


def test_launch_raises_when_a_rank_raises():
    """Rank 1 raises while rank 0 waits at a barrier: launch raises with
    rank 1's error, and returns (no rank is left waiting)."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        launch(_raise_on_rank_one, num_devices=2, backend="gloo")


def test_global_batchnorms_match_one_process(two_ranks):
    """BatchNorm (3 and 3 images) and MaskedBatchNorm1d (3 valid of 5 rows
    and 3 of 4) on two ranks against one process on the whole batch: the
    outputs and input gradients (concatenated), the parameter gradients (the
    ranks' sum, as DDP's reduction) and the running statistics (equal on
    both ranks)."""
    ranks, _ = two_ranks
    ref = _norm_step(*_norm_inputs())
    a, b = ranks[0]["norms"], ranks[1]["norms"]
    names = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
    for off in (0, 6):
        got = [torch.cat([a[off], b[off]]), torch.cat([a[off + 1], b[off + 1]]), a[off + 2] + b[off + 2],
               a[off + 3] + b[off + 3], a[off + 4], a[off + 5]]
        for name, g, r in zip(names, got, ref[off:off + 6]):
            torch.testing.assert_close(g, r, rtol=0, atol=BN_TOL * float(r.abs().max()), msg=f"{off} {name}")
        assert torch.equal(a[off + 4], b[off + 4]) and torch.equal(a[off + 5], b[off + 5])


def test_global_normalizers_and_draws(two_ranks):
    """``global_count``: max(Σ, floor) / world on every rank; ``global_sum``:
    Σ; ``row_span``: the offsets in rank order; ``global_rand``: each rank's
    rows of the one-process draw over every rank's rows."""
    ranks, _ = two_ranks
    assert [r["count"] for r in ranks] == [(1.5, 3.0)] * 2
    assert [r["span"] for r in ranks] == [(0, 9), (5, 9)]
    full = torch.rand((9, 3), generator=torch.Generator().manual_seed(7))
    assert torch.equal(torch.cat([ranks[0]["rand"], ranks[1]["rand"]]), full)
    full = torch.rand((2, 4, 3), generator=torch.Generator().manual_seed(8))
    assert torch.equal(torch.cat([ranks[0]["rand_dim1"], ranks[1]["rand_dim1"]], 1), full)


def test_fsdp_grad_norm_counts_whole_parameters_once(two_ranks):
    """The solver's global norm under 2-rank ``fsdp`` and ``dp`` equals one
    process's on the 8 rows: the 0-d scale, which FSDP leaves whole on every
    rank with its averaged gradient, counts once, not once a rank."""
    results, _ = two_ranks
    one = _grad_norm(None, slice(0, 8))
    assert one > 0.9 * GRAD_SCALE  # the scale's gradient dominates: counted twice, the norm would be ~41% larger
    for r in results:
        for mode, got in r["grad_norm"].items():
            assert abs(got - one) <= 1e-6 * one, (r["rank"], mode, got, one)


def test_sharded_evaluation_matches_one_process(two_ranks):
    """7 images on two ranks (4 and 3): both ranks return the metrics of one
    process's ``evaluate_dataset`` on all 7, to 1e-9."""
    from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

    ranks, entries = two_ranks
    ref = evaluate_dataset(_tiny_detr(), entries, batch_size=2)
    assert ref["bbox"]["AP"] > 50  # the model's own detections: a wrong merge shows
    for r in ranks:
        assert sorted(r["eval"]["bbox"]) == sorted(ref["bbox"])
        for k, v in ref["bbox"].items():
            assert abs(r["eval"]["bbox"][k] - v) <= AP_TOL, (r["rank"], k, r["eval"]["bbox"][k], v)


# --------------------------------------------------------------------------- data-parallel serving
def test_data_parallel_serving_equals_the_plain_runtime():
    """A replica on each of two CPU devices: a batch of 3 (padded to 4, split
    2 and 2, cropped back) gives the plain runtime's outputs; one device is
    the plain runtime; an exported program refuses it."""
    from focoos_tpu_torch.infer import runtimes
    from focoos_tpu_torch.ports import RuntimeType

    model = _tiny_detr()
    names = model.processor.get_output_names()
    plain = runtimes.load_runtime(RuntimeType.CPU, module=model.module, output_names=names, device=torch.device("cpu"))
    x = np.random.default_rng(4).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    ref = [t.clone() for t in plain(x)]
    dp = runtimes.load_runtime(RuntimeType.CPU, module=model.module, output_names=names, device=torch.device("cpu"),
                               data_parallel=True, devices=["cpu", "cpu"])
    assert isinstance(dp, runtimes.DataParallelRuntime) and len(dp.replicas) == 2
    got = dp(x)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()))
    one = runtimes.load_runtime(RuntimeType.CPU, module=model.module, output_names=names, device=torch.device("cpu"),
                                data_parallel=True)
    assert type(one) is runtimes.TorchRuntime
    with pytest.raises(ValueError, match="data_parallel"):
        runtimes.load_runtime(RuntimeType.TORCH_EXPORT, artifact_path="x.pt2", output_names=names, data_parallel=True)
