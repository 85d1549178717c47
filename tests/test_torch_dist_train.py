"""Data-parallel and FSDP training steps on two ranks (gloo, the CPU) against
one process and the JAX package, for every family.

Each family's tiny model (its one-step parity test's configuration) takes
one SGD step on a global batch of 4, 2 images a rank, through the trainer's
step module wrapped for ``dp`` (DistributedDataParallel) and ``fsdp``
(FSDP2), with the family's own loss and draws:

- the 2-rank ``dp`` step against JAX's single-device step on the global
  batch and the same numpy weights, within the tolerance of the family's
  one-step parity test (fai_detr and the mask-classification families in
  fp32, fai_cls and rtmo in fp64 as their tests run), carrying JAX's draws
  where that test carries them (fai_mf and bisenetformer: the matcher's
  and the loss's points and the cross-attention masks, each rank its rows);
- the 2-rank ``dp`` step against the port's one-process step on the global
  batch, losses ``DP_RTOL``, with the family's own draws (the global batch's
  draw, of which each rank keeps its rows), both in fp64: in fp32 the
  BatchNorms' statistics summed in another order move the losses of the
  tiny models at random init by up to ~1e-5 alone;
- ``fsdp`` against ``dp``, losses and gradient norm ``FSDP_RTOL``;
- two planted faults that must fail the ``DP_RTOL`` gate: the loss
  normalizer of each rank's own rows (fai_cls, whose batch mean needs no
  reduction at equal shares: each rank's own dropout draw) and each rank's
  own BatchNorm statistics.

One pair of ranks runs every family's runs of a file (``_rank_runs``,
module-level: the spawned ranks import this module, which imports JAX only
inside its functions), in a thread while this process computes the
references. This file holds fai_detr and fai_cls;
``tests/test_torch_dist_train_{rtmo,mf,bisenet}.py`` run the same checks on
the other three families, a file each, so that each file stays well under a
minute alone on the CPU (JAX compiles each family's step).
"""

import contextlib
import dataclasses
import importlib
import threading

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


B = 4  # the global batch: 2 images a rank
LR = 1e-3
DP_RTOL = 1e-5  # 2 ranks against one process, every loss: sums in another order
FSDP_RTOL = 1e-6  # fsdp against dp: the same reductions, the gradient norm over shards
RANKS_TIMEOUT_S = 600  # the ranks' runs take under a minute alone
FAMILIES = ("fai_detr", "fai_cls")  # this file's; tests/test_torch_dist_train_{rtmo,mf,bisenet}.py the others'


# --------------------------------------------------------------------------- the step (ranks and this process)
def _config(job: dict, mode: str):
    """The port config of a run: ``pcfg`` for the own draws, ``pcfg_jax`` (where given) beside JAX."""
    return job["pcfg"] if mode == "own" else job.get("pcfg_jax", job["pcfg"])


@contextlib.contextmanager
def _fp64_msda():
    """Within the block fp64 values take the MSDA plain version (the wrapper
    takes fp32 and bf16 only), fp32 the wrapper, as ``chip_smoke.cpu_fp64`` does."""
    import focoos_tpu_torch.models.fai_detr.modelling as modelling
    from focoos_tpu_torch.ops.deformable import ms_deform_attn

    real = modelling.msda_forward
    modelling.msda_forward = lambda v, *a: ms_deform_attn(v, *a) if v.dtype == torch.float64 else real(v, *a)
    try:
        yield
    finally:
        modelling.msda_forward = real


def _module(job: dict, mode: str) -> torch.nn.Module:
    from focoos_tpu_torch.model_manager import ModelManager
    from focoos_tpu_torch.nn.layers.common import set_compute_dtype
    from focoos_tpu_torch.utils.weights import from_jax_variables

    ModelManager._ensure_family_registered(job["family"])
    module = ModelManager._builders[job["family"]](_config(job, mode))
    module.load_state_dict(from_jax_variables(job["flat"], job["family"]), strict=True)
    dtype = torch.float64 if mode == "own" else job["dtype"]
    module.to(dtype)
    set_compute_dtype(module, dtype)
    return module


def _rows(t, rows: slice):
    """A batch-first dataclass of tensors (a family's targets) at ``rows``."""
    return type(t)(*(getattr(t, f.name)[rows] for f in dataclasses.fields(t)))


def _loss_fn(job: dict, module, mode: str, rows: slice):
    """The family's loss on this rank's rows: ``make_loss_fn`` (its own draws)
    with ``mode`` "own", or with JAX's config and carried draws with "jax"."""
    cfg = _config(job, mode)
    c = job.get("carried") if mode == "jax" else None
    if c is None:
        return importlib.import_module(f"focoos_tpu_torch.models.{job['family']}.loss").make_loss_fn(module, cfg)
    from focoos_tpu_torch.models.fai_mf.loss import CriterionDraws, maskformer_criterion

    valid = job["targets"].valid
    n = valid.shape[1]
    draws = CriterionDraws(match_coords=c["match_pts"][:, rows],
                           loss_coords=c["loss_coords"][:, rows.start * n:rows.stop * n][:, valid[rows].reshape(-1)])
    allowed = [a[rows] for a in c["allowed"]]

    def loss_fn(images, targets):
        _, aux = module(images, allowed=allowed)
        losses, _ = maskformer_criterion(aux, targets, cfg, carried=draws)
        total = losses.pop("total")
        return total, losses

    return loss_fn


class _planted:
    """A fault the 2-rank gate must catch: ``count``, each rank's own loss
    normalizer; ``draw``, each rank's own draw; ``bn``, each rank's own
    BatchNorm statistics."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        self.saved = mesh.global_count, mesh.global_rand, mesh.all_reduce_sum
        if self.fault == "count":
            mesh.global_count = lambda x, floor: x.clamp(min=floor)
        elif self.fault == "draw":
            mesh.global_rand = lambda shape, generator, device, dim=0, span=None: torch.rand(
                tuple(shape), generator=generator, device=device)
        elif self.fault == "bn":
            mesh.all_reduce_sum = lambda t: t

    def __exit__(self, *exc):
        mesh.global_count, mesh.global_rand, mesh.all_reduce_sum = self.saved


def _step(job: dict, mode: str, sharding=None, fault=None) -> dict:
    """One SGD step of a fresh module on this rank's rows of the global batch
    (every row without a group), through the trainer's step module wrapped
    for ``sharding`` → the metrics (the ranks' mean) and the full gradients
    in JAX's layout."""
    from focoos_tpu_torch.parallel.sharding import apply_sharding, full
    from focoos_tpu_torch.ports import TrainerArgs
    from focoos_tpu_torch.trainer.solver import Solver
    from focoos_tpu_torch.trainer.train_step import build_train_step, create_train_state
    from focoos_tpu_torch.trainer.trainer import _StepModule
    from focoos_tpu_torch.utils.weights import to_jax_variables

    b = B // mesh.get_world_size()
    rows = slice(mesh.get_rank() * b, (mesh.get_rank() + 1) * b)
    module = _module(job, mode)
    with _planted(fault):
        loss_fn = _loss_fn(job, module, mode, rows)
        run = loss_fn if sharding is None else apply_sharding(_StepModule(module, loss_fn), module, sharding,
                                                              torch.device("cpu"))
        args = TrainerArgs(run_name="step", optimizer="SGD", learning_rate=LR, clip_gradients=0.0, max_iters=1)
        state = create_train_state(module, Solver(module, args))
        keys, packed = build_train_step(run)(state, job["images"][rows], _rows(job["targets"], rows))
    grads = {n: full(p.grad).detach().double().numpy() for n, p in module.named_parameters()}
    return {"metrics": dict(zip(keys, packed.tolist())), "grads": to_jax_variables(grads, job["family"])}


def _separate_jax_run(job: dict) -> bool:
    """Whether the step held against JAX differs from the own-draw runs: in
    its dtype (the own runs are fp64), its config or its carried draws."""
    return job["dtype"] != torch.float64 or job.get("carried") is not None or "pcfg_jax" in job


def _runs(job: dict) -> list:
    """(name, mode, sharding, fault) of the 2-rank runs of ``job``."""
    first = "draw" if job["family"] == "fai_cls" else "count"
    runs = [("dp", "own", "dp", None), ("fsdp", "own", "fsdp", None), (f"fault {first}", "own", "dp", first),
            ("fault bn", "own", "dp", "bn")]
    if _separate_jax_run(job):
        runs.insert(0, ("dp jax", "jax", "dp", None))
    return runs


def _rank_runs(jobs: list) -> dict:
    """Every job's runs on this rank → on rank 0, {(family, run): result},
    each with every rank's metrics beside."""
    torch.set_num_threads(2)
    out = {}
    with _fp64_msda():
        for job in jobs:
            for name, mode, sharding, fault in _runs(job):
                res = _step(job, mode, sharding, fault)
                res["rank_metrics"] = mesh.all_gather_objects(res["metrics"])
                out[(job["family"], name)] = res
    return out


# --------------------------------------------------------------------------- the references (this process)
def _jax_value_and_grad(loss_module, jmodel, flat: dict, batch, dtype) -> dict:
    """``jax.value_and_grad`` of the JAX package's ``make_loss_fn`` → losses and
    gradients (flat numpy) and the global norm of the gradients."""
    import jax
    import optax

    from focoos_tpu.utils.checkpoint import flatten_tree, unflatten_tree

    loss_fn = loss_module.make_loss_fn(jmodel, jmodel.config)
    jv = unflatten_tree({k: v.astype(dtype) for k, v in flat.items()})

    def total_fn(params):
        total, (losses, _) = loss_fn({"params": params, "batch_stats": jv["batch_stats"]}, batch,
                                     jax.random.PRNGKey(0))
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jv["params"])
    return dict(losses=dict({k: float(v) for k, v in losses.items()}, total_loss=float(total)),
                grads={k: np.asarray(v, np.float64) for k, v in flatten_tree(grads, prefix="params/").items()},
                grad_norm=float(optax.global_norm(grads)))


def _case_fai_detr():
    import jax.numpy as jnp
    from test_torch_fai_detr import _tiny_configs
    from test_torch_mf_train import seeded_flat
    from test_torch_train import GRAD_NORM_RTOL, GRAD_TOL, LOSS_RTOL, _jax_targets, _port_targets, _targets

    import focoos_tpu.models.fai_detr.loss as jax_loss
    from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
    from focoos_tpu.nn.backbone.resnet import ResNet as JaxResNet
    from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr
    from focoos_tpu_torch.nn.backbone.resnet import ResNet

    jcfg, pcfg = _tiny_configs()
    jmodel = JaxFAIDetr(config=jcfg, backbone=JaxResNet(config=jcfg.backbone_config))
    flat = seeded_flat(FAIDetr(pcfg, ResNet(pcfg.backbone_config)), "fai_detr", jmodel)
    images = np.random.default_rng(1).integers(0, 256, (B, 96, 96, 3), dtype=np.uint8)
    tgt = _targets(2, b=B)  # 3, 4, 5 and 5 boxes: ranks of 7 and 10
    job = dict(family="fai_detr", pcfg=pcfg, flat=flat, dtype=torch.float32, images=torch.from_numpy(images),
               targets=_port_targets(*tgt))

    def ref():
        return _jax_value_and_grad(jax_loss, jmodel, flat, (jnp.asarray(images), _jax_targets(*tgt)), np.float32)

    return job, ref, dict(loss=LOSS_RTOL, grad_norm=GRAD_NORM_RTOL, grad=(GRAD_TOL, None))


def _mask_case(family: str):
    """fai_mf or bisenetformer, with the points JAX drew and its attention masks carried."""
    from test_torch_mf_train import (POINTS, TINY_MF, jax_train_step, mask_targets, port_targets, seeded_flat,
                                     tiny_configs)

    from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
    from focoos_tpu_torch.model_manager import BackboneManager

    if family == "fai_mf":
        from focoos_tpu.models.fai_mf.modelling import FAIMaskFormer as JaxModel
        from focoos_tpu_torch.models.fai_mf.modelling import FAIMaskFormer as Model

        card, over, stride, rtol = "fai-mf-s-coco-ins", TINY_MF, 4, 1e-5
    else:
        from test_torch_bisenetformer import TINY

        from focoos_tpu.models.bisenetformer.modelling import BisenetFormer as JaxModel
        from focoos_tpu_torch.models.bisenetformer.modelling import BisenetFormer as Model

        card, over, stride, rtol = "bisenetformer-l-ade", TINY, 8, 1e-4  # its fp32 step test's tolerance
    jcfg, pcfg = tiny_configs(family, card, **over)
    jmodel = JaxModel(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config))
    flat = seeded_flat(Model(pcfg, BackboneManager.from_config(pcfg.backbone_config)), family, jmodel)
    images = np.random.default_rng(1).integers(0, 256, (B, 96, 96, 3), dtype=np.uint8)
    targets = mask_targets(2, b=B, hm=96 // stride, wm=96 // stride)  # 4, 6, 6 and 6 masks: ranks of 10 and 12
    match_pts = np.random.default_rng(4).random((3, B, 1, POINTS, 2)).astype(np.float32)
    job = dict(family=family, pcfg=pcfg, flat=flat, dtype=torch.float32, images=torch.from_numpy(images),
               targets=port_targets(*targets))
    ref = jax_train_step(jmodel, jcfg, flat, images, targets, match_pts)  # its draws are the job's
    job["carried"] = dict(match_pts=torch.from_numpy(match_pts), loss_coords=torch.from_numpy(ref["loss_coords"]),
                          allowed=[torch.from_numpy(a) for a in ref["allowed"]])
    losses = dict(ref["losses"], total_loss=ref["total"])
    return job, lambda: dict(losses=losses), dict(loss=rtol)


def _case_fai_cls():
    import jax
    import jax.numpy as jnp
    from test_torch_cls import GRAD_FLOOR, GRAD_TOL, LOSS_RTOL, build, images, labels_of, tiny_configs

    import focoos_tpu.models.fai_cls.loss as jax_loss
    from focoos_tpu.models.fai_cls.ports import ClassificationTargets as JaxClsTargets
    from focoos_tpu_torch.models.fai_cls.ports import ClassificationTargets

    x, lab = images(4, b=B), labels_of(5, b=B)
    with jax.enable_x64(True):
        jmodel, _, flat = build("one-layer", seed=6, dtype=jnp.float64, dropout_rate=0.0)
    _, pcfg = tiny_configs(dropout_rate=0.5)  # the own runs draw dropout: each rank keeps its rows of one draw
    _, pcfg_jax = tiny_configs(dropout_rate=0.0)  # as its parity test: dropout is the head's only draw
    job = dict(family="fai_cls", pcfg=pcfg, pcfg_jax=pcfg_jax, flat=flat, dtype=torch.float64,
               images=torch.from_numpy(x), targets=ClassificationTargets(torch.from_numpy(lab)))

    def ref():
        with jax.enable_x64(True):
            return _jax_value_and_grad(jax_loss, jmodel, flat, (jnp.asarray(x), JaxClsTargets(jnp.asarray(lab))),
                                       np.float64)

    return job, ref, dict(loss=LOSS_RTOL, grad=(GRAD_TOL, GRAD_FLOOR))


def _case_rtmo():
    import jax
    import jax.numpy as jnp
    from test_torch_rtmo_train import GRAD_FLOOR, GRAD_TOL, LOSS_RTOL, SIZE, build, jax_targets, person_targets
    from test_torch_rtmo_train import port_targets

    import focoos_tpu.models.rtmo.loss as jax_loss

    x = np.random.default_rng(10).integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    targets = person_targets(11, counts=(1, 1, 4, 4))  # ranks of 2 and 8 people
    with jax.enable_x64(True):
        jmodel, port, flat = build(dtype=jnp.float64)
    job = dict(family="rtmo", pcfg=port.config, flat=flat, dtype=torch.float64, images=torch.from_numpy(x),
               targets=port_targets(targets))

    def ref():
        with jax.enable_x64(True):
            return _jax_value_and_grad(jax_loss, jmodel, flat, (jnp.asarray(x), jax_targets(targets)), np.float64)

    return job, ref, dict(loss=LOSS_RTOL, grad=(GRAD_TOL, GRAD_FLOOR))


CASES = {"fai_detr": _case_fai_detr, "fai_mf": lambda: _mask_case("fai_mf"),
         "bisenetformer": lambda: _mask_case("bisenetformer"), "fai_cls": _case_fai_cls, "rtmo": _case_rtmo}


def _family_results(families) -> dict:
    """The 2-rank runs (a thread waits on them) beside JAX's steps and the
    port's one-process steps here → {family: {...}}."""
    cases = {f: CASES[f]() for f in families}
    jobs = [cases[f][0] for f in families]
    ranked, failed = {}, []

    def ranks():
        try:
            ranked.update(launch(_rank_runs, num_devices=2, args=(jobs,), backend="gloo"))
        except BaseException as e:  # raised in the tests
            failed.append(e)

    thread = threading.Thread(target=ranks, daemon=True)
    thread.start()
    out = {}
    with _fp64_msda():
        for f in families:
            job, ref, tol = cases[f]
            out[f] = dict(job=job, jax=ref(), tol=tol, one={"own": _step(job, "own")})
            if _separate_jax_run(job):
                out[f]["one"]["jax"] = _step(job, "jax")
    thread.join(timeout=RANKS_TIMEOUT_S)
    assert not thread.is_alive(), f"the ranks ran past {RANKS_TIMEOUT_S} s"
    if failed:
        raise failed[0]
    for f in families:
        out[f]["ranks"] = {name: ranked[(f, name)] for name, *_ in _runs(out[f]["job"])}
    return out


@pytest.fixture(scope="module")
def results():
    return _family_results(FAMILIES)


def _rel(got: dict, ref: dict, keys) -> dict:
    return {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in keys}


# --------------------------------------------------------------------------- the checks, each family's
def check_matches_jax(results, family):
    """The 2-rank dp step on the global batch against JAX's single-device
    step: every loss, and the gradients (the global norm, or each tensor
    where the family's parity test compares them)."""
    r = results[family]
    got = r["ranks"].get("dp jax", r["ranks"]["dp"])
    ref, tol = r["jax"], r["tol"]
    assert sorted(got["metrics"]) == sorted(list(ref["losses"]) + ["grad_norm"])
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=tol["loss"], err_msg=f"{family} {k}")
    if "grad_norm" in tol:
        np.testing.assert_allclose(got["metrics"]["grad_norm"], ref["grad_norm"], rtol=tol["grad_norm"])
    if "grad" in tol:
        from test_torch_rtmo_train import ZERO_GRADS

        rtol, floor = tol["grad"]
        assert sorted(got["grads"]) == sorted(ref["grads"])
        for k, want in ref["grads"].items():
            g = got["grads"][k]
            if family == "rtmo" and k in ZERO_GRADS:  # 0 in exact arithmetic
                assert np.abs(want).max() < 1e-6 and np.abs(g).max() < 1e-6, k
            elif floor is None:  # fai_detr's fp32 gate: ||port - JAX|| <= tol ||JAX|| + 1e-6 sqrt(size)
                assert np.linalg.norm(g - want) <= rtol * np.linalg.norm(want) + 1e-6 * np.sqrt(want.size), k
            else:
                np.testing.assert_allclose(g, want, rtol=0, atol=rtol * np.abs(want).max() + floor, err_msg=k)


def check_matches_one_process(results, family):
    """With the family's own draws, in fp64: the 2-rank dp step's losses and
    gradient norm within DP_RTOL of one process on the global batch; every
    rank logged the same metrics. Beside JAX (fp32 for fai_detr and the
    mask-classification families, on JAX's draws): within the family's JAX
    loss tolerance of one process, the gradient norm 1e-3."""
    r = results[family]
    got, ref = r["ranks"]["dp"], r["one"]["own"]
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    assert all(m == got["metrics"] for m in got["rank_metrics"])
    errs = _rel(got["metrics"], ref["metrics"], list(ref["metrics"]))
    assert max(errs.values()) <= DP_RTOL, errs
    if "dp jax" in r["ranks"]:
        errs = _rel(r["ranks"]["dp jax"]["metrics"], r["one"]["jax"]["metrics"], list(ref["metrics"]))
        assert errs.pop("grad_norm") <= 1e-3, "grad_norm"  # fai_detr's parity tolerance for it, in fp32
        assert max(errs.values()) <= r["tol"]["loss"], errs


def check_fsdp_matches_dp(results, family):
    """fsdp against dp on two ranks: every metric within FSDP_RTOL, every
    gradient (gathered from the shards) within FSDP_RTOL of its max."""
    r = results[family]
    got, ref = r["ranks"]["fsdp"], r["ranks"]["dp"]
    errs = _rel(got["metrics"], ref["metrics"], list(ref["metrics"]))
    assert max(errs.values()) <= FSDP_RTOL, errs
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], want, rtol=0, atol=FSDP_RTOL * max(np.abs(want).max(), 1e-12),
                                   err_msg=k)


def check_planted_faults_fail(results, family):
    """A rank-local normalizer (fai_cls: a rank-local draw) and rank-local
    BatchNorm statistics each move the losses past DP_RTOL."""
    r = results[family]
    ref = r["one"]["own"]["metrics"]
    keys = [k for k in ref if k != "grad_norm"]
    for name in [n for n in r["ranks"] if n.startswith("fault")]:
        errs = _rel(r["ranks"][name]["metrics"], ref, keys)
        assert max(errs.values()) > 100 * DP_RTOL, (name, errs)


# --------------------------------------------------------------------------- the tests
@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_dp_step_matches_jax(results, family):
    check_matches_jax(results, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_dp_step_matches_one_process(results, family):
    check_matches_one_process(results, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_fsdp_step_matches_dp(results, family):
    check_fsdp_matches_dp(results, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_planted_faults_fail_the_gate(results, family):
    check_planted_faults_fail(results, family)
