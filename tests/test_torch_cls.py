"""Port parity for the fai_cls family on the CPU: the forward, the weights'
round trip, the loss, one train step, the solver's groups, the processor,
the mapper and the evaluator against the JAX package on the same numpy
weights and inputs; then FocoosModel.train through the port's trainer.

The tiny model is ``fai-cls-n-coco`` (STDC nano, res4) with 3 classes at
96², as ``tests/test_model_families.py`` builds it; the two-layer head is
32 wide. Tolerances: forwards 1e-4 x max|ref| (fp32 both sides); losses
1e-6 rel; the train step in fp64 on both sides (the logits and the loss in
fp32, as both packages cast them), its loss 1e-6 rel, every gradient within
1e-4 x its max |ref| + 1e-9 and the moved BatchNorm statistics 1e-6 abs;
probabilities 1e-6 abs; the evaluator's metrics 1e-9 abs.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import _flat, _perturb

from focoos_tpu.data.auto_dataset import AutoDataset as JaxAutoDataset
from focoos_tpu.data.default_aug import get_default_by_task as jax_get_default_by_task
from focoos_tpu.data.mappers import ClassificationDatasetMapper as JaxClassificationMapper
from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.fai_cls.loss import classification_loss as jax_classification_loss
from focoos_tpu.models.fai_cls.loss import make_loss_fn as jax_make_loss_fn
from focoos_tpu.models.fai_cls.modelling import FAIClassification as JaxFAIClassification
from focoos_tpu.models.fai_cls.ports import ClassificationModelOutput as JaxClsOutput
from focoos_tpu.models.fai_cls.ports import ClassificationTargets as JaxClsTargets
from focoos_tpu.models.fai_cls.processor import ClassificationProcessor as JaxClsProcessor
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.ports import DatasetSplitType as JaxSplit
from focoos_tpu.ports import Task as JaxTask
from focoos_tpu.trainer.evaluation.evaluators import ClassificationEvaluator as JaxClsEvaluator
from focoos_tpu.trainer.solver import leaf_hyperparams
from focoos_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.data.auto_dataset import AutoDataset
from focoos_tpu_torch.data.default_aug import get_default_by_task
from focoos_tpu_torch.data.mappers import ClassificationDatasetMapper
from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager
from focoos_tpu_torch.models.fai_cls.loss import classification_loss, make_loss_fn
from focoos_tpu_torch.models.fai_cls.modelling import FAIClassification
from focoos_tpu_torch.models.fai_cls.ports import ClassificationDecode, ClassificationModelOutput, ClassificationTargets
from focoos_tpu_torch.models.fai_cls.processor import ClassificationProcessor
from focoos_tpu_torch.nn.layers.common import set_compute_dtype
from focoos_tpu_torch.ports import DatasetEntry, DatasetSplitType, Task, TrainerArgs
from focoos_tpu_torch.trainer.evaluation import ClassificationEvaluator, get_evaluator
from focoos_tpu_torch.trainer.solver import param_hyperparams
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

NUM_CLASSES = 3
SIZE = 96
FWD_TOL = 1e-4  # x max|ref|
LOSS_RTOL = 1e-6
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-9
STATS_TOL = 1e-6
PROB_TOL = 1e-6
CARDS = os.path.join(os.path.dirname(__file__), "..", "focoos_tpu_torch", "model_registry")
HEADS = {"one-layer": dict(), "two-layer": dict(num_layers=2, hidden_dim=32), "dense": dict(dense_prediction=True)}


def tiny_configs(**over):
    """(JAX config, port config) of fai-cls-n-coco with 3 classes and ``over``."""
    with open(os.path.join(CARDS, "fai-cls-n-coco.json")) as f:
        d = json.load(f)["config"]
    over = dict(num_classes=NUM_CLASSES, **over)
    return JaxConfigManager.from_dict("fai_cls", d, **over), ConfigManager.from_dict("fai_cls", d, **over)


def build(head: str, seed: int = 0, dtype=None, **over):
    """(JAX module, port module with the perturbed weights, the weights flat in JAX's layout)."""
    jcfg, pcfg = tiny_configs(**dict(HEADS[head], **over))
    jmodel = JaxFAIClassification(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config),
                                  dtype=dtype)
    port = FAIClassification(pcfg, BackboneManager.from_config(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(seed))
    tree, unmatched = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "fai_cls", verbose=False)
    assert unmatched == []
    flat = _perturb(_flat(tree), seed=seed + 1)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    shapes = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    assert {k: v.shape for k, v in flat.items()} == shapes
    port.load_state_dict(from_jax_variables(flat, "fai_cls"), strict=True)
    return jmodel, port.eval(), flat


def images(seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)


def labels_of(seed: int, b: int = 2) -> np.ndarray:
    """Multi-hot labels, at least one class an image."""
    lab = (np.random.default_rng(seed).random((b, NUM_CLASSES)) > 0.5).astype(np.float32)
    lab[np.arange(b), np.arange(b) % NUM_CLASSES] = 1.0
    return lab


# --------------------------------------------------------------------------- forward and weights
@pytest.mark.parametrize("head", list(HEADS))
def test_forward_matches_jax(head):
    """Eval forward on the same weights: fp32 logits within 1e-4 x max|ref|."""
    jmodel, port, flat = build(head)
    x = images(1)
    ref = np.asarray(jax.jit(jmodel.apply)(unflatten_tree(flat), jnp.asarray(x))[0].logits)
    with torch.inference_mode():
        out, aux = port(torch.from_numpy(x))
    assert aux is None and out.logits.dtype == torch.float32 and out.logits.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(out.logits.numpy(), ref, rtol=0, atol=FWD_TOL * np.abs(ref).max())


@pytest.mark.parametrize("head", ["one-layer", "two-layer"])
def test_weights_round_trip(head):
    """convert_state_dict → from_jax_variables → to_jax_variables: no key
    unmatched, every tensor equal both ways, the head at the reference's
    ``cls_head.classifier.{2 | 1, 4}``."""
    _, port, flat = build(head)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    heads = sorted(k for k in sd if k.startswith("cls_head."))
    assert heads == (["cls_head.classifier.2.bias", "cls_head.classifier.2.weight"] if head == "one-layer" else
                     ["cls_head.classifier.1.bias", "cls_head.classifier.1.weight", "cls_head.classifier.4.bias",
                      "cls_head.classifier.4.weight"])
    tree, unmatched = convert_state_dict(sd, "fai_cls", verbose=False)
    assert unmatched == []
    again = _flat(tree)
    assert sorted(again) == sorted(flat) and all(np.array_equal(again[k], flat[k]) for k in flat)
    back = to_jax_variables(sd, "fai_cls")
    assert sorted(back) == sorted(flat) and all(np.array_equal(back[k], flat[k]) for k in flat)


# --------------------------------------------------------------------------- loss and step
@pytest.mark.parametrize("kind", ["bce-pos-weight", "focal-smoothing"])
def test_classification_loss_matches_jax(kind):
    over = dict(pos_weight=2.0) if kind == "bce-pos-weight" else dict(use_focal_loss=True, label_smoothing=0.1,
                                                                       focal_alpha=0.6, focal_gamma=1.5)
    jcfg, pcfg = tiny_configs(**over)
    logits = (np.random.default_rng(2).standard_normal((4, NUM_CLASSES)) * 4).astype(np.float32)
    logits[0, 0] = 30.0  # a saturated sigmoid: p clips at 1 in the focal loss
    lab = labels_of(3, 4)
    ref = float(jax_classification_loss(jnp.asarray(logits), JaxClsTargets(jnp.asarray(lab)), jcfg)["loss_cls"])
    got = classification_loss(torch.from_numpy(logits), ClassificationTargets(torch.from_numpy(lab)), pcfg)
    assert list(got) == ["loss_cls"]
    np.testing.assert_allclose(float(got["loss_cls"]), ref, rtol=LOSS_RTOL)


def jax_step_fp64(jmodel, jcfg, flat, x, lab):
    """JAX's ``make_loss_fn`` under ``value_and_grad`` with fp64 weights and compute."""
    loss_fn = jax_make_loss_fn(jmodel, jcfg)
    jv = unflatten_tree({k: v.astype(np.float64) for k, v in flat.items()})

    def total_fn(params):
        total, (_, state) = loss_fn({"params": params, "batch_stats": jv["batch_stats"]},
                                    (jnp.asarray(x), JaxClsTargets(jnp.asarray(lab))), jax.random.PRNGKey(0))
        return total, state

    (total, state), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jv["params"])
    return (float(total), {k: np.asarray(v) for k, v in flatten_tree(grads, prefix="params/").items()},
            {k: np.asarray(v) for k, v in flatten_tree(state["batch_stats"], prefix="batch_stats/").items()})


@pytest.mark.usefixtures("few_threads")
def test_train_step_matches_jax_in_fp64():
    """One step with dropout 0 (the head's only draw), both packages in fp64:
    the loss, every gradient and the moved BatchNorm statistics."""
    x, lab = images(4), labels_of(5)
    with jax.enable_x64(True):
        jmodel, port, flat = build("one-layer", seed=6, dtype=jnp.float64, dropout_rate=0.0)
        ref_total, ref_grads, ref_stats = jax_step_fp64(jmodel, jmodel.config, flat, x, lab)
    port.double()
    set_compute_dtype(port, torch.float64)
    port.train()
    total, losses = make_loss_fn(port, port.config)(torch.from_numpy(x), ClassificationTargets(torch.from_numpy(lab)))
    total.backward()
    assert sorted(losses) == ["loss_cls"]
    np.testing.assert_allclose(float(total.detach()), ref_total, rtol=LOSS_RTOL)
    # fai-cls-n classifies res4: res5's blocks take no gradient (JAX's: zeros)
    grads = to_jax_variables({n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                              for n, p in port.named_parameters()}, "fai_cls")
    assert sorted(grads) == sorted(ref_grads)
    for k, r in ref_grads.items():
        np.testing.assert_allclose(grads[k], r, rtol=0, atol=GRAD_TOL * np.abs(r).max() + GRAD_FLOOR, err_msg=k)
    stats = {k: v for k, v in to_jax_variables({k: v.numpy() for k, v in port.state_dict().items()}, "fai_cls").items()
             if k.startswith("batch_stats/")}
    assert sorted(stats) == sorted(ref_stats)
    for k, r in ref_stats.items():
        np.testing.assert_allclose(stats[k], r, rtol=0, atol=STATS_TOL, err_msg=k)


@pytest.mark.parametrize("head", ["one-layer", "two-layer"])
def test_dropout_scaling_matches_jax(head):
    """Train-mode forward at dropout 0.5: JAX's own keep mask (read from its
    dropout's captured output) carried into the port gives the same logits,
    each kept value scaled by 2; the port's generator draws about half."""
    jmodel, port, flat = build(head, dropout_rate=0.5)
    x = images(7)
    (out, _), state = jax.jit(lambda v, xx: jmodel.apply(
        v, xx, train=True, mutable=["batch_stats", "intermediates"], rngs={"dropout": jax.random.PRNGKey(3)},
        capture_intermediates=lambda mdl, _: type(mdl).__name__ == "Dropout"))(unflatten_tree(flat), jnp.asarray(x))
    dropped = np.asarray(state["intermediates"]["cls_head"]["Dropout_0"]["__call__"][0])  # NHWC [B, 1, 1, C]
    keep = torch.from_numpy(dropped != 0).permute(0, 3, 1, 2)
    assert 0 < keep.float().mean() < 1
    port.train()
    got = port(torch.from_numpy(x), keep=keep)[0].logits.detach().numpy()
    ref = np.asarray(out.logits)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL * np.abs(ref).max())
    drawn = port.cls_head.classifier[1 if head == "one-layer" else 3]
    v = torch.ones(4000)
    kept = drawn(v, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, 2.0} and 0.45 < float((kept > 0).float().mean()) < 0.55


# --------------------------------------------------------------------------- solver
@pytest.mark.parametrize("case", ["head-0.5", "backbone-0", "freeze_bn"])
def test_solver_groups_match_jax(case):
    """lr multiplier and weight decay of every parameter against JAX's
    leaf_hyperparams. The trap: JAX names the head's convs ``cls_head/fc*``,
    so its ``"head" in path and "classifier" not in path`` applies the head
    multiplier to them, where the reference's ``cls_head.classifier.*``
    names would spare them; the port follows JAX (ROADMAP Queue 3)."""
    _, port, flat = build("two-layer")
    names = [n for n, _ in port.named_parameters()]
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(port.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "fai_cls", verbose=False)[0]["params"]}).items()}
    kw = dict(base_wd=0.02, wd_norm=0.01, wd_embed=0.03, backbone_multiplier=0.1, decoder_multiplier=1.0,
              head_multiplier=1.0)
    kw.update({"head-0.5": dict(head_multiplier=0.5), "backbone-0": dict(backbone_multiplier=0.0)}.get(case, {}))
    freeze_bn = case == "freeze_bn"
    lr_tree, wd_tree = leaf_hyperparams(unflatten_tree(flat)["params"], freeze_bn=freeze_bn, **kw)
    hp = param_hyperparams(port, freeze_bn=freeze_bn, **kw)
    assert sorted(source) == sorted(_flat({"params": lr_tree}))
    for i, ref_tree in enumerate((lr_tree, wd_tree)):
        for k, ref in _flat({"params": ref_tree}).items():
            assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)
    if case == "head-0.5":
        assert hp["cls_head.classifier.4.weight"] == (0.5, 0.02) and hp["cls_head.classifier.1.bias"][0] == 0.5


# --------------------------------------------------------------------------- processor
def test_postprocess_and_eval_postprocess_match_jax():
    """The same logits → the same classes over the threshold and probabilities
    (1e-6), with and without the device half of the evaluation decode."""
    jcfg, pcfg = tiny_configs()
    logits = (np.random.default_rng(8).standard_normal((3, NUM_CLASSES)) * 3).astype(np.float32)
    names = ["a", "b", "c"]
    jp, pp = JaxClsProcessor(jcfg), ClassificationProcessor(pcfg)
    pout = ClassificationModelOutput(torch.from_numpy(logits))
    for thr in (None, 0.2):
        ref = jp.postprocess(JaxClsOutput(jnp.asarray(logits)), None, names, threshold=thr)
        got = pp.postprocess(pout, None, names, threshold=thr)
        for r, g in zip(ref, got, strict=True):
            assert [(d.cls_id, d.label) for d in g.detections] == [(d.cls_id, d.label) for d in r.detections]
            np.testing.assert_allclose([d.conf for d in g.detections], [d.conf for d in r.detections], atol=PROB_TOL)
    ref = jp.eval_postprocess(JaxClsOutput(jnp.asarray(logits)), [])
    decoded = pp.eval_decode(pout, [])
    assert isinstance(decoded, ClassificationDecode)
    for got in (pp.eval_postprocess(pout, []), pp.eval_postprocess(decoded, [])):
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g["logits"], r["logits"], rtol=0, atol=PROB_TOL)
    ref = jp.export_postprocess([logits], None, names, threshold=0.2)
    got = pp.export_postprocess([logits], None, names, threshold=0.2)
    assert pp.get_output_names() == jp.get_output_names() == ["logits"]
    for r, g in zip(ref, got, strict=True):
        assert [(d.cls_id, d.label) for d in g.detections] == [(d.cls_id, d.label) for d in r.detections]
        np.testing.assert_allclose([d.conf for d in g.detections], [d.conf for d in r.detections], atol=PROB_TOL)


def test_preprocess_entries_matches_jax():
    """int and list labels → the same one-hot targets and padded uint8 batch
    (CPU tensors, pinnable); serving squash-resizes to the model's size."""
    jcfg, pcfg = tiny_configs()
    rng = np.random.default_rng(9)
    ims = [rng.integers(0, 256, (50, 60, 3), dtype=np.uint8), rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)]
    labels = [2, [0, 2]]
    jb, jt = JaxClsProcessor(jcfg).train(True).preprocess([JaxDatasetEntry(image=i, label=lab) for i, lab in zip(ims, labels)])
    pb, pt = ClassificationProcessor(pcfg).train(True).preprocess_entries(
        [DatasetEntry(image=i, label=lab) for i, lab in zip(ims, labels)], max_instances=100)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(jt.labels))
    assert pt.labels.dtype == torch.float32 and not pt.labels.is_cuda
    assert torch.equal(pt.to("cpu").labels, pt.labels)
    batch, none = ClassificationProcessor(pcfg).preprocess([ims[0]])
    assert none is None and batch.shape == (1, 224, 224, 3)


# --------------------------------------------------------------------------- data and evaluation
@pytest.fixture(scope="module")
def folder_root(tmp_path_factory):
    from make_synthetic_dataset import make_cls

    return make_cls(str(tmp_path_factory.mktemp("cls") / "shapes"), n_per_class=2, size=SIZE, seed=3)


@pytest.mark.parametrize("records", ["folder", "coco"])
def test_mapper_matches_jax(folder_root, records):
    """Folder-per-class records (``label`` an int) through each package's
    AutoDataset split under one np.random seed, and COCO records without a
    ``label`` (the multi-label from the annotations' category_ids): the
    same images and labels."""
    if records == "folder":
        jds = JaxAutoDataset(folder_root, task="classification").get_split(
            jax_get_default_by_task(JaxTask.CLASSIFICATION, SIZE)[0], split=JaxSplit.TRAIN)
        pds = AutoDataset(folder_root, task="classification").get_split(
            get_default_by_task(Task.CLASSIFICATION, SIZE)[0], split=DatasetSplitType.TRAIN)
        assert len(pds) == len(jds) == 6
        pairs = []
        for i in range(len(pds)):
            np.random.seed(10 + i)
            j = jds[i]
            np.random.seed(10 + i)
            pairs.append((j, pds[i]))
        assert sorted(p.label for _, p in pairs) == [0, 0, 1, 1, 2, 2]
    else:
        files = sorted(os.path.join(d, f) for d, _, fs in os.walk(folder_root) for f in fs if f.endswith(".jpg"))[:2]
        recs = [dict(file_name=files[0], image_id=7, annotations=[{"category_id": 2}, {"category_id": 0}]),
                dict(file_name=files[1], image_id=8, annotations=[{"category_id": 1}])]
        augs = [get_default_by_task(Task.CLASSIFICATION, SIZE)[1].get_augmentations(task=Task.CLASSIFICATION),
                jax_get_default_by_task(JaxTask.CLASSIFICATION, SIZE)[1].get_augmentations(task=JaxTask.CLASSIFICATION)]
        pm, jm = ClassificationDatasetMapper(augs[0], False), JaxClassificationMapper(augs[1], False)
        pairs = [(jm(r), pm(r)) for r in recs]
        assert [p.label for _, p in pairs] == [[2, 0], [1]] and [p.image_id for _, p in pairs] == [7, 8]
    for j, p in pairs:
        np.testing.assert_array_equal(p.image, j.image)
        assert (p.label, p.height, p.width, p.file_name) == (j.label, j.height, j.width, j.file_name)


def test_evaluator_matches_jax():
    """Seeded probabilities and (multi-)labels, fed in three batches: f1,
    precision, recall and micro_f1 equal JAX's; a class without support is
    left out of the means; the gather seam sums the states."""
    rng = np.random.default_rng(11)
    c = 5
    port, jax_ = ClassificationEvaluator(c), JaxClsEvaluator(c)
    labels = [int(rng.integers(0, 4)) if i % 3 else [0, int(rng.integers(1, 4))] for i in range(12)]
    probs = rng.random((12, c))
    for s in range(0, 12, 4):
        port.process([DatasetEntry(label=lab) for lab in labels[s:s + 4]], [{"logits": p} for p in probs[s:s + 4]])
        jax_.process([JaxDatasetEntry(label=lab) for lab in labels[s:s + 4]], [{"logits": p} for p in probs[s:s + 4]])
    got, ref = port.evaluate(), jax_.evaluate()
    assert sorted(got["classification"]) == ["f1", "micro_f1", "precision", "recall"]
    for k, v in ref["classification"].items():
        assert abs(got["classification"][k] - v) <= 1e-9, k
    other = ClassificationEvaluator(c)
    other.load_gathered_states([port.state_for_gather(), port.state_for_gather()])
    assert other.evaluate() == got
    assert isinstance(get_evaluator(Task.CLASSIFICATION, c), ClassificationEvaluator)


@pytest.mark.usefixtures("few_threads")
def test_model_manager_train_two_steps(folder_root, tmp_path):
    """ModelManager.get(..., device="cpu") → FocoosModel.train 2 steps on the
    folder set with validation (classification/f1) → the saved weights load
    into the JAX tree's layout and the model serves."""
    train = AutoDataset(folder_root, task="classification").get_split(
        get_default_by_task(Task.CLASSIFICATION, SIZE)[0], split=DatasetSplitType.TRAIN)
    val = AutoDataset(folder_root, task="classification").get_split(
        get_default_by_task(Task.CLASSIFICATION, SIZE)[1], split=DatasetSplitType.VAL)
    model = ModelManager.get("fai-cls-n-coco", device="cpu", classes=train.metadata.classes, image_size=SIZE)
    res = model.train(TrainerArgs(run_name="cls", output_dir=str(tmp_path), batch_size=2, max_iters=2, workers=0,
                                  eval_period=2, checkpointer_period=2, samples=0), train, val)
    assert res["iterations"] == 2
    f1 = res["metrics"]["classification"]["f1"]
    assert 0.0 <= f1 <= 100.0
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    assert any("loss_cls" in r for r in rows) and all(np.isfinite(r.get("total_loss", 0.0)) for r in rows)
    assert not model.module.training
    det = model.infer(np.zeros((50, 70, 3), np.uint8), threshold=0.0)
    assert len(det.detections) == NUM_CLASSES and all(0.0 <= d.conf <= 1.0 for d in det.detections)
