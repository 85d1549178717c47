"""``FocoosModel.train(num_devices=2)`` on the CPU: the model launches two
ranks (gloo) of the port's trainer under ``dp``, trains 2 steps and takes
rank 0's final weights; the run dir holds one ``model_final.npz`` and one
``model_info.json``, written by rank 0 alone; a second launch resumes that
run's checkpoint under ``fsdp`` for a third step. The launched ranks import
nothing of this module but its datasets (lists of the port's entries).

The torchrun route: two processes started with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
each call ``FocoosModel.train(num_devices=2)``; both end with the same
trained weights, and the run dir is written once."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances

SIZE = 64
TINY = dict(image_size=SIZE, num_queries=10, transformer_predictor_dec_layers=1, num_classes=3,
            backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False})


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    """Two intra-op threads here and in the launched ranks."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dataset(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        xy = rng.uniform(0, SIZE * 0.7, (k, 2))
        boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, SIZE * 0.3, (k, 2)), SIZE)], 1).astype(np.float32)
        out.append(DatasetEntry(image=rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8), height=SIZE, width=SIZE,
                                instances=Instances((SIZE, SIZE), boxes=Boxes(boxes), classes=rng.integers(0, 3, k))))
    return out


def _ckpt_payload(ckpt_dir: str, name: str) -> dict:
    return torch.load(os.path.join(ckpt_dir, name, "state.pt"), map_location="cpu", weights_only=True)


def test_focoos_model_trains_on_two_ranks_and_resumes_under_fsdp(tmp_path):
    model = ModelManager.get("fai-detr-l-coco", device="cpu", seed=0, **TINY)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    ckpt = str(tmp_path / "ckpt")
    common = dict(output_dir=str(tmp_path), batch_size=4, workers=0, checkpointer_period=2, log_period=1,
                  max_instances_per_image=5, ckpt_dir=ckpt, num_devices=2, ema_enabled=True)
    res = model.train(TrainerArgs(run_name="dp", max_iters=2, sharding="dp", **common), _dataset(6, 0))
    assert res["iterations"] == 2 and model.model_info.status.value == "TRAINING_COMPLETED"
    files = sorted(os.listdir(res["run_dir"]))
    assert files.count("model_final.npz") == 1 and files.count("model_info.json") == 1, files
    with open(os.path.join(res["run_dir"], "model_info.json")) as f:
        assert json.load(f)["status"] == "TRAINING_COMPLETED"
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:  # rank 0's lines alone: iteration 0 once
        iters = [json.loads(line)["iteration"] for line in f]
    assert iters.count(0) == 1 and max(iters) == 1, iters
    # the model took rank 0's final weights, which model_final.npz holds
    from focoos_tpu_torch.utils.checkpoint import load_variables_npz
    from focoos_tpu_torch.utils.weights import from_jax_variables

    saved = from_jax_variables(load_variables_npz(os.path.join(res["run_dir"], "model_final.npz")), "fai_detr")
    live = model.module.state_dict()
    for k, v in live.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(saved[k].numpy(), v.numpy(), err_msg=k)
    assert any(not torch.equal(before[k], live[k]) for k in live)
    dp_state = _ckpt_payload(ckpt, "model_final")

    # the dp run's checkpoint, resumed under fsdp for a third step on two ranks
    res = model.train(TrainerArgs(run_name="fsdp", max_iters=3, sharding="fsdp", resume=True, **common),
                      _dataset(6, 0))
    assert res["iterations"] == 3
    fsdp_state = _ckpt_payload(ckpt, "model_final")
    assert fsdp_state["step"] == 3 and dp_state["step"] == 2
    # both modes write the one-process layout: the same keys, shapes and dtypes
    a, b = dp_state["module"], fsdp_state["module"]
    assert sorted(a) == sorted(b) and all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
    assert [t.shape for t in dp_state["ema"]] == [t.shape for t in fsdp_state["ema"]]
    assert sorted(dp_state["optimizer"]["state"]) == sorted(fsdp_state["optimizer"]["state"])
    for i, st in dp_state["optimizer"]["state"].items():
        assert {k: getattr(v, "shape", None) for k, v in st.items()} == {
            k: getattr(v, "shape", None) for k, v in fsdp_state["optimizer"]["state"][i].items()}
    moved = [k for k in a if not torch.equal(a[k], b[k])]
    assert moved and all(torch.isfinite(v).all() for v in b.values())
    # the model's final weights: the EMA of the parameters, the live BatchNorm statistics
    names = [n for n, _ in model.module.named_parameters()]
    live = model.module.state_dict()
    for n, e in zip(names, fsdp_state["ema"], strict=True):
        assert torch.equal(live[n], e), n
    for k in b:
        if k not in names:
            assert torch.equal(live[k], b[k]), k


def _torchrun_rank(out_dir: str) -> None:
    """One process of a torchrun launch: train, then save this rank's final
    weights and what ``train`` returned (started by the test below)."""
    torch.set_num_threads(2)
    model = ModelManager.get("fai-detr-l-coco", device="cpu", seed=0, **TINY)
    res = model.train(TrainerArgs(run_name="torchrun", output_dir=out_dir, batch_size=4, workers=0, max_iters=1,
                                  checkpointer_period=1, max_instances_per_image=5, num_devices=2, sharding="dp"),
                      _dataset(6, 0))
    rank = os.environ["RANK"]
    torch.save(model.module.state_dict(), os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"iterations": res["iterations"], "run_dir": res["run_dir"],
                   "status": model.model_info.status.value}, f)


def test_focoos_model_trains_under_torchrun(tmp_path):
    from focoos_tpu_torch.parallel.launch import free_port

    tests, root = os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join([root, tests, os.environ.get("PYTHONPATH", "")]))
    code = f"import test_torch_dist_model as t; t._torchrun_rank({str(tmp_path)!r})"
    procs = [subprocess.Popen([sys.executable, "-c", code], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(log[-3000:] for log in logs)
    done = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert done[0] == done[1] and done[0]["iterations"] == 1 and done[0]["status"] == "TRAINING_COMPLETED", done
    a, b = (torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    files = sorted(os.listdir(done[0]["run_dir"]))
    assert files.count("model_final.npz") == 1 and files.count("model_info.json") == 1, files
