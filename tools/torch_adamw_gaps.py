"""How far apart repeated AdamW fine-tunes land on the card, call by call.

Builds ``chip_smoke.py``'s ``user_data`` setup (a seeded Supervisely folder
converted to Roboflow-COCO, the user augmentation list, fai-detr-l-coco at
full width with conditioned random weights), then trains it ten times from
the same weights and loader order for 4 steps at B=8 with AdamW, at
``steps_per_call`` 1 or 2, and prints, for every pair of runs, the largest
relative loss gap of each 2-step call (a K=1 run's steps paired into calls).
The MSDA backward accumulates with atomics, so runs differ; this shows how
far, which is what a K=2-against-K=1 gate under AdamW must allow.

    python3 tools/torch_adamw_gaps.py      # one CUDA card, about 100 s
"""

import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from focoos_tpu_torch import ModelManager  # noqa: E402
from focoos_tpu_torch.data.converters import supervisely_to_coco  # noqa: E402
from focoos_tpu_torch.data.datasets import DictDataset, MapDataset  # noqa: E402
from focoos_tpu_torch.data.mappers import get_mapper_by_task  # noqa: E402
from focoos_tpu_torch.ops import cuda_build  # noqa: E402
from focoos_tpu_torch.ports import Task, TrainerArgs  # noqa: E402
from focoos_tpu_torch.trainer.trainer import FocoosTrainer  # noqa: E402

RUNS = (1, 2, 1, 2, 1, 1, 2, 1, 1, 2)  # steps_per_call of each run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cuda_build.load_libraries(("msda", "msda_bwd", "stem", "nms"))
    dev = torch.device("cuda:0")
    root = tempfile.mkdtemp(prefix="adamw_gaps_")
    try:
        sv = cs.write_supervisely_set(os.path.join(root, "sv"), cs.UD_TRAIN, cs.UD_VAL, cs.UD_HW, seed=60)
        out = os.path.join(root, "coco", "train")
        os.makedirs(out)
        supervisely_to_coco(os.path.join(sv, "train", "ann"), os.path.join(sv, "train", "img"),
                            os.path.join(out, "_annotations.coco.json"), class_list=cs.SHAPE_CLASSES)
        for fn in os.listdir(os.path.join(sv, "train", "img")):
            shutil.copy(os.path.join(sv, "train", "img", fn), out)
        base = DictDataset.from_roboflow_coco(out, Task.DETECTION)
        train_ds = MapDataset(base, get_mapper_by_task(Task.DETECTION, cs.user_augmentations(), is_train=True))
        model = ModelManager.get(cs.UD_CARD, device=dev, classes=base.metadata.classes, seed=0)
        cs.perturb(model.module, seed=62)
        cs.condition_for_training(model.module)
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        runs = []
        for k in RUNS:
            model.module.load_state_dict(initial)
            args = TrainerArgs(run_name="a", output_dir=os.path.join(root, "runs"), batch_size=cs.UD_BATCH,
                               max_iters=4, steps_per_call=k, workers=8, ema_enabled=True, seed=0,
                               workers_timeout=300, eval_period=0, samples=0, checkpointer_period=10**6,
                               log_period=4)
            trainer = FocoosTrainer(model, args, train_ds)
            trainer.train()
            m = cs.history(trainer, [key for key in trainer.loop.storage.histories() if "loss" in key])
            if k == 1:
                m = {it: {key: (v + m[it + 1][key]) / 2 for key, v in m[it].items()} for it in (0, 2)}
            runs.append((k, m))
        for j in range(len(runs)):
            for i in range(j + 1, len(runs)):
                a, b = runs[j][1], runs[i][1]
                gaps = {it: max(abs(v - a[it][key]) / abs(a[it][key]) for key, v in b[it].items()) for it in (0, 2)}
                print(f"run {i} K={runs[i][0]} against run {j} K={runs[j][0]}: first call {gaps[0]:.3e},"
                      f" second call {gaps[2]:.3e}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)  # the loader's worker threads can hold the interpreter's exit
