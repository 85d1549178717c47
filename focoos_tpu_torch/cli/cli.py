"""focoos-tpu-torch CLI (port of focoos_tpu/cli/cli.py; reference:
focoos/cli/cli.py, a Typer app; argparse here, as in the JAX package).

The same ten verbs with the same flags: version, checks, settings, train,
val, predict, export, benchmark, gradio and hub. Two differences:

- ``--device`` (default ``cuda``) on train, val, predict, export, benchmark
  and gradio, where the JAX package reads ``JAX_PLATFORMS``: the reference
  SDK's own ``device`` flag. A verb asked for ``cuda`` on a machine without
  it raises; none falls back to the CPU;
- ``export --runtime`` takes the port's ``RuntimeType`` values, default
  ``torch_export``, the counterpart of the JAX package's ``stablehlo``.

    focoos-tpu-torch predict --model fai-detr-l-coco --source image.jpg --save-json
    python -m focoos_tpu_torch.cli.cli checks
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# TrainerArgs fields that take no flag of their own: the run name and the device
# have theirs (``--run-name``; ``--device``, which also names the model's device),
# and the port's loader timeout is a knob of its tests (the JAX package has no such field)
_NO_FLAG = ("run_name", "device", "workers_timeout")


def _parse_im_size(s: str):
    """int or 'H,W' (reference: cli.py:104)."""
    if "," in s:
        h, w = s.split(",")
        return (int(h), int(w))
    return int(s)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device to run on: cuda (default), cuda:<i> or cpu")


def _device(ns: argparse.Namespace) -> str:
    """``--device``, checked: a card that is not there raises and never turns into the CPU."""
    import torch

    if torch.device(ns.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {ns.device}: CUDA is not available; pass --device cpu to run on the CPU")
    return ns.device


def _add_trainer_args(p: argparse.ArgumentParser) -> None:
    from focoos_tpu_torch.ports import TrainerArgs

    for f in dataclasses.fields(TrainerArgs):
        if f.name in _NO_FLAG:
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(arg, type=lambda x: x.lower() in ("1", "true", "yes"), default=None)
        elif isinstance(f.default, int):
            p.add_argument(arg, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(arg, type=float, default=None)
        elif f.name == "mesh_shape":
            # "--mesh-shape 2" -> (2,): the data-parallel ranks; pair with --sharding dp/fsdp
            p.add_argument(arg, type=lambda s: tuple(int(x) for x in s.split(",")), default=None)
        elif isinstance(f.default, str) or f.default is None:
            p.add_argument(arg, type=str, default=None)


def _build_trainer_args(ns: argparse.Namespace, run_name: str):
    from focoos_tpu_torch.ports import TrainerArgs

    kwargs = {}
    for f in dataclasses.fields(TrainerArgs):
        v = getattr(ns, f.name, None)
        if v is not None and f.name not in _NO_FLAG:
            kwargs[f.name] = v
    kwargs["run_name"] = run_name
    kwargs["device"] = ns.device
    return TrainerArgs(**kwargs)


def _add_aug_args(p: argparse.ArgumentParser) -> None:
    """Expose every DatasetAugmentations field as --aug-* (train pipeline) and
    --val-aug-* (val pipeline) flags — the reference mirrors the full
    augmentation dataclass into CLI flags (cli/cli.py:279-525)."""
    from focoos_tpu_torch.data.default_aug import DatasetAugmentations

    for prefix in ("aug", "val-aug"):
        for f in dataclasses.fields(DatasetAugmentations):
            if f.name == "resolution":
                continue  # resolution comes from --im-size
            arg = f"--{prefix}-" + f.name.replace("_", "-")
            if isinstance(f.default, bool):
                p.add_argument(arg, type=lambda x: x.lower() in ("1", "true", "yes"), default=None)
            elif isinstance(f.default, int):
                p.add_argument(arg, type=int, default=None)
            else:
                p.add_argument(arg, type=float, default=None)


def _build_augs(ns: argparse.Namespace, task, im_size):
    """Task defaults overridden by any --aug-*/--val-aug-* flags the user set."""
    from focoos_tpu_torch.data.default_aug import DatasetAugmentations, get_default_by_task

    train_augs, val_augs = get_default_by_task(task, resolution=im_size)
    for prefix, augs in (("aug", train_augs), ("val_aug", val_augs)):
        overrides = {}
        for f in dataclasses.fields(DatasetAugmentations):
            v = getattr(ns, f"{prefix}_{f.name}", None)
            if v is not None:
                overrides[f.name] = v
        if overrides:
            augs.override(overrides)
    return train_augs, val_augs


def _auto_dataset(ns: argparse.Namespace):
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.ports import Task

    return AutoDataset(ns.dataset, Task(ns.task), ns.dataset_layout,
                       **({"datasets_dir": ns.datasets_dir} if ns.datasets_dir else {}))


def cmd_version(_):
    import focoos_tpu_torch

    print(f"focoos-tpu-torch {focoos_tpu_torch.__version__}")


def cmd_checks(_):
    """System info (reference: cli.py:178 + utils/system.py:159)."""
    from focoos_tpu_torch.utils.system import get_system_info

    get_system_info().pretty_print()


def cmd_settings(_):
    from focoos_tpu_torch.config import FOCOOS_CONFIG

    for k, v in dataclasses.asdict(FOCOOS_CONFIG).items():
        if "key" in k and v:
            v = v[:4] + "..."
        print(f"{k} = {v}")


def cmd_train(ns):
    from focoos_tpu_torch.model_manager import ModelManager
    from focoos_tpu_torch.ports import DatasetSplitType, Task

    device = _device(ns)
    auto = _auto_dataset(ns)
    train_augs, val_augs = _build_augs(ns, Task(ns.task), ns.im_size)
    train_ds = auto.get_split(train_augs, DatasetSplitType.TRAIN)
    val_ds = auto.get_split(val_augs, DatasetSplitType.VAL)

    model = ModelManager.get(
        ns.model, num_classes=train_ds.metadata.num_classes, classes=train_ds.metadata.classes,
        image_size=ns.im_size, device=device,
    )
    args = _build_trainer_args(ns, ns.run_name or f"{ns.model}-{os.path.basename(ns.dataset)}")
    result = model.train(args, train_ds, val_ds)
    print(json.dumps({"run_dir": result["run_dir"], "metrics": result["metrics"]}, indent=2, default=str))


def cmd_val(ns):
    from focoos_tpu_torch.data.default_aug import get_default_by_task
    from focoos_tpu_torch.model_manager import ModelManager
    from focoos_tpu_torch.ports import DatasetSplitType, Task

    device = _device(ns)
    _, val_augs = get_default_by_task(Task(ns.task), resolution=ns.im_size)
    val_ds = _auto_dataset(ns).get_split(val_augs, DatasetSplitType.VAL)
    model = ModelManager.get(ns.model, image_size=ns.im_size, device=device)
    args = _build_trainer_args(ns, ns.run_name or "val")
    if getattr(ns, "batch_size", None) is None:
        args.batch_size = 8
    results = model.eval(args, val_ds)
    print(json.dumps(results, indent=2, default=str))


def cmd_predict(ns):
    """(reference: cli.py:771 + commands/predict.py:71-379)"""
    from focoos_tpu_torch.model_manager import ModelManager

    model = ModelManager.get(ns.model, image_size=ns.im_size, device=_device(ns))
    threshold = ns.conf if ns.conf is not None else ns.threshold
    res = model.infer(ns.source, threshold=threshold, annotate=ns.save)
    print(json.dumps(res.model_dump(), indent=2, default=str))
    out_dir = ns.output_dir or "."
    if ns.save or ns.save_json or ns.save_masks:
        os.makedirs(out_dir, exist_ok=True)
    if ns.save and res.image is not None:
        from PIL import Image

        out = ns.output or os.path.join(out_dir, "prediction.jpg")
        Image.fromarray(res.image).save(out)
        print(f"saved annotated image → {out}")
    if ns.save_json:
        out = os.path.join(out_dir, "prediction.json")
        with open(out, "w") as f:
            json.dump(res.model_dump(), f, indent=2, default=str)
        print(f"saved detections json → {out}")
    if ns.save_masks:
        # per-detection base64 PNG masks → individual PNG files
        # (reference: commands/predict.py mask saving)
        import base64
        import io

        from PIL import Image

        n = 0
        for i, det in enumerate(res.detections):
            if det.mask:
                img = Image.open(io.BytesIO(base64.b64decode(det.mask)))
                out = os.path.join(out_dir, f"mask_{i}.png")
                img.save(out)
                n += 1
        print(f"saved {n} mask PNGs → {out_dir}")


def cmd_export(ns):
    from focoos_tpu_torch.model_manager import ModelManager
    from focoos_tpu_torch.ports import RuntimeType

    runtime = ns.format or ns.runtime  # --format is the reference flag name
    model = ModelManager.get(ns.model, image_size=ns.im_size, device=_device(ns))
    infer_model = model.export(RuntimeType(runtime), out_dir=ns.output_dir, image_size=ns.im_size,
                               overwrite=ns.overwrite)
    print(f"exported → {infer_model.model_dir}")


def cmd_benchmark(ns):
    from focoos_tpu_torch.model_manager import ModelManager

    model = ModelManager.get(ns.model, image_size=ns.im_size, dtype=ns.dtype, device=_device(ns))
    metrics = model.benchmark(iterations=ns.iterations, size=ns.im_size)
    print(json.dumps(dataclasses.asdict(metrics), indent=2))


def cmd_gradio(ns):
    from focoos_tpu_torch.cli.gradio_app import launch

    launch(ns.model, image_size=ns.im_size, share=ns.share, device=_device(ns))


def cmd_hub(ns):
    """(reference: cli/commands/hub.py — models / datasets [--include-shared] /
    download / dataset download|upload)"""
    from focoos_tpu_torch.hub.focoos_hub import FocoosHUB

    hub = FocoosHUB(api_key=ns.api_key)
    if ns.hub_cmd == "models":
        for m in hub.list_remote_models():
            print(f"{m.ref}  {m.name}  {m.task.value if hasattr(m.task, 'value') else m.task}  "
                  f"{m.status.value if hasattr(m.status, 'value') else m.status}")
    elif ns.hub_cmd == "datasets":
        for d in hub.list_remote_datasets(include_shared=ns.include_shared):
            spec = f"  train={d.spec.train_length} val={d.spec.valid_length} {d.spec.size_mb}MB" if d.spec else ""
            task = d.task.value if hasattr(d.task, "value") else d.task
            print(f"{d.ref}  {d.name}  {task}  {d.layout}{spec}")
    elif ns.hub_cmd == "download":
        path = hub.download_model_pth(ns.ref)
        print(f"downloaded → {path}")
    elif ns.hub_cmd == "dataset":
        ds = hub.get_remote_dataset(ns.ref)
        if ns.dataset_action == "download":
            path = ds.download_data(ns.path)
            print(f"downloaded dataset → {path}")
        elif ns.dataset_action == "upload":
            if not ns.path:
                raise SystemExit("hub dataset upload requires --path <data.zip>")
            spec = ds.upload_data(ns.path)
            info = ds.get_info()
            print(f"uploaded {ns.path} → {ns.ref}")
            print(f"  name: {info.get('name')}  task: {info.get('task')}  layout: {info.get('layout')}")
            if spec:
                print(f"  train={spec.get('train_length')} val={spec.get('valid_length')} "
                      f"size={spec.get('size_mb')}MB")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("focoos-tpu-torch", description="PyTorch/CUDA focoos CLI")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("version")
    sub.add_parser("checks")
    sub.add_parser("settings")

    p = sub.add_parser("train")
    p.add_argument("--model", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--task", default="detection")
    p.add_argument("--dataset-layout", default="roboflow_coco")
    p.add_argument("--datasets-dir", default=None, help="root dir for named datasets")
    p.add_argument("--im-size", type=_parse_im_size, default=640)
    p.add_argument("--run-name", default=None)
    _add_device_arg(p)
    _add_trainer_args(p)
    _add_aug_args(p)

    p = sub.add_parser("val")
    p.add_argument("--model", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--task", default="detection")
    p.add_argument("--dataset-layout", default="roboflow_coco")
    p.add_argument("--datasets-dir", default=None, help="root dir for named datasets")
    p.add_argument("--im-size", type=_parse_im_size, default=640)
    p.add_argument("--run-name", default=None)
    _add_device_arg(p)
    _add_trainer_args(p)  # reference val mirrors the full TrainerArgs surface too

    p = sub.add_parser("predict")
    p.add_argument("--model", required=True)
    p.add_argument("--source", required=True, help="image path or URL")
    p.add_argument("--im-size", type=_parse_im_size, default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--conf", type=float, default=None, help="alias of --threshold (reference flag name)")
    p.add_argument("--save", action="store_true")
    p.add_argument("--save-json", action="store_true", help="save detections to prediction.json")
    p.add_argument("--save-masks", action="store_true", help="save per-detection mask PNGs")
    p.add_argument("--output", default=None)
    p.add_argument("--output-dir", default=None)
    _add_device_arg(p)

    p = sub.add_parser("export")
    p.add_argument("--model", required=True)
    p.add_argument("--runtime", default="torch_export",
                   help="cuda_bf16, cuda_fp32, cpu, cuda_int8 or torch_export (RuntimeType)")
    p.add_argument("--format", default=None, help="alias of --runtime (reference flag name)")
    p.add_argument("--im-size", type=_parse_im_size, default=640)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--overwrite", action="store_true", help="re-export over an existing artifact dir")
    _add_device_arg(p)

    p = sub.add_parser("benchmark")
    p.add_argument("--model", required=True)
    p.add_argument("--im-size", type=_parse_im_size, default=640)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--dtype", default=None)
    _add_device_arg(p)

    p = sub.add_parser("gradio")
    p.add_argument("--model", required=True)
    p.add_argument("--im-size", type=_parse_im_size, default=None)
    p.add_argument("--share", action="store_true")
    _add_device_arg(p)

    p = sub.add_parser("hub")
    p.add_argument("hub_cmd", choices=["models", "datasets", "download", "dataset"])
    p.add_argument("dataset_action", nargs="?", choices=["download", "upload"],
                   help="with 'dataset': download or upload")
    p.add_argument("--ref", default=None)
    p.add_argument("--path", default=None, help="dataset download dir / upload zip")
    p.add_argument("--include-shared", action="store_true",
                   help="datasets: include shared/public datasets")
    p.add_argument("--api-key", default=None)
    return parser


COMMANDS = {
    "version": cmd_version,
    "checks": cmd_checks,
    "settings": cmd_settings,
    "train": cmd_train,
    "val": cmd_val,
    "predict": cmd_predict,
    "export": cmd_export,
    "benchmark": cmd_benchmark,
    "gradio": cmd_gradio,
    "hub": cmd_hub,
}


def main(argv=None):
    ns = build_parser().parse_args(argv)
    COMMANDS[ns.cmd](ns)
    # loader workers and the evaluation's producer thread can make interpreter
    # teardown return nonzero; flush and exit explicitly so scripts see success
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
