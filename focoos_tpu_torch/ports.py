"""Core types of the port (copy of ``focoos_tpu/ports.py``, trimmed to what
``focoos_tpu_torch`` and its tests use).

The port keeps its own copy instead of importing the JAX package's, so that
it runs where neither JAX nor ``focoos_tpu`` is installed. Names, fields and
behaviour are those of the JAX package's module, so a reader finds each
counterpart by name; a model card or ``model_info.json`` written by either
package loads in the other.

Reference parity: focoos/ports.py:135 (Task), :864 (ModelFamily), :926
(ModelConfig), :973 (TrainerArgs), :1191 (ModelInfo), :303/:373
(FocoosDet/FocoosDetections).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, fields
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

ROOT_DIR = os.path.expanduser(os.getenv("FOCOOS_TPU_ROOT", "~/FocoosTPU"))
MODELS_DIR = os.path.join(ROOT_DIR, "models")
DATASETS_DIR = os.path.join(ROOT_DIR, "datasets")


class Task(str, Enum):
    """Vision task supported by the framework (focoos/ports.py:135)."""

    DETECTION = "detection"
    SEMSEG = "semseg"
    INSTANCE_SEGMENTATION = "instseg"
    CLASSIFICATION = "classification"
    KEYPOINT = "keypoint"


class ModelStatus(str, Enum):
    """Lifecycle state persisted to model_info.json (focoos/ports.py:41)."""

    CREATED = "CREATED"
    TRAINING_STARTING = "TRAINING_STARTING"
    TRAINING_RUNNING = "TRAINING_RUNNING"
    TRAINING_ERROR = "TRAINING_ERROR"
    TRAINING_COMPLETED = "TRAINING_COMPLETED"
    TRAINING_STOPPED = "TRAINING_STOPPED"
    DEPLOYED = "DEPLOYED"


class DatasetLayout(str, Enum):
    """On-disk dataset formats the ingestion layer understands (focoos/ports.py:80)."""

    ROBOFLOW_COCO = "roboflow_coco"
    ROBOFLOW_SEG = "roboflow_seg"
    CATALOG = "catalog"
    CLS_FOLDER = "cls_folder"


class ModelFamily(str, Enum):
    """Registered model families (focoos/ports.py:864)."""

    DETR = "fai_detr"
    MASKFORMER = "fai_mf"
    BISENETFORMER = "bisenetformer"
    IMAGE_CLASSIFIER = "fai_cls"
    RTMO = "rtmo"


class RuntimeType(str, Enum):
    """Inference engine configurations (JAX ports.py:95; focoos/ports.py:598).
    Each member and its JAX counterpart:

    - ``CUDA_BF16`` (default): the eager module on the card in bf16 compute
      (fp32 parameters) — ``XLA_TPU_BF16``;
    - ``CUDA_FP32``: the eager module on the card in fp32 — ``XLA_TPU_FP32``;
    - ``CPU``: the eager module in fp32 on the host, only when named — ``XLA_CPU``;
    - ``CUDA_INT8``: the int8 weight store, dequantized, in a bf16 module whose
      ``ConvNorm``s and ``Int8Linear``s run int8 QDQ products — ``XLA_TPU_INT8``;
    - ``TORCH_EXPORT``: a ``torch.export`` program (``model.pt2``, plus
      ``model_{H}x{W}.pt2`` size buckets) — ``STABLEHLO``.

    ``TF_SAVEDMODEL`` has no counterpart yet (ROADMAP Queue 1 item 6)."""

    CUDA_BF16 = "cuda_bf16"
    CUDA_FP32 = "cuda_fp32"
    CPU = "cpu"
    CUDA_INT8 = "cuda_int8"
    TORCH_EXPORT = "torch_export"

    def __str__(self) -> str:
        return self.value


class ModelExtension(str, Enum):
    """Artifact file extensions (JAX ports.py:132; focoos/ports.py:631)."""

    EXPORTED_PROGRAM = "pt2"
    WEIGHTS = "npz"


def bucket_program_name(hw: Tuple[int, int]) -> str:
    """The file of the ``torch.export`` program of size bucket (H, W), beside ``model.pt2``."""
    return f"model_{hw[0]}x{hw[1]}.{ModelExtension.EXPORTED_PROGRAM.value}"


class ArtifactName(str, Enum):
    """Well-known file names inside a model run directory (focoos/ports.py:1366).
    ``EXPORTED_PROGRAM`` is the port's program at the export size; each size
    bucket sits beside it as ``model_{H}x{W}.pt2``."""

    WEIGHTS = "model_final.npz"
    WEIGHTS_INT8 = "model_int8.npz"
    STABLEHLO = "model.stablehlo"
    SAVEDMODEL = "saved_model"  # TF SavedModel directory (portable serving)
    EXPORTED_PROGRAM = "model.pt2"
    CALIBRATION = "calibration.npz"
    INFO = "model_info.json"
    METRICS = "metrics.json"
    LOGS = "log.txt"


@dataclass
class FocoosDet:
    """A single detection/segmentation/keypoint result (focoos/ports.py:303).

    ``bbox`` is [x1, y1, x2, y2] in pixels; ``mask`` is a base64-encoded PNG
    cropped to the bbox; ``keypoints`` is a list of (x, y, visibility).
    """

    bbox: Optional[List[int]] = None
    conf: Optional[float] = None
    cls_id: Optional[int] = None
    label: Optional[str] = None
    mask: Optional[str] = None
    keypoints: Optional[List[Tuple[int, int, float]]] = None

    @classmethod
    def from_json(cls, data: Union[str, dict]) -> "FocoosDet":
        if isinstance(data, str):
            with open(data, encoding="utf-8") as f:
                data = json.load(f)
        assert isinstance(data, dict)
        bbox = data.get("bbox")
        if bbox is not None:
            data = {**data, "bbox": [int(v) for v in bbox]}
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclass
class InferLatency:
    """Per-stage wall-clock latency of one infer call in seconds (focoos/ports.py:360)."""

    imload: Optional[float] = None
    preprocess: Optional[float] = None
    inference: Optional[float] = None
    postprocess: Optional[float] = None
    annotate: Optional[float] = None


@dataclass
class FocoosDetections:
    """A batch-element worth of results (focoos/ports.py:373)."""

    detections: List[FocoosDet]
    image: Optional[Union[str, np.ndarray]] = None
    latency: Optional[InferLatency] = None

    def __len__(self) -> int:
        return len(self.detections)

    def model_dump(self) -> dict:
        return {
            "detections": [asdict(det) for det in self.detections],
            "image": self.image if isinstance(self.image, str) else None,
            "latency": asdict(self.latency) if self.latency is not None else None,
        }

    @classmethod
    def from_json(cls, data: Union[str, dict]) -> "FocoosDetections":
        if isinstance(data, str):
            with open(data, encoding="utf-8") as f:
                data = json.load(f)
        assert isinstance(data, dict)
        dets = [FocoosDet.from_json(d) for d in data.get("detections", [])]
        lat = data.get("latency")
        return cls(detections=dets, latency=InferLatency(**lat) if lat else None)


@dataclass
class LatencyMetrics:
    """Benchmark summary in milliseconds (focoos/ports.py:557)."""

    fps: int
    engine: str
    min: float
    max: float
    mean: float
    std: float
    im_size: int
    device: str


@dataclass
class ModelConfig:
    """Base class for per-family typed configs (focoos/ports.py:926).

    Plain dataclass — configs are static python values that parameterize
    module construction; they never enter jit.
    """

    num_classes: int

    def to_dict(self) -> dict:
        def convert(v):
            if hasattr(v, "to_dict"):
                return v.to_dict()
            if isinstance(v, Enum):
                return v.value
            if isinstance(v, (list, tuple)):
                return [convert(x) for x in v]
            return v

        return {f.name: convert(getattr(self, f.name)) for f in fields(self)}

    def update(self, overrides: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in fields(self)}
        bad = set(overrides) - known
        if bad:
            raise ValueError(f"Unknown config overrides for {type(self).__name__}: {sorted(bad)}")
        for k, v in overrides.items():
            setattr(self, k, v)
        return self


class ModelOutput:
    """Marker base for model outputs.

    Family outputs are dataclasses of tensors (see each family's
    ``ports.py``). This base exists only for isinstance checks at the API
    layer.
    """


SchedulerType = str  # "POLY" | "FIXED" | "COSINE" | "MULTISTEP"
OptimizerType = str  # "ADAMW" | "SGD" | "RMSPROP"


@dataclass
class TrainerArgs:
    """Unified training configuration (focoos/ports.py:973).

    Field names match the reference so CLI flags and user scripts port
    unchanged. TPU-specific knobs are grouped at the bottom.
    """

    run_name: str
    output_dir: str = MODELS_DIR
    ckpt_dir: Optional[str] = None
    init_checkpoint: Optional[str] = None
    resume: bool = False
    # logistics
    num_devices: int = -1  # -1 = all local devices (analog of num_gpus)
    device: str = "tpu"
    workers: int = 4
    workers_timeout: float = 0  # seconds the training loader waits on its workers for a batch, then raises; 0: no limit
    amp_enabled: bool = True  # bf16 compute
    checkpointer_period: int = 1000
    checkpointer_max_to_keep: int = 1
    eval_period: int = 200
    log_period: int = 20
    samples: int = 9
    seed: int = 42
    early_stop: bool = True
    patience: int = 10
    # EMA
    ema_enabled: bool = False
    ema_decay: float = 0.999
    ema_warmup: int = 2000
    # hyperparameters
    learning_rate: float = 5e-4
    weight_decay: float = 0.02
    max_iters: int = 3000
    batch_size: int = 16
    scheduler: SchedulerType = "MULTISTEP"
    scheduler_extra: Optional[dict] = None
    optimizer: OptimizerType = "ADAMW"
    optimizer_extra: Optional[dict] = None
    weight_decay_norm: float = 0.0
    weight_decay_embed: float = 0.0
    backbone_multiplier: float = 0.1
    decoder_multiplier: float = 1.0
    head_multiplier: float = 1.0
    freeze_bn: bool = False
    clip_gradients: float = 0.1
    size_divisibility: int = 0
    gather_metric_period: int = 1
    zero_grad_before_forward: bool = False
    sync_to_hub: bool = False
    # TPU-specific
    max_instances_per_image: int = 100  # static padding of per-image targets
    donate_state: bool = True  # buffer donation in the jitted train step
    # K optimizer steps per host dispatch (lax.scan inside one XLA call) —
    # amortizes host/dispatch latency on remote or host-bound setups.
    # Hook periods (log/ckpt/eval) should be multiples of this.
    steps_per_call: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None  # default: (num_devices,) data mesh
    # State-sharding strategy over the mesh: "dp" (replicated, the reference's
    # DDP), "fsdp" (ZeRO-3 leaf sharding over `data`), "tp" (Megatron
    # attention/MLP sharding over `model` — needs a 2-D mesh_shape), or
    # "fsdp_tp" (both). See parallel/sharding.py.
    sharding: str = "dp"

    # Back-compat aliases for reference scripts.
    @property
    def num_gpus(self) -> int:
        return self.num_devices

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainerArgs":
        known = {f.name for f in fields(cls)}
        d = dict(d)
        if "num_gpus" in d and "num_devices" not in d:
            d["num_devices"] = d.pop("num_gpus")
        return cls(**{k: v for k, v in d.items() if k in known})


class DatasetSplitType(str, Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"


@dataclass
class DatasetMetadata:
    """Dataset-level metadata (focoos/ports.py:1070)."""

    num_classes: int
    task: Task
    count: Optional[int] = None
    name: Optional[str] = None
    image_root: Optional[str] = None
    thing_classes: Optional[List[str]] = None
    stuff_classes: Optional[List[str]] = None
    sem_seg_root: Optional[str] = None
    ignore_label: Optional[int] = None
    thing_dataset_id_to_contiguous_id: Optional[dict] = None
    stuff_dataset_id_to_contiguous_id: Optional[dict] = None
    json_file: Optional[str] = None
    keypoints: Optional[List[str]] = None
    keypoints_skeleton: Optional[List[Tuple[int, int]]] = None

    @property
    def classes(self) -> List[str]:
        if self.task in (Task.DETECTION, Task.INSTANCE_SEGMENTATION, Task.CLASSIFICATION, Task.KEYPOINT):
            assert self.thing_classes is not None, f"thing_classes required for {self.task}"
            return self.thing_classes
        if self.task == Task.SEMSEG:
            assert self.stuff_classes is not None, "stuff_classes required for semseg"
            return self.stuff_classes
        raise ValueError(f"Task {self.task} not supported")


@dataclass
class DatasetEntry:
    """One mapped training/eval record (focoos/ports.py:938).

    ``image`` is HWC uint8/float numpy; ``instances`` is a
    ``focoos_tpu_torch.structures.Instances`` (numpy-backed).
    """

    image: Optional[np.ndarray] = None
    height: Optional[int] = None
    width: Optional[int] = None
    instances: Optional[Any] = None
    sem_seg: Optional[np.ndarray] = None
    label: Optional[Union[int, List[int]]] = None  # classification
    file_name: Optional[str] = None
    image_id: Optional[int] = None


@dataclass
class ModelInfo:
    """Serializable model card — the unit of model exchange (focoos/ports.py:1191)."""

    name: str
    model_family: ModelFamily
    classes: List[str]
    im_size: Union[int, Tuple[int, int]]
    task: Task
    config: Dict[str, Any]
    focoos_model: Optional[str] = None
    ref: Optional[str] = None
    status: ModelStatus = ModelStatus.CREATED
    description: Optional[str] = None
    train_args: Optional[dict] = None
    weights_uri: Optional[str] = None
    val_dataset: Optional[str] = None
    val_metrics: Optional[Dict[str, float]] = None
    latency: Optional[List[dict]] = None
    focoos_version: Optional[str] = None
    updated_at: Optional[str] = None
    # round-trip tolerance (reference ports.py:1191): keys a newer/older hub
    # schema carries that this dataclass doesn't model are preserved verbatim
    # and re-emitted by dump_json — a reference-trained card parses losslessly
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @classmethod
    def from_json(cls, path_or_dict: Union[str, dict]) -> "ModelInfo":
        if isinstance(path_or_dict, str):
            if os.path.isdir(path_or_dict):
                path_or_dict = os.path.join(path_or_dict, ArtifactName.INFO.value)
            with open(path_or_dict, encoding="utf-8") as f:
                data = json.load(f)
        else:
            data = dict(path_or_dict)
        data["model_family"] = ModelFamily(data["model_family"])
        data["task"] = Task(data["task"])
        if data.get("status"):
            data["status"] = ModelStatus(data["status"])
        if isinstance(data.get("im_size"), list):
            data["im_size"] = tuple(data["im_size"])
        known = {f.name for f in fields(cls)} - {"extras"}
        extras = {k: v for k, v in data.items() if k not in known}
        return cls(**{k: v for k, v in data.items() if k in known}, extras=extras)

    def dump_json(self, path: str) -> str:
        if os.path.isdir(path) or not path.endswith(".json"):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, ArtifactName.INFO.value)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        def default(o):
            if isinstance(o, Enum):
                return o.value
            if isinstance(o, (np.integer,)):
                return int(o)
            if isinstance(o, (np.floating,)):
                return float(o)
            if isinstance(o, np.ndarray):
                return o.tolist()
            raise TypeError(f"not serializable: {type(o)}")

        data = asdict(self)
        extras = data.pop("extras", None) or {}
        # unknown-schema keys ride along (never clobbering modeled fields)
        data = {**extras, **data}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, default=default)
        return path
