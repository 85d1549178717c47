"""The port's ``config``, ``utils/system`` and ``utils/metrics`` against the
JAX package's modules of the same names, on the CPU."""

import json
import random

import numpy as np
import pytest
import torch

import focoos_tpu.config as jax_config
from focoos_tpu.utils import metrics as jax_metrics
from focoos_tpu.utils import system as jax_system
from focoos_tpu_torch import config
from focoos_tpu_torch.ports import RuntimeType
from focoos_tpu_torch.utils import metrics, system


def test_system_info_reports_torch_and_the_devices():
    info = system.get_system_info()
    assert info.torch_version == torch.__version__ and info.cuda_version == torch.version.cuda
    assert (info.process_index, info.process_count) == (0, 1)
    assert set(info.packages) == {"numpy", "scipy", "einops"} and info.packages["numpy"] == np.__version__
    if torch.cuda.is_available():
        assert info.backend == "cuda" and info.device_count == torch.cuda.device_count()
        assert info.devices[0].kind == torch.cuda.get_device_name(0) and info.devices[0].memory_gb > 0
    else:
        assert info.backend == "cpu" and info.device_count == 0 and info.devices[0].platform == "cpu"


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_seed_all_rng_matches_jax(seed):
    """Python's ``random`` and numpy's global state after the port's
    ``seed_all_rng`` equal those after the JAX package's."""
    assert system.seed_all_rng(seed) == seed
    got = (random.random(), np.random.random())
    assert jax_system.seed_all_rng(seed) == seed
    assert got == (random.random(), np.random.random())


def test_trainer_seeds_every_rng(monkeypatch, tmp_path):
    """The trainer seeds Python's ``random`` and numpy through
    ``seed_all_rng`` (rank 0: the run's seed), as JAX's trainer does."""
    from test_torch_model_manager import TINY

    from focoos_tpu_torch import ModelManager
    from focoos_tpu_torch.ports import TrainerArgs
    from focoos_tpu_torch.trainer import trainer

    seen = []

    class Stop(Exception):
        pass

    def record(seed):
        seen.append(seed)
        raise Stop

    monkeypatch.setattr(trainer, "seed_all_rng", record)
    model = ModelManager.get("fai-detr-l-coco", device="cpu", init_weights=False, **TINY)
    with pytest.raises(Stop):
        trainer.FocoosTrainer(model, TrainerArgs(run_name="s", output_dir=str(tmp_path), seed=13), []).train()
    assert seen == [13]


def test_config_reads_the_environment_as_jax(monkeypatch):
    """Every ``FOCOOS_*`` variable parses as the JAX package's does; the
    runtime default is ``CUDA_BF16``, the counterpart of ``XLA_TPU_BF16``."""
    default = config.FocoosConfig()
    assert default.runtime_type == RuntimeType.CUDA_BF16
    assert jax_config.FocoosConfig().runtime_type.value == "xla_tpu_bf16"
    env = {"FOCOOS_API_KEY": "k-1", "FOCOOS_LOG_LEVEL": "DEBUG", "FOCOOS_HOST_URL": "http://127.0.0.1:9/v0",
           "FOCOOS_WARMUP_ITER": "5", "FOCOOS_COMPILE_CACHE": "no"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, ref = config.FocoosConfig(), jax_config.FocoosConfig()
    for f in ("focoos_api_key", "focoos_log_level", "default_host_url", "warmup_iter", "compile_cache_enabled"):
        assert getattr(got, f) == getattr(ref, f), f
    assert (got.warmup_iter, got.compile_cache_enabled) == (5, False)
    monkeypatch.setenv("FOCOOS_RUNTIME_TYPE", "cuda_fp32")
    assert config.FocoosConfig().runtime_type == RuntimeType.CUDA_FP32


def test_parse_metrics_matches_jax(tmp_path):
    """A trainer's metrics.json (JSON lines: training rows, validation rows, a
    blank and a broken line) parses as the JAX package's parser parses it."""
    rows = [{"iteration": 0, "total_loss": 3.0, "loss_bbox": 1.0}, {"iteration": 1, "total_loss": 2.5},
            {"iteration": 1, "bbox/AP": 12.5, "bbox/AP50": 30.0}, {"iteration": 3, "total_loss": 2.0},
            {"iteration": 3, "bbox/AP": 20.0}]
    path = tmp_path / "metrics.json"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n{broken\n")
    got, ref = metrics.parse_metrics(str(path)), jax_metrics.parse_metrics(str(path))
    assert got.train_metrics == ref.train_metrics and got.valid_metrics == ref.valid_metrics
    assert got.best_valid_metric == ref.best_valid_metric == rows[4] and got.iterations == ref.iterations == 3
    assert metrics.parse_metrics(str(tmp_path / "missing.json")).iterations is None
