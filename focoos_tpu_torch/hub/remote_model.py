"""RemoteModel — cloud model handle (port of focoos_tpu/hub/remote_model.py;
reference: focoos/hub/remote_model.py:50)."""

from __future__ import annotations

import os
import time
from typing import List

from focoos_tpu_torch.hub.api_client import ApiClient
from focoos_tpu_torch.ports import ArtifactName, FocoosDetections
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class RemoteModel:
    def __init__(self, model_ref: str, api_client: ApiClient):
        self.model_ref = model_ref
        self.api_client = api_client

    def get_info(self) -> dict:
        r = self.api_client.get(f"models/{self.model_ref}")
        r.raise_for_status()
        return r.json()

    def infer(self, image_path: str, threshold: float = 0.5) -> FocoosDetections:
        """Upload an image for remote inference (reference :245-313)."""
        with open(image_path, "rb") as f:
            r = self.api_client.post(f"models/{self.model_ref}/inference?confidence_threshold={threshold}",
                                     files={"file": (os.path.basename(image_path), f)})
        r.raise_for_status()
        return FocoosDetections.from_json(r.json())

    def sync_local_training_job(self, run_dir: str, iteration: int = -1, upload_weights: bool = False) -> None:
        """Upload status/metrics(/weights) of a local run (reference :113-179)."""
        info_path = os.path.join(run_dir, ArtifactName.INFO.value)
        metrics_path = os.path.join(run_dir, ArtifactName.METRICS.value)
        payload = {"iteration": iteration}
        if os.path.isfile(info_path):
            import json

            with open(info_path) as f:
                payload["model_info"] = json.load(f)
        self.api_client.patch(f"models/{self.model_ref}/training-job", data=payload)
        if os.path.isfile(metrics_path):
            self.api_client.upload_file(f"models/{self.model_ref}/metrics", metrics_path)
        if upload_weights:
            w = os.path.join(run_dir, ArtifactName.WEIGHTS.value)
            if os.path.isfile(w):
                self.api_client.upload_file(f"models/{self.model_ref}/weights", w)

    def train_logs(self) -> List[str]:
        """(reference :200)"""
        r = self.api_client.get(f"models/{self.model_ref}/train/logs")
        r.raise_for_status()
        return r.json()

    def metrics(self) -> dict:
        """Remote training metrics (reference :176 RemoteModel.metrics)."""
        r = self.api_client.get(f"models/{self.model_ref}/metrics")
        r.raise_for_status()
        return r.json()

    def monitor_train(self, poll_seconds: float = 30.0, timeout: float = 3600.0) -> dict:
        """Poll training status until terminal (reference :314 notebook monitor)."""
        start = time.time()
        while time.time() - start < timeout:
            info = self.get_info()
            status = info.get("status")
            logger.info(f"[{self.model_ref}] status={status}")
            if status in ("TRAINING_COMPLETED", "TRAINING_ERROR", "TRAINING_STOPPED"):
                return info
            time.sleep(poll_seconds)
        raise TimeoutError(f"training monitor timed out after {timeout}s")

    def notebook_monitor_train(self, interval: int = 30, plot_metrics: bool = False,
                               max_runtime: int = 36000) -> dict:
        """Status + tail-of-logs + optional metric plot each poll, until the
        job reaches a terminal state (reference :314-383)."""
        start = time.time()
        last_log_len = 0
        while time.time() - start < max_runtime:
            info = self.get_info()
            status = info.get("status")
            try:
                lines = self.train_logs()
                for line in lines[last_log_len:]:
                    logger.info(f"[{self.model_ref}] {line}")
                last_log_len = len(lines)
            except Exception as e:  # logs endpoint may lag the job
                logger.debug(f"train_logs unavailable: {e}")
            if plot_metrics:
                try:
                    from focoos_tpu_torch.utils.metrics import Metrics, MetricsVisualizer

                    raw = self.metrics()
                    m = Metrics(
                        train_metrics=raw.get("train_metrics", []),
                        valid_metrics=raw.get("valid_metrics", []),
                        best_valid_metric=raw.get("best_valid_metric"),
                    )
                    MetricsVisualizer(m).notebook_plot_training_metrics()
                except Exception as e:
                    logger.debug(f"metrics plot unavailable: {e}")
            logger.info(f"[{self.model_ref}] status={status}")
            if status in ("TRAINING_COMPLETED", "TRAINING_ERROR", "TRAINING_STOPPED"):
                return info
            time.sleep(interval)
        raise TimeoutError(f"training monitor timed out after {max_runtime}s")
