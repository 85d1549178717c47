"""RemoteDataset — hub dataset handle (port of focoos_tpu/hub/remote_dataset.py;
reference: focoos/hub/remote_dataset.py:11). ``DATASETS_DIR`` is read at each call."""

from __future__ import annotations

import os
from typing import Optional

from focoos_tpu_torch.hub.api_client import ApiClient
from focoos_tpu_torch import ports
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class RemoteDataset:
    def __init__(self, ref: str, api_client: ApiClient):
        self.ref = ref
        self.api_client = api_client

    def get_info(self) -> dict:
        r = self.api_client.get(f"datasets/{self.ref}")
        r.raise_for_status()
        return r.json()

    def download_data(self, out_dir: Optional[str] = None) -> str:
        """(reference :115)"""
        out_dir = out_dir or os.path.join(ports.DATASETS_DIR, self.ref)
        info = self.get_info()
        url = info.get("download_uri") or info.get("url")
        assert url, f"dataset {self.ref} has no download uri"
        return self.api_client.download_ext_file(url, out_dir)

    def upload_data(self, zip_path: str) -> dict:
        """(reference :45)"""
        r = self.api_client.upload_file(f"datasets/{self.ref}/upload", zip_path)
        r.raise_for_status()
        return r.json()

    def delete_data(self) -> None:
        r = self.api_client.delete(f"datasets/{self.ref}/data")
        r.raise_for_status()
