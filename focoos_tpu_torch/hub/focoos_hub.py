"""FocoosHUB client (port of focoos_tpu/hub/focoos_hub.py; reference:
focoos/hub/focoos_hub.py:48-396). ``MODELS_DIR`` is read at each call."""

from __future__ import annotations

import os
from typing import List, Optional

from focoos_tpu_torch.hub.api_client import ApiClient
from focoos_tpu_torch import ports
from focoos_tpu_torch.ports import ArtifactName, DatasetPreview, ModelInfo, RemoteModelInfo, User
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class FocoosHUB:
    def __init__(self, api_key: Optional[str] = None, host_url: Optional[str] = None):
        self.api_client = ApiClient(api_key, host_url)

    def get_user_info(self) -> User:
        r = self.api_client.get("user/")
        r.raise_for_status()
        return User.from_dict(r.json())

    def list_remote_models(self) -> List[RemoteModelInfo]:
        r = self.api_client.get("models/")
        r.raise_for_status()
        return [RemoteModelInfo.from_dict(m) for m in r.json()]

    def get_model_info(self, model_ref: str) -> dict:
        r = self.api_client.get(f"models/{model_ref}")
        r.raise_for_status()
        return r.json()

    def get_remote_model(self, model_ref: str):
        from focoos_tpu_torch.hub.remote_model import RemoteModel

        return RemoteModel(model_ref, self.api_client)

    def list_remote_datasets(self, include_shared: bool = False) -> List[DatasetPreview]:
        """(reference: focoos_hub.py:275) — typed previews; optionally also
        datasets shared with the user."""
        r = self.api_client.get("datasets/", params={"include_shared": include_shared})
        r.raise_for_status()
        return [DatasetPreview.from_dict(d) for d in r.json()]

    def get_remote_dataset(self, ref: str):
        from focoos_tpu_torch.hub.remote_dataset import RemoteDataset

        return RemoteDataset(ref, self.api_client)

    def new_model(self, name: str, focoos_model: str, description: str = "") -> dict:
        """(reference :341)"""
        r = self.api_client.post(
            "models/", data=dict(name=name, focoos_model=focoos_model, description=description)
        )
        r.raise_for_status()
        return r.json()

    def download_model_pth(self, model_ref: str, out_dir: Optional[str] = None) -> str:
        """(reference :227-273) — downloads the hub's weights file as it is."""
        out_dir = out_dir or os.path.join(ports.MODELS_DIR, model_ref)
        info = self.get_model_info(model_ref)
        uri = info.get("weights_uri")
        assert uri, f"model {model_ref} has no weights_uri"
        return self.api_client.download_ext_file(uri, out_dir)

    def get_local_model(self, model_ref: str, out_dir: Optional[str] = None):
        """→ (ModelInfo, weights_dir) — resolves hub:// refs for ModelManager:
        the card as ``model_info.json`` and its ``weights_uri`` downloaded into
        ``weights_dir`` as ``model_final.npz`` (the JAX-layout file that
        FocoosModel loads), whatever the URI's own file name or query string,
        an existing file kept. Raises where the card has no ``weights_uri`` or
        the download left no file: a model without them would be random."""
        out_dir = out_dir or os.path.join(ports.MODELS_DIR, model_ref)
        os.makedirs(out_dir, exist_ok=True)
        info_dict = self.get_model_info(model_ref)
        info = ModelInfo.from_json(info_dict)
        if not info.weights_uri:
            raise ValueError(f"hub model {model_ref} has no weights_uri")
        info.dump_json(out_dir)
        npz = self.api_client.download_ext_file(info.weights_uri, out_dir, file_name=ArtifactName.WEIGHTS.value)
        if not os.path.isfile(npz):
            raise FileNotFoundError(f"hub model {model_ref}: {info.weights_uri} gave no {npz}")
        return info, out_dir
