"""HTTP client for the Focoos hub API (port of focoos_tpu/hub/api_client.py;
reference: focoos/utils/api_client.py:16-247).

The same headers, timeouts, paths and download rules as the JAX package's
client (a ``.part`` file renamed when complete, an existing file kept). The
JAX package sends through ``requests``; the port sends through the standard
library's ``urllib.request``, behind the one function ``_open``, which tests
replace. ``file://`` URLs open through it too.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
import uuid
from dataclasses import dataclass
from typing import Dict, Optional

from focoos_tpu_torch.config import FOCOOS_CONFIG
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class HTTPError(RuntimeError):
    """An answer with a status of 400 or more."""

    def __init__(self, status_code: int, url: str, text: str):
        super().__init__(f"HTTP {status_code} from {url}: {text[:200]}")
        self.status_code = status_code


@dataclass
class Response:
    """What the hub answered: the parts of a ``requests.Response`` the clients read."""

    status_code: int
    content: bytes = b""
    url: str = ""

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content) if self.content else None

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPError(self.status_code, self.url, self.text)


def _open(method: str, url: str, headers: Dict[str, str], body: Optional[bytes], timeout: float):
    """The transport: the opened answer (file-like, with ``status`` and
    ``headers``), an error status included; it raises only where nothing
    answered."""
    req = urllib.request.Request(url, data=body, headers=headers, method=method)
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:  # an answer all the same: the caller reads its status
        return e


def _status(answer) -> int:
    status = getattr(answer, "status", None) or getattr(answer, "code", None)
    return int(status) if status else 200  # file:// answers carry no status


def _multipart(fields: Dict[str, tuple]) -> tuple:
    """``{field: (file name, bytes or a binary file)}`` → (body, content type)."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, (file_name, data) in fields.items():
        payload = data if isinstance(data, bytes) else data.read()
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; filename="{file_name}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n".encode() + payload + b"\r\n"
        )
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


class ApiClient:
    def __init__(self, api_key: Optional[str] = None, host_url: Optional[str] = None):
        self.api_key = api_key or FOCOOS_CONFIG.focoos_api_key
        self.host_url = host_url or FOCOOS_CONFIG.default_host_url
        self._headers = {
            "X-API-Key": self.api_key,
            "user_agent": "focoos-tpu/0.1.0",
        }

    def _url(self, path: str) -> str:
        return f"{self.host_url}/{path.lstrip('/')}"

    def _request(self, method: str, path: str, timeout: float, params: Optional[dict] = None,
                 data: Optional[dict] = None, files: Optional[dict] = None) -> Response:
        url = self._url(path)
        if params:
            url += ("&" if "?" in url else "?") + urllib.parse.urlencode(params)
        headers, body = dict(self._headers), None
        if files:
            body, headers["Content-Type"] = _multipart(files)
        elif data is not None:
            body, headers["Content-Type"] = json.dumps(data).encode(), "application/json"
        with _open(method, url, headers, body, timeout) as answer:
            return Response(_status(answer), answer.read(), url)

    def get(self, path: str, params: Optional[dict] = None) -> Response:
        return self._request("GET", path, 60, params=params)

    def post(self, path: str, data: Optional[dict] = None, files=None) -> Response:
        return self._request("POST", path, 120, data=data, files=files)

    def patch(self, path: str, data: Optional[dict] = None) -> Response:
        return self._request("PATCH", path, 60, data=data)

    def delete(self, path: str) -> Response:
        return self._request("DELETE", path, 60)

    def upload_file(self, path: str, file_path: str, field: str = "file") -> Response:
        with open(file_path, "rb") as f:
            return self.post(path, files={field: (os.path.basename(file_path), f)})

    def download_ext_file(self, url: str, out_dir: str, file_name: Optional[str] = None, skip_if_exists: bool = True) -> str:
        """External download with progress + skip-if-exists (reference :196)."""
        os.makedirs(out_dir, exist_ok=True)
        file_name = file_name or url.split("/")[-1].split("?")[0]
        out_path = os.path.join(out_dir, file_name)
        if skip_if_exists and os.path.isfile(out_path):
            logger.info(f"{out_path} exists, skipping download")
            return out_path
        with _open("GET", url, {}, None, 300) as r:
            status = _status(r)
            if status >= 400:
                raise HTTPError(status, url, r.read().decode("utf-8", "replace"))
            total = int((r.headers or {}).get("content-length", 0) or 0)
            done = 0
            with open(out_path + ".part", "wb") as f:
                while chunk := r.read(1 << 20):
                    f.write(chunk)
                    done += len(chunk)
                    if total:
                        logger.debug(f"download {done / total:.0%}")
        os.replace(out_path + ".part", out_path)
        logger.info(f"Downloaded {url} → {out_path}")
        return out_path
