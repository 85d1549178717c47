"""The port's hub client (``focoos_tpu_torch/hub``), ``hub://`` models and
the trainer's hub sync, offline.

tests/test_hub.py's cases for the JAX package, mirrored against the port's
``FocoosHUB`` with its one transport function (``api_client._open``)
replaced by a fake hub that records every request: so the port's own
request building (URLs, query strings, JSON and multipart bodies, headers,
timeouts) runs in every case. One case goes through ``urllib`` for real,
against an ``http.server`` on the loopback interface, and one through a
``file://`` URL.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_cli import model_dir, run, threads  # noqa: F401 (fixtures)
from test_torch_model_manager import TINY
from test_torch_train import N_TARGETS, SIZE, _dataset

from focoos_tpu_torch import ModelManager, ports
from focoos_tpu_torch.hub import api_client
from focoos_tpu_torch.hub.api_client import ApiClient
from focoos_tpu_torch.hub.focoos_hub import FocoosHUB
from focoos_tpu_torch.ports import ModelInfo, TrainerArgs

HOST = "https://hub.test/v0"


class _Answer(io.BytesIO):
    def __init__(self, status: int, body: bytes):
        super().__init__(body)
        self.status, self.headers = status, {"content-length": str(len(body))}


class FakeHub:
    """The transport: ``routes`` maps (method, path) to (status, JSON payload
    or bytes, or a callable of the request that returns them); every request
    is kept in ``calls`` with its decoded URL, query, headers and body."""

    def __init__(self, routes=None, fail=None):
        self.routes, self.calls, self.fail = dict(routes or {}), [], fail

    def __call__(self, method, url, headers, body, timeout):
        u = urllib.parse.urlsplit(url)
        path = u.path[len("/v0/"):] if u.netloc == "hub.test" else url
        call = SimpleNamespace(method=method, path=path, query=urllib.parse.parse_qs(u.query), headers=headers,
                               body=body, timeout=timeout)
        self.calls.append(call)
        if self.fail is not None:
            raise self.fail
        status, payload = self.routes.get((method, path), (404, {"detail": "no route"}))
        if callable(payload):
            payload = payload(call)
        return _Answer(status, payload if isinstance(payload, bytes) else json.dumps(payload).encode())


@pytest.fixture()
def fake(monkeypatch):
    hub = FakeHub()
    monkeypatch.setattr(api_client, "_open", hub)
    return hub


@pytest.fixture()
def hub():
    return FocoosHUB(api_key="test-key", host_url=HOST)


def test_get_user_info(hub, fake):
    fake.routes[("GET", "user/")] = (200, {"email": "a@b.c", "company": "x"})
    assert hub.get_user_info().email == "a@b.c"
    call = fake.calls[0]
    assert call.headers["X-API-Key"] == "test-key" and call.timeout == 60 and call.body is None


def test_list_remote_models(hub, fake):
    fake.routes[("GET", "models/")] = (200, [{"ref": "r1", "name": "m1", "focoos_model": "fai-detr-m-coco",
                                              "task": "detection", "status": "TRAINING_COMPLETED"}])
    models = hub.list_remote_models()
    assert len(models) == 1 and models[0].ref == "r1"


def test_new_model_posts(hub, fake):
    fake.routes[("POST", "models/")] = (201, lambda c: {"ref": "new-ref", "name": json.loads(c.body)["name"]})
    out = hub.new_model("my-model", "fai-detr-m-coco", "desc")
    assert out["ref"] == "new-ref"
    call = fake.calls[0]
    assert json.loads(call.body)["name"] == "my-model" and call.headers["Content-Type"] == "application/json"
    assert call.timeout == 120


def test_api_client_auth_header():
    c = ApiClient(api_key="secret", host_url="https://example.test/v0")
    assert c._headers.get("X-API-Key") == "secret"
    assert c._url("models/x") == "https://example.test/v0/models/x"


def test_remote_model_infer_parses_detections(hub, fake, tmp_path):
    img = tmp_path / "x.jpg"
    img.write_bytes(b"\xff\xd8fake")
    fake.routes[("POST", "models/ref1/inference")] = (200, {
        "detections": [{"bbox": [0, 0, 5, 5], "conf": 0.9, "cls_id": 1, "label": "cat"}],
        "latency": {"inference": 0.01}})
    dets = hub.get_remote_model("ref1").infer(str(img), threshold=0.5)
    assert dets.detections[0].label == "cat"
    call = fake.calls[0]
    assert call.query == {"confidence_threshold": ["0.5"]}
    assert call.headers["Content-Type"].startswith("multipart/form-data; boundary=")
    assert b'name="file"; filename="x.jpg"' in call.body and b"\xff\xd8fake" in call.body


def test_hub_download_skips_network_when_cached(hub, fake, tmp_path):
    weights = tmp_path / "model_final.pth"
    weights.write_bytes(b"123")
    fake.routes[("GET", "models/ref1")] = (200, {"weights_uri": "https://cdn.test/x/model_final.pth"})
    out = hub.download_model_pth("ref1", out_dir=str(tmp_path))
    assert out == str(weights) and weights.read_bytes() == b"123"
    assert [c.path for c in fake.calls] == ["models/ref1"]  # the file itself was not fetched


def test_remote_model_notebook_monitor_polls_to_terminal(hub, fake, monkeypatch):
    statuses = iter(["TRAINING_RUNNING", "TRAINING_RUNNING", "TRAINING_COMPLETED"])
    logs = iter([["l1"], ["l1", "l2"], ["l1", "l2", "l3"]])
    fake.routes[("GET", "models/r/train/logs")] = (200, lambda c: next(logs))
    fake.routes[("GET", "models/r")] = (200, lambda c: {"status": next(statuses), "ref": "r"})
    import time as _t

    monkeypatch.setattr(_t, "sleep", lambda s: None)
    assert hub.get_remote_model("r").notebook_monitor_train(interval=0)["status"] == "TRAINING_COMPLETED"


def test_remote_dataset_roundtrip(hub, fake, tmp_path):
    """info, download (a .part file renamed when whole), upload (multipart),
    delete, and a delete the hub refuses."""
    ds = hub.get_remote_dataset("my-ds")
    fake.routes[("GET", "datasets/my-ds")] = (200, {"ref": "my-ds", "download_uri": "https://cdn.test/d.zip"})
    fake.routes[("GET", "https://cdn.test/d.zip")] = (200, b"zipbytes")
    assert ds.get_info()["ref"] == "my-ds"
    out = ds.download_data(out_dir=str(tmp_path / "dl"))
    assert out == str(tmp_path / "dl" / "d.zip") and open(out, "rb").read() == b"zipbytes"
    assert not os.path.exists(out + ".part")

    fake.routes[("POST", "datasets/my-ds/upload")] = (200, {"ok": True})
    zp = tmp_path / "up.zip"
    zp.write_bytes(b"zip")
    assert ds.upload_data(str(zp))["ok"] is True
    assert b'filename="up.zip"' in fake.calls[-1].body

    fake.routes[("DELETE", "datasets/my-ds/data")] = (200, {})
    ds.delete_data()
    fake.routes[("DELETE", "datasets/my-ds/data")] = (500, {"detail": "no"})
    with pytest.raises(RuntimeError, match="HTTP 500"):
        ds.delete_data()


def test_hub_dto_depth_full_payload(hub, fake):
    fake.routes[("GET", "user/")] = (200, {
        "email": "a@b.c", "company": "x", "created_at": "2026-01-01", "updated_at": "2026-02-01",
        "api_key": {"key": "sk-123"},
        "quotas": {"total_inferences": 10, "max_inferences": 100, "used_storage_gb": 1.5, "max_storage_gb": 10.0,
                   "active_training_jobs": ["j1"], "max_active_training_jobs": 2,
                   "used_mlg4dnxlarge_training_jobs_hours": 0.5, "max_mlg4dnxlarge_training_jobs_hours": 5.0,
                   "some_future_field": True}})
    user = hub.get_user_info()
    assert user.api_key == "sk-123" and user.quotas.max_storage_gb == 10.0
    assert user.quotas.active_training_jobs == ["j1"]
    fake.routes[("GET", "models/")] = (200, [{
        "ref": "r1", "name": "m1", "task": "detection", "status": "TRAINING_COMPLETED", "is_managed": False,
        "owner_ref": "u1", "focoos_model": "fai-detr-m-coco", "focoos_version": "0.25.0",
        "metrics": {"bbox/AP": 44.7},
        "training_info": {"main_status": "Completed", "instance_type": "g4dn", "artifact_location": "s3://x"},
        "dataset": {"ref": "d1", "name": "coco", "task": "detection", "layout": "roboflow_coco",
                    "spec": {"train_length": 100, "valid_length": 10, "size_mb": 5.0}},
        "hyperparameters": {"lr": 1e-4}, "unknown_api_field": 1}])
    m = hub.list_remote_models()[0]
    assert m.training_info.main_status == "Completed" and m.dataset.spec.train_length == 100
    assert m.hyperparameters["lr"] == 1e-4


def test_list_remote_datasets_typed_and_shared_flag(hub, fake):
    fake.routes[("GET", "datasets/")] = (200, [{"ref": "d1", "name": "chess", "task": "detection",
                                                "layout": "roboflow_coco",
                                                "spec": {"train_length": 8, "valid_length": 2, "size_mb": 1.0}}])
    out = hub.list_remote_datasets(include_shared=True)
    assert fake.calls[0].query == {"include_shared": ["True"]}  # as requests encodes a bool
    assert out[0].spec.valid_length == 2 and out[0].task.value == "detection"


def test_cli_hub_dataset_download_and_upload(fake, tmp_path, monkeypatch):
    """``hub dataset download|upload`` and ``hub models|datasets|download``
    through the port's CLI and client, against the fake hub."""
    from focoos_tpu_torch import config
    from focoos_tpu_torch.cli import cli

    monkeypatch.setattr(config.FOCOOS_CONFIG, "default_host_url", HOST)
    fake.routes.update({
        ("GET", "datasets/my-ds"): (200, {"ref": "my-ds", "name": "chess", "task": "detection",
                                          "layout": "roboflow_coco", "download_uri": "https://cdn.test/chess.zip"}),
        ("GET", "https://cdn.test/chess.zip"): (200, b"z"),
        ("POST", "datasets/my-ds/upload"): (200, {"train_length": 4, "valid_length": 2, "size_mb": 1.2}),
        ("GET", "models/"): (200, [{"ref": "r1", "name": "m1", "task": "detection", "status": "TRAINING_COMPLETED"}]),
        ("GET", "datasets/"): (200, [{"ref": "d1", "name": "chess", "task": "detection", "layout": "roboflow_coco"}]),
        ("GET", "models/r1"): (200, {"weights_uri": "https://cdn.test/r1/model_final.npz"}),
        ("GET", "https://cdn.test/r1/model_final.npz"): (200, b"npz"),
    })
    monkeypatch.setattr(ports, "MODELS_DIR", str(tmp_path / "models"))
    out = run(cli.main, ["hub", "dataset", "download", "--ref", "my-ds", "--path", str(tmp_path / "data"),
                         "--api-key", "k"])
    assert f"downloaded dataset → {tmp_path / 'data' / 'chess.zip'}" in out
    zp = tmp_path / "d.zip"
    zp.write_bytes(b"z")
    out = run(cli.main, ["hub", "dataset", "upload", "--ref", "my-ds", "--path", str(zp)])
    assert "uploaded" in out and "train=4" in out and "name: chess" in out
    assert run(cli.main, ["hub", "models"]).split() == ["r1", "m1", "detection", "TRAINING_COMPLETED"]
    assert run(cli.main, ["hub", "datasets", "--include-shared"]).split() == ["d1", "chess", "detection",
                                                                              "roboflow_coco"]
    out = run(cli.main, ["hub", "download", "--ref", "r1"])
    assert out.strip() == f"downloaded → {tmp_path / 'models' / 'r1' / 'model_final.npz'}"
    assert all(c.headers.get("X-API-Key") == "k" for c in fake.calls[:2] if "X-API-Key" in c.headers)


def test_modelinfo_reference_card_lossless_roundtrip(tmp_path):
    card = {
        "name": "m", "model_family": "fai_detr", "task": "detection", "im_size": 640, "classes": ["a"],
        "config": {"k": 1}, "ref": "hub-ref-1", "focoos_version": "0.25.0", "latency": [{"fps": 87}],
        "train_args": {"max_iters": 10}, "updated_at": "2026-01-01", "status": "TRAINING_COMPLETED",
        "a_future_hub_field": {"nested": True},
    }
    mi = ModelInfo.from_json(card)
    assert mi.ref == "hub-ref-1" and mi.extras == {"a_future_hub_field": {"nested": True}}
    rt = json.load(open(mi.dump_json(str(tmp_path))))
    for k, v in card.items():
        assert rt[k] == v, k


def test_hub_model_through_model_manager(model_dir, fake, tmp_path, monkeypatch):  # noqa: F811
    """``ModelManager.get("hub://<ref>", device="cpu")`` downloads the card and
    the JAX-layout weights into ``MODELS_DIR/<ref>/model_final.npz``, from a
    presigned URI of another file name, and serves what the local directory
    serves; a second get reads the cached weights."""
    from focoos_tpu_torch import config

    uri = "https://cdn.test/tiny/weights.npz?X-Amz-Signature=abc"
    monkeypatch.setattr(config.FOCOOS_CONFIG, "default_host_url", HOST)
    monkeypatch.setattr(ports, "MODELS_DIR", str(tmp_path / "models"))
    with open(os.path.join(model_dir, "model_info.json")) as f:
        card = dict(json.load(f), weights_uri=uri, ref="tiny-ref")
    with open(os.path.join(model_dir, "model_final.npz"), "rb") as f:
        weights = f.read()
    fake.routes[("GET", "models/tiny-ref")] = (200, card)
    fake.routes[("GET", uri)] = (200, weights)
    model = ModelManager.get("hub://tiny-ref", device="cpu")
    got_dir = str(tmp_path / "models" / "tiny-ref")
    with open(os.path.join(got_dir, "model_final.npz"), "rb") as f:
        assert f.read() == weights
    img = np.random.default_rng(2).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    ref = ModelManager.get(model_dir, device="cpu").infer(img, threshold=0.0)
    got = model.infer(img, threshold=0.0)
    assert [(d.cls_id, d.conf, d.bbox) for d in got.detections] == [(d.cls_id, d.conf, d.bbox) for d in ref.detections]
    assert model.model_info.ref == "tiny-ref"
    n = len(fake.calls)
    ModelManager.get("hub://tiny-ref", device="cpu", init_weights=False)
    assert [c.path for c in fake.calls[n:]] == ["models/tiny-ref"]  # the card again, not the weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelManager.get("hub://tiny-ref")


@pytest.mark.parametrize("uri", ["https://cdn.test/r/model_final.npz", "https://cdn.test/r/final.pth?sig=1", None])
def test_get_local_model_saves_the_weights_as_model_final(uri, hub, fake, tmp_path):
    """``get_local_model`` saves the card's weights as ``model_final.npz``,
    the one file FocoosModel loads, whatever the URI names; a card without
    ``weights_uri`` raises rather than give a model of random weights."""
    fake.routes[("GET", "models/r")] = (200, {"name": "m", "model_family": "fai_detr", "task": "detection",
                                             "im_size": 64, "classes": ["a"], "config": {}, "weights_uri": uri})
    if uri is None:
        with pytest.raises(ValueError, match="no weights_uri"):
            hub.get_local_model("r", out_dir=str(tmp_path))
        return
    fake.routes[("GET", uri)] = (200, b"weights")
    info, out = hub.get_local_model("r", out_dir=str(tmp_path))
    assert out == str(tmp_path) and info.weights_uri == uri
    assert sorted(os.listdir(tmp_path)) == ["model_final.npz", "model_info.json"]
    assert (tmp_path / "model_final.npz").read_bytes() == b"weights"


@pytest.mark.parametrize("uplink", ["answers", "down", "crash"])
def test_training_syncs_to_the_hub(uplink, tmp_path, threads):  # noqa: F811
    """``TrainerArgs(sync_to_hub=True)``: with the hub answering, the run's
    final status (TRAINING_COMPLETED, set after the loop ended) goes up as the
    training-job PATCH and its metrics.json as an upload, at the end of a run
    shorter than the sync period; with the hub down every sync fails, is
    logged, and training finishes all the same; where the second step raises,
    the PATCH carries TRAINING_ERROR and the run's own exception propagates."""
    from focoos_tpu_torch.trainer.trainer import TrainerLoop

    fake = FakeHub(fail=urllib.error.URLError("connection refused") if uplink == "down" else None)
    fake.routes[("PATCH", "models/fai-detr-l-coco/training-job")] = (200, {})
    fake.routes[("POST", "models/fai-detr-l-coco/metrics")] = (200, {})
    model = ModelManager.get("fai-detr-l-coco", device="cpu", **dict(TINY, image_size=SIZE))
    args = TrainerArgs(run_name="hub", output_dir=str(tmp_path), batch_size=2, max_iters=2, workers=0, log_period=1,
                       checkpointer_period=100, max_instances_per_image=N_TARGETS, sync_to_hub=True)
    real_step = TrainerLoop.run_step

    def second_step_raises(loop):
        if loop.iter == 1:
            raise RuntimeError("planted fault")
        real_step(loop)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api_client, "_open", fake)
        if uplink == "crash":
            mp.setattr(TrainerLoop, "run_step", second_step_raises)
            with pytest.raises(RuntimeError, match="planted fault"):
                model.train(args, _dataset(2), hub=FocoosHUB(api_key="k", host_url=HOST))
            patch = json.loads(next(c.body for c in fake.calls if c.method == "PATCH"))
            assert patch["iteration"] == 0 and patch["model_info"]["status"] == "TRAINING_ERROR"
            assert "planted fault" in patch["model_info"]["description"]
            return
        res = model.train(args, _dataset(2), hub=FocoosHUB(api_key="k", host_url=HOST))
    assert res["iterations"] == 2 and os.path.isfile(os.path.join(res["run_dir"], "model_final.npz"))
    sent = [("PATCH", "models/fai-detr-l-coco/training-job"), ("POST", "models/fai-detr-l-coco/metrics")]
    if uplink == "down":  # the PATCH failed: the sync stopped there, and training went on
        assert [(c.method, c.path) for c in fake.calls] == sent[:1]
        return
    assert [(c.method, c.path) for c in fake.calls] == sent
    patch = json.loads(fake.calls[0].body)
    assert patch["iteration"] == 1 and patch["model_info"]["status"] == "TRAINING_COMPLETED"
    with open(os.path.join(res["run_dir"], "metrics.json"), "rb") as f:
        assert f.read() in fake.calls[1].body


class _Handler(BaseHTTPRequestHandler):
    files: dict = {}
    seen: list = []

    def _reply(self, status, body: bytes):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self.seen.append(("GET", self.path, self.headers.get("X-API-Key"), b""))
        body = self.files.get(self.path)
        self._reply(200 if body is not None else 404, body if body is not None else b'{"detail": "missing"}')

    def do_PATCH(self):
        n = int(self.headers.get("Content-Length", 0))
        self.seen.append(("PATCH", self.path, self.headers.get("X-API-Key"), self.rfile.read(n)))
        self._reply(200, b"{}")

    def log_message(self, *args):
        pass


def test_urllib_transport_over_loopback_and_file_urls(tmp_path):
    """The real transport: JSON GET with the key, a PATCH body, a 404 that
    ``raise_for_status`` raises, a streamed download over HTTP, and a
    download from a ``file://`` URL."""
    _Handler.files = {"/v0/models/r": b'{"ref": "r"}', "/files/w.npz": b"\x00" * 3_000_000}
    _Handler.seen = []
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        client = ApiClient(api_key="key-1", host_url=f"{base}/v0")
        assert client.get("models/r").json() == {"ref": "r"}
        client.patch("models/r/training-job", data={"iteration": 3}).raise_for_status()
        with pytest.raises(RuntimeError, match="HTTP 404"):
            client.get("models/none").raise_for_status()
        out = client.download_ext_file(f"{base}/files/w.npz", str(tmp_path / "dl"))
        assert os.path.getsize(out) == 3_000_000
    finally:
        server.shutdown()
        server.server_close()
    assert _Handler.seen[:2] == [("GET", "/v0/models/r", "key-1", b""),
                                 ("PATCH", "/v0/models/r/training-job", "key-1", b'{"iteration": 3}')]
    src = tmp_path / "src.bin"
    src.write_bytes(b"local")
    out = client.download_ext_file(src.as_uri(), str(tmp_path / "fl"))
    assert open(out, "rb").read() == b"local"
