"""Gradio web demo (port of focoos_tpu/cli/gradio_app.py; reference:
focoos/cli/gradio_app.py — task-aware tabs, model dropdown over the registry,
image + video inference) on the port's ``FocoosModel``.

gradio is an optional dependency, imported inside ``launch``: without it
``launch`` raises a ``RuntimeError`` that names it. The video tab reads and
writes frames with cv2, imported inside its callback.
"""

from __future__ import annotations

import os
from typing import Optional

from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_MODEL_CACHE: dict = {}


def _get_model(name: str, image_size: Optional[int] = None, device: str = "cuda"):
    key = (name, image_size, device)
    if key not in _MODEL_CACHE:
        from focoos_tpu_torch.model_manager import ModelManager

        _MODEL_CACHE[key] = ModelManager.get(name, image_size=image_size, device=device)
    return _MODEL_CACHE[key]


def _result_table(model, res):
    """Task-specific tabular summary (reference: gradio_app.py:102 formats
    per-task outputs)."""
    from focoos_tpu_torch.ports import Task

    task = model.task
    rows = []
    for d in res.detections:
        label = d.label or (model.classes[d.cls_id] if model.classes and d.cls_id is not None
                            and d.cls_id < len(model.classes) else d.cls_id)
        if task == Task.CLASSIFICATION:
            rows.append([label, round(d.conf or 0, 3), "-"])
        elif task == Task.KEYPOINT:
            n_vis = sum(1 for k in (d.keypoints or []) if len(k) > 2 and k[2] > 0)
            rows.append([label, round(d.conf or 0, 3), f"{n_vis} keypoints, bbox {d.bbox}"])
        elif task in (Task.SEMSEG, Task.INSTANCE_SEGMENTATION):
            area = None
            if d.mask is not None:
                try:
                    import numpy as np

                    area = int(np.asarray(d.mask).sum())
                except Exception:
                    area = None
            rows.append([label, round(d.conf or 0, 3) if d.conf is not None else "-",
                         f"area {area}px" if area is not None else (d.bbox or "-")])
        else:
            rows.append([label, round(d.conf or 0, 3), d.bbox])
    return rows


def launch(model_name: Optional[str] = None, image_size: Optional[int] = None, share: bool = False,
           device: str = "cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed — `pip install gradio` to use the web demo"
        ) from e

    import numpy as np

    from focoos_tpu_torch.model_registry.model_registry import ModelRegistry

    model_names = ModelRegistry.list_models()
    default_model = model_name or (model_names[0] if model_names else None)

    def predict(image: np.ndarray, name: str, threshold: float):
        model = _get_model(name, image_size, device)
        res = model.infer(image, threshold=threshold, annotate=True)
        return (res.image if res.image is not None else image), _result_table(model, res)

    def predict_video(video_path: str, name: str, threshold: float, max_frames: int = 300):
        """Frame-by-frame inference → annotated mp4 (reference: gradio_app.py:117)."""
        import tempfile

        import cv2

        model = _get_model(name, image_size, device)
        cap = cv2.VideoCapture(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25
        # mkstemp (not the racy deprecated mktemp): create + close the fd,
        # then hand the now-owned path to cv2.VideoWriter
        fd, out_path = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        writer = None
        n = 0
        while n < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            res = model.infer(frame[..., ::-1], threshold=threshold, annotate=True)
            annotated = res.image if res.image is not None else frame[..., ::-1]
            if writer is None:
                h, w = annotated.shape[:2]
                writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            writer.write(np.asarray(annotated)[..., ::-1])
            n += 1
        cap.release()
        if writer is not None:
            writer.release()
        return out_path

    with gr.Blocks(title="focoos-tpu-torch") as demo:
        gr.Markdown("# focoos-tpu-torch demo")
        model_dd = gr.Dropdown(model_names, value=default_model, label="model")
        thr = gr.Slider(0.0, 1.0, value=0.5, label="threshold")
        with gr.Tabs():
            with gr.Tab("Image Inference"):
                img_in = gr.Image(type="numpy")
                btn = gr.Button("Run")
                img_out = gr.Image(type="numpy", label="annotated")
                table = gr.Dataframe(headers=["label", "conf", "detail"])
                btn.click(predict, [img_in, model_dd, thr], [img_out, table])
            with gr.Tab("Video Inference"):
                vid_in = gr.Video()
                vbtn = gr.Button("Run")
                vid_out = gr.Video(label="annotated")
                vbtn.click(predict_video, [vid_in, model_dd, thr], [vid_out])
    demo.launch(share=share)
    return demo
