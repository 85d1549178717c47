"""Image loading and annotation (copy of ``focoos_tpu/utils/vision.py``,
trimmed to ``image_loader``, the mask PNG codec and ``annotate_image``; reference:
focoos/utils/vision.py).

The port keeps its own copy so that it runs without ``focoos_tpu``. PIL,
cv2 and requests are imported only inside the functions that need them:
an ndarray image needs none of them.
"""

from __future__ import annotations

import base64
import io
from typing import List, Optional

import numpy as np

from focoos_tpu_torch.ports import FocoosDetections, Task


def image_loader(source) -> np.ndarray:
    """bytes / path / URL / PIL / ndarray → HWC uint8 RGB
    (reference: focoos/utils/vision.py:36)."""
    from PIL import Image

    if isinstance(source, np.ndarray):
        arr = source
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        return arr[..., :3].astype(np.uint8)
    if isinstance(source, Image.Image):
        return np.asarray(source.convert("RGB"))
    if isinstance(source, bytes):
        return np.asarray(Image.open(io.BytesIO(source)).convert("RGB"))
    if isinstance(source, str):
        if source.startswith(("http://", "https://")):
            import requests

            resp = requests.get(source, timeout=30)
            resp.raise_for_status()
            return np.asarray(Image.open(io.BytesIO(resp.content)).convert("RGB"))
        return np.asarray(Image.open(source).convert("RGB"))
    raise ValueError(f"Unsupported image source type: {type(source)}")


def _color_for(cls_id: int) -> tuple:
    # offset keeps class 0 visible (pure black would vanish on dark images)
    k = cls_id + 1
    return (int((k * 67 + 80) % 255), int((k * 131 + 40) % 255), int((k * 29 + 160) % 255))


def mask_to_base64_png(mask: np.ndarray) -> str:
    """bool HxW mask → base64 PNG (cropped mask payload in FocoosDet)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((mask.astype(np.uint8)) * 255).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def base64_png_to_mask(data: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(data)))) > 127


def annotate_image(
    image: np.ndarray,
    detections: FocoosDetections,
    task: Task = Task.DETECTION,
    classes: Optional[List[str]] = None,
) -> np.ndarray:
    """Draw boxes/masks/keypoints onto a copy of ``image``
    (reference: focoos/utils/vision.py:437)."""
    import cv2

    img = np.ascontiguousarray(image.copy())
    h, w = img.shape[:2]
    for det in detections.detections:
        color = _color_for(det.cls_id or 0)
        if det.mask is not None:
            m = base64_png_to_mask(det.mask)
            if det.bbox is not None and m.shape != (h, w):
                x0, y0, x1, y1 = det.bbox
                full = np.zeros((h, w), bool)
                mh, mw = min(m.shape[0], y1 - y0), min(m.shape[1], x1 - x0)
                full[y0 : y0 + mh, x0 : x0 + mw] = m[:mh, :mw]
                m = full
            if m.shape == (h, w):
                overlay = img.copy()
                overlay[m] = color
                img = cv2.addWeighted(img, 0.6, overlay, 0.4, 0)
        if det.bbox is not None and task != Task.SEMSEG:
            x0, y0, x1, y1 = det.bbox
            cv2.rectangle(img, (x0, y0), (x1, y1), color, 2)
            label = det.label or (classes[det.cls_id] if classes and det.cls_id is not None else str(det.cls_id))
            txt = f"{label} {det.conf:.2f}" if det.conf is not None else str(label)
            cv2.putText(img, txt, (x0, max(y0 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
        if det.keypoints:
            for x, y, v in det.keypoints:
                if v > 0.3:
                    cv2.circle(img, (int(x), int(y)), 3, color, -1)
    return img
