"""ctypes bindings for the host library ``csrc/focoos_native.cpp`` (port of
``focoos_tpu/utils/native.py``, with the port's own copy of the C++).

COCO RLE encode/decode and area, and dense mask-IoU and box-IoU matrices
(COCO crowd convention on the second operand). The library is compiled with
``g++`` at first use, never at import, into ``focoos_tpu_torch/_build/``,
keyed by a hash of the source. The numpy versions stay, as in the JAX
package, for a machine without ``g++``; ``available()`` says which runs,
and a failed build logs a warning.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "focoos_native.cpp"
BUILD_DIR = _PKG / "_build"

_LIB = None
_TRIED = False
_lock = threading.Lock()


def _build() -> Path:
    """Compile the library if this source's build is missing → its path.
    The compiler writes a temporary file that is renamed into place, so
    processes building at once never load a half-written library."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libfocoos_native-{digest}.so"
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def _load():
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning(f"the native library did not build ({e}); using the numpy versions")
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p, ctypes.c_int]
        lib.rle_encode.restype = ctypes.c_int
        lib.rle_decode.argtypes = [u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.rle_decode.restype = None
        lib.rle_area.argtypes = [u32p, ctypes.c_int]
        lib.rle_area.restype = ctypes.c_uint64
        lib.mask_iou_matrix.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_long, u8p, f32p]
        lib.mask_iou_matrix.restype = None
        lib.bbox_iou_matrix.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, u8p, f32p]
        lib.bbox_iou_matrix.restype = None
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the C++ library built and loaded (else the numpy versions run)."""
    return _load() is not None


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """bool/uint8 HxW mask → COCO column-major RLE counts (uint32)."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = _load()
    if lib is not None:
        buf = np.zeros(h * w + 2, np.uint32)
        n = lib.rle_encode(mask, h, w, buf, buf.size)
        if n > 0:
            return buf[:n].copy()
    flat = mask.T.reshape(-1)
    changes = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.uint32)


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    counts = np.ascontiguousarray(counts, np.uint32)
    lib = _load()
    if lib is not None:
        out = np.zeros((h, w), np.uint8)
        lib.rle_decode(counts, len(counts), h, w, out)
        return out.astype(bool)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    v = 0
    for c in counts:
        flat[pos : pos + int(c)] = v
        pos += int(c)
        v = 1 - v
    return flat.reshape(w, h).T.astype(bool)


def rle_from_string(s) -> np.ndarray:
    """COCO compressed-RLE string → column-major run counts (uint32):
    pycocotools' LEB128 variant (maskApi.c rleFrString): 5 data bits a
    character offset by 48, bit 0x20 continues, bit 0x10 of the last chunk
    sign-extends, and counts from index 3 on are deltas against cnts[i-2]."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.uint32)


def rle_to_string(counts: np.ndarray) -> str:
    """Inverse of :func:`rle_from_string` (maskApi.c rleToString)."""
    out = []
    counts = np.asarray(counts, np.int64)
    for i, x in enumerate(counts.tolist()):
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def coco_rle_decode(seg: dict, h: int, w: int) -> np.ndarray:
    """COCO ``segmentation`` RLE dict (compressed string or uncompressed
    counts list) → bool [H, W] mask."""
    size = seg.get("size")
    if size is not None:
        h, w = int(size[0]), int(size[1])
    counts = seg["counts"]
    if isinstance(counts, (str, bytes)):
        counts = rle_from_string(counts)
    return rle_decode(np.asarray(counts, np.uint32), h, w)


def rle_area(counts: np.ndarray) -> int:
    counts = np.ascontiguousarray(counts, np.uint32)
    lib = _load()
    if lib is not None:
        return int(lib.rle_area(counts, len(counts)))
    return int(counts[1::2].sum())


def mask_iou(masks_a: Sequence[np.ndarray], masks_b: Sequence[np.ndarray],
             crowd_b: Optional[np.ndarray] = None) -> np.ndarray:
    """[Na] × [Nb] dense-mask IoU matrix (COCO crowd convention on b). Masks
    of two sizes raise: the JAX package's library reads past the smaller
    ones (ROADMAP Queue 3, a record resized for evaluation)."""
    na, nb = len(masks_a), len(masks_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), np.float32)
    sizes = {np.shape(m) for m in (*masks_a, *masks_b)}
    if len(sizes) > 1:
        raise ValueError("mask_iou: masks of sizes " + ", ".join("x".join(map(str, s)) for s in sorted(sizes))
                         + " (a record resized for evaluation pairs predictions at its original size with"
                         " ground truth at the mapped size)")
    a = np.ascontiguousarray(np.stack([m.reshape(-1) for m in masks_a]).astype(np.uint8))
    b = np.ascontiguousarray(np.stack([m.reshape(-1) for m in masks_b]).astype(np.uint8))
    crowd = np.ascontiguousarray((crowd_b if crowd_b is not None else np.zeros(nb)).astype(np.uint8))
    lib = _load()
    if lib is not None:
        out = np.zeros((na, nb), np.float32)
        lib.mask_iou_matrix(a, na, b, nb, a.shape[1], crowd, out)
        return out
    inter = a.astype(np.float32) @ b.T.astype(np.float32)
    aa = a.sum(1)[:, None].astype(np.float32)
    ab = b.sum(1)[None, :].astype(np.float32)
    union = np.where(crowd[None, :] > 0, aa, aa + ab - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0).astype(np.float32)


def bbox_iou(boxes_a: np.ndarray, boxes_b: np.ndarray, crowd_b: Optional[np.ndarray] = None) -> np.ndarray:
    na, nb = len(boxes_a), len(boxes_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), np.float32)
    a = np.ascontiguousarray(boxes_a, np.float32)
    b = np.ascontiguousarray(boxes_b, np.float32)
    crowd = np.ascontiguousarray((crowd_b if crowd_b is not None else np.zeros(nb)).astype(np.uint8))
    lib = _load()
    if lib is not None:
        out = np.zeros((na, nb), np.float32)
        lib.bbox_iou_matrix(a, na, b, nb, crowd, out)
        return out
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    union = np.where(crowd[None, :] > 0, area_a, area_a + area_b - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0).astype(np.float32)
