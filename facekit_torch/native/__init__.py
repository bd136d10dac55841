"""ctypes bindings of the port's native host runtime (``host_ops.cpp``).

Port of ``facekit/native/__init__.py``: the same public functions and
contracts, over the port's own copy of the C++ source. The library is
built by ``ops._build.build_host`` (g++ with facekit's flags) into
``build/facekit_torch/`` at first use, never at import, and loaded once
per process. ``available()`` is False when it cannot be built (no g++, no
libjpeg); the compiler's message is logged and kept in ``build_error()``.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from facekit_torch.ops import _build

log = logging.getLogger("facekit_torch.native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.fk_resize_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, f32p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fk_letterbox_det.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                     f32p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_float]
    lib.fk_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_int, i32p]
    lib.fk_nms.restype = ctypes.c_int
    lib.fk_gallery_top1.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                    f32p, ctypes.c_int, f32p, i32p]
    lib.fk_jpeg_dims.argtypes = [u8p, ctypes.c_ulong, i32p, i32p]
    lib.fk_jpeg_dims.restype = ctypes.c_int
    lib.fk_jpeg_decode_bgr.argtypes = [u8p, ctypes.c_ulong, u8p]
    lib.fk_jpeg_decode_bgr.restype = ctypes.c_int
    lib.fk_jpeg_encode_bgr.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_ulong)]
    lib.fk_jpeg_encode_bgr.restype = ctypes.c_long
    lib.fk_free.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None (once, for good) when it
    cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(_build.build_host())))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            log.warning("native host ops unavailable: %s", _error)
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's message), or None."""
    _load()
    return _error


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int],
              method: str = "linear", saturate: bool = True) -> np.ndarray:
    """uint8 (H, W, C) -> float32 (oh, ow, C), OpenCV-semantics resample."""
    lib = _lib_or_raise()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"resize_u8 takes (H, W, C), not {img.shape}")
    h, w, c = img.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, c), np.float32)
    lib.fk_resize_u8(_u8(img), h, w, c, _f32(out), oh, ow,
                     1 if method == "cubic" else 0, 1 if saturate else 0)
    return out


def letterbox_det(frame: np.ndarray, target_hw: Tuple[int, int],
                  mean=(104.0, 117.0, 123.0)) -> np.ndarray:
    """uint8 BGR frame -> normalized f32 detector input (fused on host)."""
    lib = _lib_or_raise()
    frame = np.ascontiguousarray(frame, np.uint8)
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"letterbox_det takes (H, W, 3), not {frame.shape}")
    fh, fw, _ = frame.shape
    th, tw = target_hw
    out = np.empty((th, tw, 3), np.float32)
    lib.fk_letterbox_det(_u8(frame), fh, fw, _f32(out), th, tw,
                         mean[0], mean[1], mean[2])
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
        max_out: int = 128) -> np.ndarray:
    """Greedy NMS; returns indices of kept boxes in descending score order."""
    lib = _lib_or_raise()
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.ndim != 1 or boxes.shape != (len(scores), 4):
        raise ValueError(f"nms takes boxes (N, 4) and scores (N,), not "
                         f"{boxes.shape} and {scores.shape}")
    out = np.empty((min(max_out, len(scores)),), np.int32)
    n = lib.fk_nms(_f32(boxes), _f32(scores), len(scores),
                   iou_threshold, len(out), _i32(out))
    return out[:n]


def decode_jpeg_bgr(data: bytes,
                    resize_wh: Optional[Tuple[int, int]] = None
                    ) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 3) BGR uint8, optionally host-resized to
    (w, h). Returns None on any parse or decode failure (the contract of
    cv2.imdecode). JPEG only: grayscale sources are color-converted by
    libjpeg; other formats fail the header check and return None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    # two calls on purpose (facekit's protocol): the dims pre-parse lets
    # fk_jpeg_decode_bgr write straight into the final exact-size numpy
    # buffer; a one-call C API would return its own allocation, and the
    # copy out of it costs more than the header parse it saves
    if lib.fk_jpeg_dims(_u8(buf), len(data), ctypes.byref(h),
                        ctypes.byref(w)) != 0:
        return None
    img = np.empty((h.value, w.value, 3), np.uint8)
    if lib.fk_jpeg_decode_bgr(_u8(buf), len(data), _u8(img)) != 0:
        return None
    if resize_wh is not None and img.shape[:2] != resize_wh[::-1]:
        ow, oh = resize_wh
        # resize_u8 saturates and rounds already; the cast is exact
        img = resize_u8(img, (oh, ow), "linear",
                        saturate=True).astype(np.uint8)
    return img


def encode_jpeg_bgr(img: np.ndarray, quality: int = 95) -> Optional[bytes]:
    """(H, W, 3) BGR uint8 -> baseline JPEG bytes (cv2.imencode's default
    quality), or None on failure."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg_bgr takes (H, W, 3), not {img.shape}")
    h, w, _ = img.shape
    outbuf = ctypes.POINTER(ctypes.c_uint8)()
    outlen = ctypes.c_ulong(0)
    n = lib.fk_jpeg_encode_bgr(_u8(img), h, w, int(quality),
                               ctypes.byref(outbuf), ctypes.byref(outlen))
    if n < 0 or not outbuf:
        return None
    try:
        return ctypes.string_at(outbuf, outlen.value)
    finally:
        lib.fk_free(outbuf)


def gallery_top1(gallery: np.ndarray, queries: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host search: (scores (B,), indices (B,)) of each query's best row.

    An empty gallery yields index -1 per query (score -1e30): callers
    must not map it into a user list as if it matched."""
    lib = _lib_or_raise()
    gallery = np.ascontiguousarray(gallery, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    n, d = gallery.shape
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"gallery_top1: queries {queries.shape} against "
                         f"a gallery of width {d}")
    b = queries.shape[0]
    scores = np.empty((b,), np.float32)
    idx = np.empty((b,), np.int32)
    lib.fk_gallery_top1(_f32(gallery), n, d, _f32(queries), b,
                        _f32(scores), _i32(idx))
    return scores, idx
