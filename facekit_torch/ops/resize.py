"""Image resampling, with OpenCV semantics.

Port of ``facekit/ops/resize.py``: a separable resize is ``out = W_rows @
img @ W_cols^T`` per channel, with OpenCV's half-pixel source mapping
``src = (dst + 0.5) * in/out - 0.5``, border replication by index
clamping, and either a 2-tap triangle kernel (INTER_LINEAR) or the 4-tap
Keys cubic with A = -0.75 (INTER_CUBIC).

  * ``resize_image``: a fixed-geometry resize (``embed_cropped``, and the
    letterbox's inner resize);
  * ``letterbox``: aspect-preserving linear resize to the detector input,
    centred with the reference's truncating integer placement, pad 128;
  * ``crop_resize``: each box of a frame cropped and resized, one axis
    after the other, as a weighted sum of the taps each output pixel
    reads (``_axis_taps``), gathered and summed in tap order. facekit
    builds a matrix per box instead; a matrix product sums its taps in an
    order the library picks by shape, while the gather sums them in one
    fixed order, so a crop from a window of the frame (``origins``) is
    bit-identical to the crop from the whole frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_CUBIC_A = -0.75  # OpenCV's bicubic kernel coefficient


def _cubic_kernel(x, xp=torch):
    """Keys cubic convolution kernel with a=-0.75 (OpenCV INTER_CUBIC)."""
    x = xp.abs(x)
    a = _CUBIC_A
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a
    return xp.where(x <= 1.0, near, xp.where(x < 2.0, far, 0.0 * x))


def _linear_kernel(x, xp=torch):
    return xp.maximum(1.0 - xp.abs(x), 0.0 * x)


_KERNELS = {"linear": (_linear_kernel, 2), "cubic": (_cubic_kernel, 4)}


def _tap_offsets(support: int) -> np.ndarray:
    # 2 taps -> [0, 1]; 4 taps -> [-1, 0, 1, 2] around floor(src)
    start = -(support // 2 - 1)
    return np.arange(start, start + support)


def resize_matrix(in_size: int, out_size: int, method: str = "linear",
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense (out_size, in_size) interpolation matrix for one axis."""
    kernel, support = _KERNELS[method]
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src)
    frac = src - base
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for t in _tap_offsets(support):
        idx = np.clip(base + t, 0, in_size - 1).astype(np.int64)
        np.add.at(w, (np.arange(out_size), idx), kernel(t - frac, xp=np))
    return torch.tensor(w, dtype=dtype, device=device)


def saturate_uint8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's uint8 output: round half to even, clamp to [0, 255]."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def resize_image(img: torch.Tensor, out_hw: Tuple[int, int],
                 method: str = "linear", saturate: bool = False
                 ) -> torch.Tensor:
    """Resize an (H, W, C) or (N, H, W, C) image with OpenCV semantics."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    _, h, w, _ = img.shape
    oh, ow = out_hw
    wr = resize_matrix(h, oh, method, device=img.device)
    wc = resize_matrix(w, ow, method, device=img.device)
    out = torch.einsum("oh,nhwc->nowc", wr, img.float())
    out = torch.einsum("pw,nowc->nopc", wc, out)
    if saturate:
        out = saturate_uint8(out)
    return out[0] if squeeze else out


def letterbox_geometry(frame_hw: Tuple[int, int],
                       target_hw: Tuple[int, int]):
    """Integer letterbox placement as the reference computes it
    (``src/retinaface.cpp:111-122``): float scales, a truncating int for
    the scaled extent, integer-division centring. Returns (resized_h,
    resized_w, offset_y, offset_x, scale)."""
    fh, fw = frame_hw
    th, tw = target_hw
    scale_h = th / fh
    scale_w = tw / fw
    if scale_h > scale_w:
        w, h = tw, int(scale_w * fh)
        x, y = 0, (th - h) // 2
        scale = scale_w
    else:
        w, h = int(scale_h * fw), th
        x, y = (tw - w) // 2, 0
        scale = scale_h
    return h, w, y, x, scale


def letterbox(img: torch.Tensor, target_hw: Tuple[int, int],
              pad_value: float = 128.0, saturate: bool = True
              ) -> torch.Tensor:
    """Aspect-preserving INTER_LINEAR resize + centre pad.

    ``img`` is (H, W, C) or (N, H, W, C) in the frame geometry; the output
    is f32 in the detector input geometry, ``pad_value`` outside the image.
    """
    squeeze = img.dim() == 3
    if squeeze:
        img = img[None]
    n, fh, fw, c = img.shape
    h, w, y, x, _ = letterbox_geometry((fh, fw), target_hw)
    th, tw = target_hw
    out = torch.full((n, th, tw, c), pad_value, dtype=torch.float32,
                     device=img.device)
    out[:, y:y + h, x:x + w] = resize_image(img, (h, w), "linear",
                                            saturate=saturate)
    return out[0] if squeeze else out


def _axis_taps(lo: torch.Tensor, hi: torch.Tensor, in_size: int,
               out_size: int, method: str,
               origin: Optional[torch.Tensor] = None):
    """The taps resampling the [lo, hi) crops of one axis: (index, weight)
    lists, each (..., out_size) per tap, in tap order.

    ``lo``/``hi`` (any leading shape) are already floor-truncated, as the
    reference truncates float box corners to ``cv::Point``
    (``src/arcface.cpp:6``). Sampling coordinates are clamped to the crop,
    so border replication matches cropping then resizing; a tap outside
    the source weighs 0 (its index is clamped into range). Positions and
    weights in f32, in facekit's operation order
    (``facekit/ops/resize.py:151-182``).

    ``origin`` (integral, ``lo``'s shape): the source is a window cut at
    this offset from a larger image, while ``lo``/``hi`` stay in the
    image's coordinates. Positions and weights are computed in full
    coordinates and only the integer indices shift by the origin, so the
    weights are bit-identical to the full image's."""
    kernel, support = _KERNELS[method]
    lo = lo.float()[..., None]
    hi = torch.maximum(hi.float()[..., None], lo + 1.0)
    scale = (hi - lo) / out_size
    dst = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    src = lo + (dst + 0.5) * scale - 0.5
    base = torch.floor(src)
    frac = src - base
    shift = 0.0 if origin is None else origin.float()[..., None]
    taps = []
    for t in _tap_offsets(support):
        idx = torch.minimum(torch.maximum(base + float(t), lo),
                            hi - 1.0) - shift
        inside = (idx >= 0) & (idx <= in_size - 1)
        wt = torch.where(inside, kernel(float(t) - frac), 0.0)
        taps.append((idx.clamp(0, in_size - 1).long(), wt))
    return taps


def _tap_sum(taps, gather):
    """sum over taps of weight x ``gather(index)``, in tap order; each
    weight is shaped to broadcast against what ``gather`` returns."""
    out = None
    for idx, wt in taps:
        term = wt * gather(idx)
        out = term if out is None else out + term
    return out


def crop_resize(frame: torch.Tensor, boxes: torch.Tensor,
                out_hw: Tuple[int, int] = (112, 112), method: str = "cubic",
                saturate: bool = True,
                origins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop each box from ``frame`` and resize it, rows then columns.

    ``frame`` (H, W, C) with ``boxes`` (F, 4), or frames (N, H, W, C) with
    boxes (N, F, 4); boxes are (x1, y1, x2, y2) in pixels. Returns
    (F, oh, ow, C) or (N, F, oh, ow, C) in f32: OpenCV's resize of
    ``frame[y1:y2, x1:x2]`` (``src/arcface.cpp:3-17``).

    ``origins`` (F, 2) or (N, F, 2), integral (x, y): ``frame`` holds one
    window per face, (F, h, w, C) or (N, F, h, w, C), cut from a larger
    image at these offsets, while ``boxes`` stay in that image's
    coordinates (facekit's ``origins=``, the windowed alignment). Where
    the window holds every tap of its box, the result is bit-identical to
    cropping from the whole image: the same weights times the same pixels,
    summed in the same order."""
    single = boxes.dim() == 2
    if single:
        frame, boxes = frame[None], boxes[None]
        origins = None if origins is None else origins[None]
    n, nf = boxes.shape[:2]
    h, w = frame.shape[-3:-1]
    oh, ow = out_hw
    b = torch.floor(boxes.float())
    ox = oy = None
    if origins is not None:
        ox, oy = origins[..., 0], origins[..., 1]
    frame = frame.float()
    rows = _axis_taps(b[..., 1], b[..., 3], h, oh, method, oy)  # (n,f,oh)
    cols = _axis_taps(b[..., 0], b[..., 2], w, ow, method, ox)  # (n,f,ow)
    nidx = torch.arange(n, device=frame.device)[:, None, None]
    if origins is None:
        def gather_rows(idx):                     # -> (n, f, oh, w, C)
            return frame[nidx, idx]
    else:
        fidx = torch.arange(nf, device=frame.device)[None, :, None]

        def gather_rows(idx):
            return frame[nidx, fidx, idx]
    tmp = _tap_sum([(i, wt[..., None, None]) for i, wt in rows],
                   gather_rows)                             # (n,f,oh,w,C)

    def gather_cols(idx):                                   # (n,f,oh,ow,C)
        index = idx[:, :, None, :, None].expand(n, nf, oh, ow, tmp.shape[-1])
        return torch.gather(tmp, 3, index)
    out = _tap_sum([(i, wt[:, :, None, :, None]) for i, wt in cols],
                   gather_cols)
    if saturate:
        out = saturate_uint8(out)
    return out[0] if single else out
