"""5-point similarity-transform face alignment (``facekit/ops/align.py``).

Umeyama's least-squares similarity from the five detected landmarks to
the ArcFace 112x112 template, in 2-D closed form, then the warp as a crop
window (``crop_resize``, linear) and two 1-D resampling passes ("shear"):
pass A resamples each window row at ``alpha*u + beta*y + gamma``, pass B
each column at ``c*xo + d*yo + f``, both as banded weight matrices applied
with matrix products. Past 45 degrees of in-plane rotation a face's window
is transposed and the inverse map's rows swapped, so the pass-B
coefficient is never near 0. The pass products take the compute dtype
with f32 accumulation, as facekit's ``preferred_element_type``.

Functions are batched over leading dims where facekit vmaps.
``warp_align_gather`` is facekit's per-pixel gather formulation, kept as
a public op; serving uses the shear passes. ``warp_align_frames``'s
``slice_win`` (facekit's windowed crop, which serving does not use) cuts
each face's window from the uint8 frame before the crop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from facekit_torch.ops.resize import crop_resize

# Canonical ArcFace 112x112 5-point template (insightface norm_crop)
ARCFACE_TEMPLATE_112 = np.array([
    [38.2946, 51.6963],
    [73.5318, 51.5014],
    [56.0252, 71.7366],
    [41.5493, 92.3655],
    [70.7299, 92.2041],
], dtype=np.float32)


def umeyama(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity transform src -> dst.

    src (..., P, 2), dst (P, 2) or (..., P, 2). Returns (..., 2, 3) M with
    dst ~= src @ M[:, :2].T + M[:, 2]. The rotation is
    ``R(atan2(c - b, a + d))`` of cov = [[a, b], [c, d]] and the scale
    ``sqrt((a+d)^2 + (c-b)^2) / var(src)``; a degenerate cov (coincident
    landmarks) gives the identity rotation and unit scale, a pure centroid
    translation, so nothing downstream divides by 0."""
    src = src.float()
    dst = dst.float()
    n = src.shape[-2]
    mu_s = src.mean(-2)
    mu_d = dst.mean(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum("...pa,...pb->...ab", dc, sc) / n
    t1 = cov[..., 0, 0] + cov[..., 1, 1]
    t2 = cov[..., 1, 0] - cov[..., 0, 1]
    p2 = torch.clamp_min(torch.sqrt(t1 * t1 + t2 * t2), 1e-12)
    degenerate = (t1 * t1 + t2 * t2) < 1e-20
    cos_t = torch.where(degenerate, 1.0, t1 / p2)
    sin_t = torch.where(degenerate, 0.0, t2 / p2)
    r = torch.stack([torch.stack([cos_t, -sin_t], -1),
                     torch.stack([sin_t, cos_t], -1)], -2)
    var_s = torch.clamp_min((sc ** 2).sum(-1).mean(-1), 1e-12)
    scale = torch.where(degenerate, 1.0, p2 / var_s)
    t = mu_d - scale[..., None] * (r @ mu_s[..., None])[..., 0]
    return torch.cat([scale[..., None, None] * r, t[..., None]], -1)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) affine -> its inverse."""
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                       torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1)],
                      -2) / det[..., None, None]
    return torch.cat([inv, -(inv @ m[..., 2:3])], -1)


def _bilinear_sample(frame: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) frame at float coordinates xs, ys (any equal
    shapes) bilinearly; constant 0 outside (``facekit/ops/align.py:
    89-122``: four single-axis gathers on the flattened frame)."""
    h, w, c = frame.shape
    flat = frame.reshape(h * w, c)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = flat[idx.reshape(-1)].reshape(*yi.shape, c)
        return torch.where(inb[..., None], vals, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _linear_axis_weights(pos: torch.Tensor, size: int) -> torch.Tensor:
    """(..., out) positions -> (..., out, size) 2-tap linear weights, zero
    outside [0, size) (constant-0 border, cv2.warpAffine's default)."""
    grid = torch.arange(size, dtype=torch.float32, device=pos.device)
    return torch.clamp_min(1.0 - torch.abs(grid - pos[..., None]), 0.0)


def _default_window(out_hw) -> int:
    """Crop-window resolution for an output size: it scales with the
    output, floor 160, rounded up to a multiple of 8."""
    base = -(-max(out_hw) * 10 // 7)        # ceil(out * 10/7)
    return max(160, (base + 7) // 8 * 8)


def _template(out_hw, device) -> torch.Tensor:
    oh, ow = out_hw
    t = torch.tensor(ARCFACE_TEMPLATE_112, device=device)
    if (oh, ow) != (112, 112):
        t = t * torch.tensor([ow / 112.0, oh / 112.0], device=device)
    return t


def _window_box(lm: torch.Tensor, template: torch.Tensor, oh: int,
                ow: int) -> torch.Tensor:
    """Square window (x1, y1, x2, y2) covering each face's warp source
    quad, +2 px margin; lm (..., 5, 2) -> (..., 4)."""
    mi = _invert_affine(umeyama(lm, template))
    corners = torch.tensor([[0.0, 0.0], [ow, 0.0], [0.0, oh], [ow, oh]],
                           dtype=torch.float32, device=lm.device)
    src = corners @ mi[..., :, :2].transpose(-1, -2) + mi[..., None, :, 2]
    lo = src.amin(-2) - 2.0
    hi = src.amax(-2) + 2.0
    side = (hi - lo).amax(-1, keepdim=True)
    return torch.cat([lo, lo + side], -1)


def _shear_passes(win, lm, box, template, c_win, oh, ow, dtype):
    """Two-pass shear warp of (F, c_win, c_win, 3) windows to
    (F, oh, ow, 3); lm (F, 5, 2) and box (F, 4) per window."""
    # the landmark -> window mapping matches crop_resize's sampling:
    # src = lo + (u + 0.5) * scale - 0.5
    lox, loy = torch.floor(box[:, 0]), torch.floor(box[:, 1])
    hix = torch.maximum(torch.floor(box[:, 2]), lox + 1.0)
    hiy = torch.maximum(torch.floor(box[:, 3]), loy + 1.0)
    scx = ((hix - lox) / c_win)[:, None]
    scy = ((hiy - loy) / c_win)[:, None]
    lw = torch.stack([(lm[..., 0] - lox[:, None] + 0.5) / scx - 0.5,
                      (lm[..., 1] - loy[:, None] + 0.5) / scy - 0.5], -1)
    mi = _invert_affine(umeyama(lw, template))
    # pass B's coefficient d = mi[1, 1] ~ cos(theta)/s vanishes near +-90
    # degrees: there transpose the window and swap the inverse map's rows,
    # which makes it mi[0, 1] ~ sin(theta)/s (one of the two is always at
    # least cos 45 degrees)
    swap = torch.abs(mi[:, 1, 1]) < torch.abs(mi[:, 0, 1])
    mi = torch.where(swap[:, None, None], mi.flip(-2), mi)
    win = torch.where(swap[:, None, None, None], win.transpose(1, 2), win)
    a, b, e = mi[:, 0, 0], mi[:, 0, 1], mi[:, 0, 2]
    c, d, f = mi[:, 1, 0], mi[:, 1, 1], mi[:, 1, 2]
    d = torch.where(torch.abs(d) < 1e-3, 1e-3, d)    # unreachable guard
    beta = b / d
    alpha = a - beta * c
    gamma = e - beta * f

    def per(v):
        return v[:, None, None]

    dev = win.device
    ys = torch.arange(c_win, dtype=torch.float32, device=dev)
    us = torch.arange(ow, dtype=torch.float32, device=dev)
    # pass A: H[y, u] = win[y, alpha*u + beta*y + gamma]
    pos_a = per(alpha) * us[None, :] + per(beta) * ys[:, None] + per(gamma)
    wa = _linear_axis_weights(pos_a, c_win)               # (F, C, ow, C)
    ha = torch.matmul(wa.to(dtype).float(), win.to(dtype).float())
    # pass B: O[yo, xo] = H[c*xo + d*yo + f, xo]
    xo = torch.arange(ow, dtype=torch.float32, device=dev)
    yo = torch.arange(oh, dtype=torch.float32, device=dev)
    pos_b = per(c) * xo[None, :] + per(d) * yo[:, None] + per(f)  # (F,oh,ow)
    wb = _linear_axis_weights(pos_b.transpose(1, 2), c_win)  # (F,ow,oh,C)
    ht = ha.transpose(1, 2)                                  # (F,ow,C,3)
    ot = torch.matmul(wb.to(dtype).float(), ht.to(dtype).float())
    return ot.transpose(1, 2)                                # (F,oh,ow,3)


def _window_crops(frames: torch.Tensor, boxes: torch.Tensor, s: int,
                  c_win: int) -> torch.Tensor:
    """Each face's S x S window cut from the uint8 frames at the clamped
    integer origin floor(box) - 1, then ``crop_resize`` with that origin:
    (N, F, c_win, c_win, 3), bit-identical to the full frame's crop when
    every window holds its box (``facekit/ops/align.py:320-341``)."""
    n, h, w, _ = frames.shape
    dev = frames.device
    ox = torch.clamp(torch.floor(boxes[..., 0]) - 1, 0, w - s).long()
    oy = torch.clamp(torch.floor(boxes[..., 1]) - 1, 0, h - s).long()
    span = torch.arange(s, device=dev)
    rows = (oy[..., None] + span)[..., :, None]              # (N, F, S, 1)
    cols = (ox[..., None] + span)[..., None, :]              # (N, F, 1, S)
    nidx = torch.arange(n, device=dev)[:, None, None, None]
    wins = frames[nidx, rows, cols]                          # (N,F,S,S,3)
    return crop_resize(wins.float(), boxes, (c_win, c_win), "linear",
                       saturate=False, origins=torch.stack([ox, oy], -1))


def warp_align_frames(frames: torch.Tensor, landmarks: torch.Tensor,
                      out_hw: Tuple[int, int] = (112, 112),
                      window: Optional[int] = None,
                      dtype=torch.float32,
                      slice_win: Optional[int] = None) -> torch.Tensor:
    """Batched alignment: frames (N, H, W, 3) (uint8 or float) and
    landmarks (N, F, 5, 2) -> (N, F, oh, ow, 3) f32 (facekit's
    ``warp_align_frames``, ``facekit/ops/align.py:273-354``). ``dtype``
    is the precision of the two pass products only; positions and weights
    are built in f32 and the products accumulate in f32.

    ``slice_win=S`` (pass the uint8 frames): when every face's window box
    has a side of at most S - 4, each face's S x S window is cut from the
    frame and cropped with an integer tap shift, which is bit-identical to
    the full-frame path; one larger face anywhere sends the whole batch
    down the full-frame path. The choice costs one host sync (facekit
    branches on the device with ``lax.cond``). The served path never takes
    this option."""
    oh, ow = out_hw
    c_win = window or _default_window(out_hw)
    n, nf = landmarks.shape[:2]
    h, w = frames.shape[1:3]
    template = _template(out_hw, frames.device)
    lms = landmarks.float()
    boxes = _window_box(lms, template, oh, ow)               # (N, F, 4)
    s = slice_win
    if (s is not None and s < max(h, w) and s <= h and s <= w
            and bool(((boxes[..., 2] - boxes[..., 0]) <= s - 4).all())):
        wins = _window_crops(frames, boxes, s, c_win)
    else:
        wins = crop_resize(frames.float(), boxes, (c_win, c_win), "linear",
                           saturate=False)                   # (N,F,C,C,3)
    out = _shear_passes(wins.reshape(n * nf, c_win, c_win, 3),
                        lms.reshape(n * nf, 5, 2), boxes.reshape(n * nf, 4),
                        template, c_win, oh, ow, dtype)
    return out.reshape(n, nf, oh, ow, 3)


def warp_align_shear(frame: torch.Tensor, landmarks: torch.Tensor,
                     out_hw: Tuple[int, int] = (112, 112),
                     window: Optional[int] = None,
                     dtype=torch.float32) -> torch.Tensor:
    """One frame (H, W, 3) and landmarks (F, 5, 2) -> (F, oh, ow, 3)."""
    return warp_align_frames(frame[None], landmarks[None], out_hw, window,
                             dtype)[0]


def warp_align_gather(frame: torch.Tensor, landmarks: torch.Tensor,
                      out_hw: Tuple[int, int] = (112, 112)) -> torch.Tensor:
    """Align faces by 5-point landmarks with a per-pixel inverse map and
    bilinear gathers (``facekit/ops/align.py:358-380``): frame (H, W, C),
    landmarks (F, 5, 2) in (x, y) frame pixels -> (F, oh, ow, C) f32."""
    oh, ow = out_hw
    frame = frame.float()
    dev = frame.device
    mi = _invert_affine(umeyama(landmarks.float(), _template(out_hw, dev)))
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")                 # (oh, ow)

    def coord(row):
        m = mi[:, row, :, None, None]
        return m[:, 0] * gx + m[:, 1] * gy + m[:, 2]

    return _bilinear_sample(frame, coord(0), coord(1))


# the default alignment: the gather-free shear formulation
warp_align = warp_align_shear
