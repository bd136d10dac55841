"""Box decode, letterbox un-mapping and exact greedy NMS.

Port of ``facekit/ops/boxes.py``, the fixed-shape replacement of the
reference's post-processing (``src/retinaface.cpp:154-271``): decode all
anchors at once, mask scores under the threshold to -inf, greedy NMS over
the ``nms_top_k`` best candidates, and exactly ``max_faces`` slots per
frame with a validity mask. Coordinates are (x1, y1, x2, y2), x across
columns; variances (0.1, 0.2); IoU with the reference's +1 area
convention.

Order is facekit's everywhere: ``jax.lax.top_k`` puts the lower index
first among equal values, and ``torch.topk`` is not stable, so every
ranking here is a stable descending sort (``_top_k``).

Greedy NMS is computed as a fixed point, not as facekit's k-step loop.
With S[i, j] = IoU(i, j) >= threshold over candidates in score order,
greedy's keep vector is the unique K with K[j] = valid[j] and no i < j has
K[i] and S[i, j]: entry j depends only on entries before it. Applying that
map to any K fixes one more leading entry each time, so iterating it from
``valid`` reaches greedy's answer, and a K that the map leaves unchanged
is that answer. Each step is one batched matrix expression; the loop stops
when a step changes nothing (a suppression chain's depth, 2 for a dense
stack), instead of taking k sequential launches per frame.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

VARIANCES = (0.1, 0.2)
NEG_INF = float("-inf")


class Detections(NamedTuple):
    """Fixed-shape detection results (max_faces slots + validity mask)."""
    boxes: torch.Tensor       # (..., F, 4) x1, y1, x2, y2 in frame pixels
    scores: torch.Tensor      # (..., F)
    valid: torch.Tensor       # (..., F) bool
    landmarks: Optional[torch.Tensor] = None  # (..., F, 5, 2) or None


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, lower index
    first among equal values, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., A, *tail) gathered at idx (..., K) along the A axis."""
    tail = x.shape[idx.dim():]
    flat = idx.reshape(*idx.shape, *([1] * len(tail))).expand(
        *idx.shape, *tail)
    return torch.gather(x, idx.dim() - 1, flat)


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor,
                 input_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., A, 4) regression deltas + (A, 4) anchors -> (..., A, 4)
    pixel corner boxes."""
    h, w = input_hw
    v0, v1 = VARIANCES
    cx = anchors[:, 0] + loc[..., 0] * v0 * anchors[:, 2]
    cy = anchors[:, 1] + loc[..., 1] * v0 * anchors[:, 3]
    sx = anchors[:, 2] * torch.exp(loc[..., 2] * v1)
    sy = anchors[:, 3] * torch.exp(loc[..., 3] * v1)
    return torch.stack([(cx - sx / 2) * w, (cy - sy / 2) * h,
                        (cx + sx / 2) * w, (cy + sy / 2) * h], -1)


def decode_landmarks(ldm: torch.Tensor, anchors: torch.Tensor,
                     input_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., A, 10) landmark deltas -> (..., A, 5, 2) pixel (x, y)."""
    h, w = input_hw
    v0 = VARIANCES[0]
    ldm = ldm.reshape(*ldm.shape[:-1], 5, 2)
    px = anchors[:, None, 0] + ldm[..., 0] * v0 * anchors[:, None, 2]
    py = anchors[:, None, 1] + ldm[..., 1] * v0 * anchors[:, None, 3]
    return torch.stack([px * w, py * h], -1)


def _unletterbox_geometry(frame_hw, input_hw):
    """(scale, pad_x, pad_y) of the reference's float-offset decode
    (``src/retinaface.cpp:177-187``), shared by boxes and points."""
    fh, fw = frame_hw
    th, tw = input_hw
    scale_h, scale_w = th / fh, tw / fw
    scale = min(scale_h, scale_w)
    if scale_h > scale_w:
        return scale, 0.0, (th - scale * fh) / 2
    return scale, (tw - scale * fw) / 2, 0.0


def unletterbox_boxes(boxes: torch.Tensor, frame_hw: Tuple[int, int],
                      input_hw: Tuple[int, int]) -> torch.Tensor:
    """Boxes from detector-input pixels back to frame pixels."""
    scale, pad_x, pad_y = _unletterbox_geometry(frame_hw, input_hw)
    shift = torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=boxes.dtype,
                         device=boxes.device)
    return (boxes - shift) / scale


def unletterbox_points(points: torch.Tensor, frame_hw: Tuple[int, int],
                       input_hw: Tuple[int, int]) -> torch.Tensor:
    """The same un-mapping for (..., 2) (x, y) points."""
    scale, pad_x, pad_y = _unletterbox_geometry(frame_hw, input_hw)
    pad = torch.tensor([pad_x, pad_y], dtype=points.dtype,
                       device=points.device)
    return (points - pad) / scale


def clip_boxes(boxes: torch.Tensor, frame_hw: Tuple[int, int]
               ) -> torch.Tensor:
    """Clip to [0, dim-1] as the reference does (src/retinaface.cpp:190-193)."""
    fh, fw = frame_hw
    lim = torch.tensor([fw - 1, fh - 1, fw - 1, fh - 1], dtype=boxes.dtype,
                       device=boxes.device)
    return torch.minimum(torch.clamp_min(boxes, 0.0), lim)


def iou_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N) IoU, +1 area convention."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    xx1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    yy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    xx2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    yy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    w = torch.clamp_min(xx2 - xx1 + 1.0, 0.0)
    h = torch.clamp_min(yy2 - yy1 + 1.0, 0.0)
    inter = w * h
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the reference's +1 area convention."""
    return iou_pairs(boxes, boxes)


def _greedy_keep(valid: torch.Tensor, suppresses) -> torch.Tensor:
    """Greedy NMS's keep vector as the fixed point described in the module
    docstring. ``valid`` (..., K) bool in score order; ``suppresses(keep)``
    gives (..., K): whether some earlier kept candidate overlaps each one
    at the threshold. Checks for the fixed point every 4 steps (one host
    sync each); extra steps past it change nothing."""
    keep = valid
    steps = valid.shape[-1] + 1      # enough to fix every entry
    while steps > 0:
        prev = keep
        for _ in range(min(4, steps)):
            keep = valid & ~suppresses(keep)
        steps -= 4
        if torch.equal(keep, prev):
            break
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        top_k: int = 128):
    """Greedy NMS over the ``top_k`` best candidates of (..., A) scores.

    A candidate suppresses every lower-scored survivor with IoU >=
    threshold (``src/retinaface.cpp:248-271``); -inf scores are padding.
    Returns (boxes, scores, keep, candidate_idx), each over the min(top_k,
    A) slots in descending score order."""
    k = min(top_k, scores.shape[-1])
    top_scores, idx = _top_k(scores, k)
    top_boxes = _gather_rows(boxes, idx)
    over = iou_pairs(top_boxes, top_boxes) >= iou_threshold
    earlier = torch.ones(k, k, dtype=torch.bool,
                         device=scores.device).triu(1)    # [i, j]: i < j
    over = over & earlier
    valid = top_scores > NEG_INF

    def suppresses(keep):
        return (over & keep[..., :, None]).any(dim=-2)

    return top_boxes, top_scores, _greedy_keep(valid, suppresses), idx


def nms_streaming(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float, chunk: int = 256):
    """Exact greedy NMS over all candidates of one frame, without an A x A
    IoU matrix: each step of the fixed point walks the live candidates in
    blocks of ``chunk`` columns, so the working set is (live, chunk).

    ``boxes`` (A, 4), ``scores`` (A,). Returns (sorted_boxes,
    sorted_scores, keep, order), padded to a multiple of ``chunk`` in
    descending score order; padding slots have score -inf, keep False and
    ``order`` clamped into range, as facekit's ``nms_streaming``."""
    a = scores.shape[0]
    a_pad = -(-a // chunk) * chunk
    scores = torch.cat([scores, scores.new_full((a_pad - a,), NEG_INF)])
    boxes = torch.cat([boxes, boxes.new_zeros((a_pad - a, 4))])
    sorted_scores, order = _top_k(scores, a_pad)
    order = torch.clamp_max(order, a - 1)
    sorted_boxes = boxes[order]
    valid = sorted_scores > NEG_INF
    n_live = int(valid.sum())       # the valid ones lead the sorted order
    keep = valid.clone()
    if n_live:
        live = sorted_boxes[:n_live]
        pos = torch.arange(n_live, device=scores.device)

        def suppresses(k_live):
            out = torch.zeros_like(k_live)
            for c0 in range(0, n_live, chunk):
                c1 = min(c0 + chunk, n_live)
                rows = live[:c1]          # only earlier rows can suppress
                over = iou_pairs(rows, live[c0:c1]) >= iou_threshold
                over &= pos[:c1, None] < pos[None, c0:c1]
                out[c0:c1] = (over & k_live[:c1, None]).any(dim=0)
            return out

        keep[:n_live] = _greedy_keep(valid[:n_live], suppresses)
    return sorted_boxes, sorted_scores, keep, order


def _nms_select_streaming(boxes, masked, iou_threshold: float,
                          max_faces: int, chunk: int = 256):
    """All-candidate exact NMS reduced to the final ``max_faces`` slots."""
    sorted_boxes, sorted_scores, keep, order = nms_streaming(
        boxes, masked, iou_threshold, chunk)
    kept = torch.where(keep, sorted_scores, NEG_INF)
    final_scores, sel = _top_k(kept, max_faces)
    return sorted_boxes[sel], final_scores, order[sel]


def _decode_all(loc, conf, anchors, frame_hw, input_hw, score_threshold,
                ldm=None):
    """Threshold + decode + unletterbox + clip over (..., A) outputs."""
    face_scores = conf[..., 1]
    masked = torch.where(face_scores > score_threshold, face_scores,
                         NEG_INF)
    boxes = clip_boxes(unletterbox_boxes(decode_boxes(loc, anchors, input_hw),
                                         frame_hw, input_hw), frame_hw)
    points = None
    if ldm is not None:
        points = unletterbox_points(decode_landmarks(ldm, anchors, input_hw),
                                    frame_hw, input_hw)
    return masked, boxes, points


def _nms_select(boxes, masked, iou_threshold: float, top_k: int,
                max_faces: int):
    """NMS over the ``top_k`` best candidates, reduced to ``max_faces``
    slots. Returns (boxes (..., F, 4), scores (..., F), anchor_idx
    (..., F), survivors in the window (...,))."""
    top_boxes, top_scores, keep, cand_idx = nms(boxes, masked, iou_threshold,
                                                top_k)
    kept = torch.where(keep, top_scores, NEG_INF)
    final_scores, sel = _top_k(kept, max_faces)
    return (_gather_rows(top_boxes, sel), final_scores,
            torch.gather(cand_idx, -1, sel), (kept > NEG_INF).sum(-1))


def select_faces_batch(loc: torch.Tensor, conf: torch.Tensor,
                       anchors: torch.Tensor, frame_hw: Tuple[int, int],
                       input_hw: Tuple[int, int], max_faces: int = 4,
                       score_threshold: float = 0.6,
                       iou_threshold: float = 0.4, nms_top_k: int = 128,
                       nms_exact: bool = True,
                       ldm: Optional[torch.Tensor] = None) -> Detections:
    """Threshold -> decode -> unletterbox -> clip -> NMS over (N, A, ...)
    detector outputs (``facekit/ops/boxes.py:331-383``).

    The fast path runs NMS over each frame's ``nms_top_k`` best
    candidates. Under greedy NMS a lower-scored candidate never suppresses
    a higher one, so survivors inside that window are exact; the window
    can only be wrong when more than ``nms_top_k`` candidates clear the
    threshold and fewer than ``max_faces`` of the window's survive. With
    ``nms_exact`` the frames where that happens take NMS over all their
    candidates (``nms_streaming``); the others keep the fast result.

    The stage syncs with the host (the fixed point's test, the live count,
    the fallback's frames), which no tracer follows, so under
    ``torch.export`` it is one opaque op, ``facekit_torch::select_faces``,
    with every argument but the tensors frozen into the graph; the op runs
    this same function."""
    if torch.compiler.is_exporting():
        boxes, scores, valid, points = torch.ops.facekit_torch.select_faces(
            loc, conf, anchors, ldm, list(frame_hw), list(input_hw),
            max_faces, float(score_threshold), float(iou_threshold),
            nms_top_k, bool(nms_exact))
        return Detections(boxes, scores, valid,
                          points if ldm is not None else None)
    return _select_faces_eager(loc, conf, anchors, frame_hw, input_hw,
                               max_faces, score_threshold, iou_threshold,
                               nms_top_k, nms_exact, ldm)


def _select_faces_eager(loc, conf, anchors, frame_hw, input_hw, max_faces,
                        score_threshold, iou_threshold, nms_top_k, nms_exact,
                        ldm) -> Detections:
    masked, boxes, points = _decode_all(loc, conf, anchors, frame_hw,
                                        input_hw, score_threshold, ldm)
    fb, fs, fi, n_surv = _nms_select(boxes, masked, iou_threshold, nms_top_k,
                                     max_faces)
    if nms_exact and masked.shape[-1] > nms_top_k:
        n_above = (masked > NEG_INF).sum(-1)
        need = (n_above > nms_top_k) & (n_surv < max_faces)
        for i in torch.nonzero(need).flatten().tolist():
            fb[i], fs[i], fi[i] = _nms_select_streaming(
                boxes[i], masked[i], iou_threshold, max_faces)
    valid = fs > NEG_INF
    landmarks = _gather_rows(points, fi) if points is not None else None
    fs = torch.where(valid, fs, 0.0)
    return Detections(boxes=fb, scores=fs, valid=valid, landmarks=landmarks)


@torch.library.custom_op("facekit_torch::select_faces", mutates_args=())
def _select_faces_op(loc: torch.Tensor, conf: torch.Tensor,
                     anchors: torch.Tensor, ldm: Optional[torch.Tensor],
                     frame_hw: List[int], input_hw: List[int],
                     max_faces: int, score_threshold: float,
                     iou_threshold: float, nms_top_k: int, nms_exact: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """``select_faces_batch`` as a registered op, on every device. An op
    returns no None, so without ``ldm`` the landmarks are zeros."""
    det = _select_faces_eager(loc, conf, anchors, tuple(frame_hw),
                              tuple(input_hw), max_faces, score_threshold,
                              iou_threshold, nms_top_k, nms_exact, ldm)
    points = det.landmarks
    if points is None:
        points = det.boxes.new_zeros((*det.boxes.shape[:-1], 5, 2))
    return det.boxes, det.scores, det.valid, points


@_select_faces_op.register_fake
def _(loc, conf, anchors, ldm, frame_hw, input_hw, max_faces,
      score_threshold, iou_threshold, nms_top_k, nms_exact):
    n, a = conf.shape[:2]
    f = min(max_faces, nms_top_k, a)
    dtype = torch.promote_types(loc.dtype, anchors.dtype)
    return (loc.new_empty((n, f, 4), dtype=dtype),
            conf.new_empty((n, f)),
            conf.new_empty((n, f), dtype=torch.bool),
            loc.new_empty((n, f, 5, 2), dtype=dtype))


def select_faces(loc: torch.Tensor, conf: torch.Tensor,
                 anchors: torch.Tensor, frame_hw: Tuple[int, int],
                 input_hw: Tuple[int, int], max_faces: int = 4,
                 score_threshold: float = 0.6, iou_threshold: float = 0.4,
                 nms_top_k: int = 128, nms_exact: bool = True,
                 ldm: Optional[torch.Tensor] = None) -> Detections:
    """``select_faces_batch`` of one frame's (A, ...) outputs
    (``facekit/ops/boxes.py:277-324``)."""
    det = select_faces_batch(
        loc[None], conf[None], anchors, frame_hw, input_hw,
        max_faces=max_faces, score_threshold=score_threshold,
        iou_threshold=iou_threshold, nms_top_k=nms_top_k,
        nms_exact=nms_exact, ldm=None if ldm is None else ldm[None])
    return Detections(*(None if t is None else t[0] for t in det))
