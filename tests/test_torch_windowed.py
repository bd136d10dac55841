"""The windowed crop and alignment of facekit_torch against its full path
and against facekit's, on the CPU.

``crop_resize(origins=...)`` and ``warp_align_frames(slice_win=...)``
(``facekit/ops/resize.py:151-225``, ``facekit/ops/align.py:273-354``) cut
each face's window from the frame and shift the integer tap indices by
its origin. The result must be bit-identical to the port's full-frame
path, as facekit pins its own, both when every window fits and when one
oversized face sends the whole batch down the full path; against
facekit's windowed functions the bar is the existing pixel bar of
``tests/test_torch_detect.py``, 1e-4 of full scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.ops import align as JA
from facekit.ops import resize as JR
from facekit_torch.ops import align as TA
from facekit_torch.ops import resize as TR

PIXEL_ATOL = 255 * 1e-4      # tests/test_torch_detect.py's bar
FRAME_HW = (240, 320)
SLICE_WIN = 128


def _landmarks(rng, faces):
    """(angle in degrees, scale, (cx, cy)) per face -> (F, 5, 2): the
    template rotated, scaled, placed, with a little noise."""
    t = JA.ARCFACE_TEMPLATE_112 - 56.0
    out = []
    for deg, scale, center in faces:
        a = np.deg2rad(deg)
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        out.append(t @ r.T * scale + np.asarray(center)
                   + rng.normal(scale=0.7, size=(5, 2)))
    return np.asarray(out, np.float32)


# faces whose windows fit in SLICE_WIN: inside, at each corner (origins
# clamped to 0 and to the far edge, boxes partly off the frame), rotated
# past 45 and 90 degrees
_FITTING = [[(0, 0.6, (160, 120)), (50, 0.5, (12, 15)),
             (100, 0.55, (310, 230)), (-30, 0.4, (60, 200))],
            [(170, 0.6, (250, 40)), (-75, 0.5, (300, 5)),
             (20, 0.45, (5, 235)), (0, 0.3, (200, 150))]]
# the same with one face too large for any window: the full path
_OVERSIZED = [_FITTING[0], _FITTING[1][:3] + [(10, 1.3, (150, 120))]]


def _case(seed, faces):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    lms = np.stack([_landmarks(rng, f) for f in faces])
    return frames, lms


def _sides(lms):
    tmpl = TA._template((112, 112), "cpu")
    boxes = TA._window_box(torch.tensor(lms), tmpl, 112, 112)
    return (boxes[..., 2] - boxes[..., 0]).numpy()


@pytest.mark.parametrize("faces,fits", [(_FITTING, True),
                                        (_OVERSIZED, False)])
def test_warp_align_frames_slice_win_is_the_full_path(faces, fits):
    """Bit-identical to ``slice_win=None`` whether the batch takes the
    windowed path (every side <= S - 4) or falls back to the full one."""
    frames, lms = _case(21 if fits else 22, faces)
    assert (_sides(lms).max() <= SLICE_WIN - 4) == fits
    f, lm = torch.tensor(frames), torch.tensor(lms)
    full = TA.warp_align_frames(f, lm)
    win = TA.warp_align_frames(f, lm, slice_win=SLICE_WIN)
    assert win.shape == (2, 4, 112, 112, 3)
    assert torch.equal(win, full)


@pytest.mark.parametrize("faces,fits", [(_FITTING, True),
                                        (_OVERSIZED, False)])
def test_warp_align_frames_slice_win_matches_facekit(faces, fits):
    frames, lms = _case(23 if fits else 24, faces)
    ref = np.asarray(JA.warp_align_frames(jnp.asarray(frames),
                                          jnp.asarray(lms),
                                          slice_win=SLICE_WIN))
    ours = TA.warp_align_frames(torch.tensor(frames), torch.tensor(lms),
                                slice_win=SLICE_WIN).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PIXEL_ATOL)


def test_warp_align_frames_slice_win_takes_the_windows(monkeypatch):
    """The fitting batch does go through the windowed crop, the oversized
    one does not (a path never taken would pass the identity test)."""
    calls = []
    real = TA._window_crops

    def spy(*args):
        calls.append(args[2])
        return real(*args)
    monkeypatch.setattr(TA, "_window_crops", spy)
    for faces, want in ((_FITTING, [SLICE_WIN]), (_OVERSIZED, [])):
        calls.clear()
        frames, lms = _case(25, faces)
        TA.warp_align_frames(torch.tensor(frames), torch.tensor(lms),
                             slice_win=SLICE_WIN)
        assert calls == want
    # a window as large as the frame's shorter side is no window
    calls.clear()
    TA.warp_align_frames(torch.tensor(frames), torch.tensor(lms),
                         slice_win=FRAME_HW[0] + 1)
    assert calls == []


def _windows(frame, boxes, s):
    """Each box's S x S window of ``frame`` at the clamped origin
    floor(box) - 1, and the origins (x, y)."""
    h, w = frame.shape[:2]
    ox = np.clip(np.floor(boxes[:, 0]) - 1, 0, w - s).astype(np.int64)
    oy = np.clip(np.floor(boxes[:, 1]) - 1, 0, h - s).astype(np.int64)
    wins = np.stack([frame[y:y + s, x:x + s] for x, y in zip(ox, oy)])
    return wins, np.stack([ox, oy], 1)


_BOXES = np.array([[10.3, 5.7, 60.2, 70.9], [-5, -8, 30, 40],
                   [100, 60, 140, 110], [40, 40, 40.5, 41],
                   [150.2, 200.7, 190.9, 239.0]], np.float32)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_crop_resize_origins(method):
    """One window per box, boxes in full-frame coordinates: bit-identical
    to cropping from the whole frame, single and batched; within the
    pixel bar of facekit's ``origins=`` crop."""
    rng = np.random.default_rng(26)
    frame = rng.integers(0, 256, (*FRAME_HW, 3)).astype(np.float32)
    wins, origins = _windows(frame, _BOXES, 96)
    full = TR.crop_resize(torch.tensor(frame), torch.tensor(_BOXES),
                          (112, 112), method, saturate=False)
    ours = TR.crop_resize(torch.tensor(wins), torch.tensor(_BOXES),
                          (112, 112), method, saturate=False,
                          origins=torch.tensor(origins))
    assert torch.equal(ours, full)
    batched = TR.crop_resize(torch.tensor(wins)[None],
                             torch.tensor(_BOXES)[None], (112, 112), method,
                             saturate=False,
                             origins=torch.tensor(origins)[None])
    assert torch.equal(batched[0], ours)
    ref = np.asarray(JR.crop_resize(jnp.asarray(wins), jnp.asarray(_BOXES),
                                    (112, 112), method, saturate=False,
                                    origins=jnp.asarray(origins)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=PIXEL_ATOL)
