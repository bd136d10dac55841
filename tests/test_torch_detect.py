"""facekit_torch's detect modules against facekit's, on the same inputs.

Resize (cubic matrices, letterbox, crop_resize), anchors, RetinaFace,
box decode + NMS (``select_faces_batch``, ``nms_streaming``) and 5-point
alignment (``umeyama``, ``warp_align_frames``). Inputs and parameters are
drawn with numpy from a local seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.models import layers as JL
from facekit.models.retinaface import retinaface_apply, retinaface_init
from facekit.ops import align as JA
from facekit.ops import anchors as JN
from facekit.ops import boxes as JB
from facekit.ops import resize as JR
from facekit_torch.models import RetinaFace
from facekit_torch.models import layers as TL
from facekit_torch.ops import align as TA
from facekit_torch.ops import anchors as TN
from facekit_torch.ops import boxes as TB
from facekit_torch.ops import resize as TR
from facekit_torch.weights import from_jax, random_retinaface_params

FRAME_HW, DET_HW = (480, 640), (288, 320)
# Pixel results on the 0..255 scale agree within 1e-4 of full scale: XLA
# contracts the cubic polynomial and the sampling positions into FMAs, so
# an interpolation weight can differ from the port's in its last f32 bit,
# and a pixel moves by that bit times the image's local gradient.
PIXEL_ATOL = 255 * 1e-4


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- resize ---------------------------------------------------------------------

@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("sizes", [(480, 240), (300, 192), (60, 112),
                                   (17, 160)])
def test_resize_matrix_equal(method, sizes):
    np.testing.assert_array_equal(
        TR.resize_matrix(*sizes, method).numpy(),
        np.asarray(JR.resize_matrix(*sizes, method)))


@pytest.mark.parametrize("frame_hw", [(480, 640), (300, 500), (640, 480),
                                      (288, 320)])
def test_letterbox_matches(frame_hw):
    """Geometry equal; f32 within 1e-4 unsaturated; saturated within one
    LSB (a sum taken in another order can round a .5 the other way)."""
    assert TR.letterbox_geometry(frame_hw, DET_HW) == \
        JR.letterbox_geometry(frame_hw, DET_HW)
    rng = np.random.default_rng(sum(frame_hw))
    img = rng.integers(0, 256, (2, *frame_hw, 3)).astype(np.float32)
    ours = TR.letterbox(torch.tensor(img), DET_HW, saturate=False).numpy()
    ref = np.asarray(JR.letterbox(jnp.asarray(img), DET_HW, saturate=False))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    ours = TR.letterbox(torch.tensor(img[0]), DET_HW).numpy()
    ref = np.asarray(JR.letterbox(jnp.asarray(img[0]), DET_HW))
    assert ours.shape == (*DET_HW, 3)
    assert np.abs(ours - ref).max() <= 1 and (ours != ref).mean() < 1e-3


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_crop_resize_matches(method):
    """Boxes inside, across and outside the frame, and degenerate ones
    (x1 == x2): f32 within ``PIXEL_ATOL`` unsaturated, and within one LSB
    saturated; batched frames equal the per-frame calls."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 90, 120, 3)).astype(np.float32)
    boxes = np.array([[[10.3, 5.7, 60.2, 70.9], [-5, -8, 30, 40],
                       [100, 60, 140, 110], [40, 40, 40.5, 41]],
                      [[0, 0, 119, 89], [33.9, 12.1, 34.2, 80],
                       [80.5, 2.2, 118.8, 30.1], [5, 70, 50, 89]]],
                     np.float32)
    for f, b in zip(frames, boxes):
        ref = np.asarray(JR.crop_resize(jnp.asarray(f), jnp.asarray(b),
                                        (112, 112), method, saturate=False))
        ours = TR.crop_resize(torch.tensor(f), torch.tensor(b), (112, 112),
                              method, saturate=False).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=PIXEL_ATOL)
        ref = np.asarray(JR.crop_resize(jnp.asarray(f), jnp.asarray(b),
                                        (112, 112), method))
        ours = TR.crop_resize(torch.tensor(f), torch.tensor(b), (112, 112),
                              method).numpy()
        assert np.abs(ours - ref).max() <= 1 and (ours != ref).mean() < 1e-3
    both = TR.crop_resize(torch.tensor(frames), torch.tensor(boxes),
                          (112, 112), method)
    np.testing.assert_array_equal(
        both[1].numpy(), TR.crop_resize(torch.tensor(frames[1]),
                                        torch.tensor(boxes[1]), (112, 112),
                                        method).numpy())


# -- anchors --------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(288, 320), (640, 640), (97, 131)])
def test_anchors_equal(hw):
    ours = TN.generate_anchors(hw).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JN.generate_anchors(hw)))
    assert TN.num_anchors(hw) == JN.num_anchors(hw) == ours.shape[0]
    if hw == (288, 320):
        assert ours.shape == (3780, 4)


# -- RetinaFace -----------------------------------------------------------------

@pytest.mark.parametrize("out_hw", [(18, 20), (36, 40), (9, 10)])
def test_layer_helpers_match(out_hw):
    """``nearest_resize_to`` (the FPN's upsample, and a downsample) and
    ``leaky_relu`` equal facekit's."""
    x = np.random.default_rng(sum(out_hw)).normal(size=(2, 9, 10, 3)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        TL.nearest_resize_to(torch.tensor(x), out_hw).numpy(),
        np.asarray(JL.nearest_resize_to(jnp.asarray(x), out_hw)))
    np.testing.assert_array_equal(
        TL.leaky_relu(torch.tensor(x), 0.1).numpy(),
        np.asarray(JL.leaky_relu(jnp.asarray(x), 0.1)))


def _detector(seed=0, with_landmarks=True):
    params = random_retinaface_params(seed=seed,
                                      with_landmarks=with_landmarks)
    net = RetinaFace(with_landmarks=with_landmarks)
    net.load_state_dict(from_jax(params, net))
    return params, net.eval()


@pytest.mark.parametrize("with_landmarks", [True, False])
def test_retinaface_f32_matches(with_landmarks):
    params, net = _detector(1, with_landmarks)
    x = np.random.default_rng(2).uniform(-120, 130, (2, *DET_HW, 3)) \
        .astype(np.float32)
    ref = retinaface_apply(params, jnp.asarray(x))
    with torch.inference_mode():
        loc, conf, ldm = net(torch.tensor(x))
    assert loc.shape == (2, 3780, 4) and conf.shape == (2, 3780, 2)
    assert loc.dtype == conf.dtype == torch.float32
    np.testing.assert_allclose(loc.numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref[1]), atol=1e-5)
    if with_landmarks:
        assert ldm.shape == (2, 3780, 10)
        np.testing.assert_allclose(ldm.numpy(), np.asarray(ref[2]),
                                   atol=1e-5)
    else:
        assert ldm is None and len(ref) == 2


def test_retinaface_bf16_close():
    """bf16 compute on both sides: each conv rounds its output to bf16 once
    from f32 sums taken in another order, so outputs sit within a few bf16
    steps of each other (loc/ldm magnitudes ~0.2: 1e-2; softmax in f32:
    2e-3)."""
    params, net = _detector(1)
    x = np.random.default_rng(3).uniform(-120, 130, (1, *DET_HW, 3)) \
        .astype(np.float32)
    ref = retinaface_apply(params, jnp.asarray(x), dtype=jnp.bfloat16)
    net.set_compute_dtype(torch.bfloat16)
    assert net.stem.conv.dtype == torch.bfloat16
    assert net.class_head[0].b.dtype == torch.float32
    with torch.inference_mode():
        loc, conf, ldm = net(torch.tensor(x))
    np.testing.assert_allclose(loc.numpy(), np.asarray(ref[0]), atol=1e-2)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref[1]), atol=2e-3)
    np.testing.assert_allclose(ldm.numpy(), np.asarray(ref[2]), atol=1e-2)


def test_from_jax_takes_retinaface_init():
    """facekit's own detector tree (jax arrays, lists) fits the module's
    parameter names, with and without the landmark head."""
    for with_landmarks in (True, False):
        tree = retinaface_init(jax.random.PRNGKey(0),
                               with_landmarks=with_landmarks)
        net = RetinaFace(with_landmarks=with_landmarks)
        state = from_jax(tree, net)
        assert state.keys() == net.state_dict().keys()
        np.testing.assert_array_equal(
            state["stage1.0.dw_conv"].numpy(),
            np.asarray(tree["stage1"][0]["dw_conv"]).transpose(3, 2, 0, 1))


# -- decode + NMS ---------------------------------------------------------------

def _detections_equal(ours, ref, atol=1e-3):
    """valid and slot order equal, boxes/landmarks to float tolerance."""
    np.testing.assert_array_equal(_np(ours.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(_np(ours.scores), np.asarray(ref.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ours.boxes), np.asarray(ref.boxes),
                               rtol=0, atol=atol)
    if ref.landmarks is None:
        assert ours.landmarks is None
    else:
        np.testing.assert_allclose(_np(ours.landmarks),
                                   np.asarray(ref.landmarks), rtol=0,
                                   atol=atol)


def _select(loc, conf, anchors, frame_hw, input_hw, ldm=None, **kw):
    ref = JB.select_faces_batch(
        jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(anchors), frame_hw,
        input_hw, ldm=None if ldm is None else jnp.asarray(ldm), **kw)
    ours = TB.select_faces_batch(
        _t(loc), _t(conf), _t(anchors), frame_hw, input_hw,
        ldm=None if ldm is None else _t(ldm), **kw)
    return ours, ref


@pytest.fixture(scope="module")
def det_outputs():
    """RetinaFace outputs of three random frames (numpy)."""
    _, net = _detector(0)
    x = np.random.default_rng(4).uniform(-120, 130, (3, *DET_HW, 3)) \
        .astype(np.float32)
    with torch.inference_mode():
        return tuple(t.numpy() for t in net(torch.tensor(x)))


@pytest.mark.parametrize("thr,max_faces", [(0.5, 4), (0.52, 8), (0.99, 4)])
def test_select_faces_batch_on_detector_outputs(det_outputs, thr, max_faces):
    """Random detector outputs over many candidates (0.5), few (0.52) and
    none (0.99: every frame all-invalid, scores 0)."""
    loc, conf, ldm = det_outputs
    anchors = TN.generate_anchors(DET_HW).numpy()
    ours, ref = _select(loc, conf, anchors, FRAME_HW, DET_HW, ldm=ldm,
                        max_faces=max_faces, score_threshold=thr)
    _detections_equal(ours, ref)
    if thr == 0.99:
        assert not ours.valid.any() and (ours.scores == 0).all()
    ours, ref = _select(loc, conf, anchors, FRAME_HW, DET_HW,
                        max_faces=max_faces, score_threshold=thr)
    _detections_equal(ours, ref)


def test_select_faces_ties_take_the_lower_index(det_outputs):
    """Scores rounded to 2 decimals: many candidates tie, and ``lax.top_k``
    keeps the lower anchor first, so a stable descending sort must too."""
    loc, conf, ldm = det_outputs
    face = np.round(conf[..., 1], 2)
    conf = np.stack([1 - face, face], -1).astype(np.float32)
    anchors = TN.generate_anchors(DET_HW).numpy()
    ours, ref = _select(loc, conf, anchors, FRAME_HW, DET_HW, ldm=ldm,
                        score_threshold=0.45, max_faces=6)
    _detections_equal(ours, ref)


def _synthetic(boxes_px, scores, input_hw, total_anchors):
    """(loc, conf, anchors) whose loc = 0 decode gives ``boxes_px`` exactly
    (frame == detector input, so unletterbox is the identity)."""
    h, w = input_hw
    b = np.asarray(boxes_px, np.float32)
    anchors = np.stack([(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                        (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], -1)
    face = np.asarray(scores, np.float32)
    pad = total_anchors - len(anchors)
    anchors = np.concatenate([anchors, np.tile([[0.5, 0.5, 0.1, 0.1]],
                                               (pad, 1))]).astype(np.float32)
    face = np.concatenate([face, np.zeros(pad, np.float32)])
    conf = np.stack([1 - face, face], -1).astype(np.float32)
    return np.zeros((total_anchors, 4), np.float32), conf, anchors


def test_select_faces_dense_stack_takes_the_exact_fallback():
    """Frame 0: 200 identical boxes above 5 isolated faces beyond rank 128
    (the window keeps 1 survivor, so the fallback runs over all
    candidates); frame 1: only the isolated faces (the fast path). Equal
    to facekit, and the fallback recovers 4 faces."""
    input_hw = (288, 320)
    stack = np.tile([[100.0, 100.0, 160.0, 160.0]], (200, 1))
    isolated = np.array([[10, 10, 40, 40], [200, 10, 240, 50],
                         [10, 200, 50, 240], [250, 200, 290, 240],
                         [120, 220, 160, 260]], np.float32)
    boxes = np.concatenate([stack, isolated])
    sa = np.concatenate([np.linspace(0.99, 0.9, 200), np.linspace(0.8, 0.7, 5)])
    sb = np.concatenate([np.zeros(200), np.linspace(0.95, 0.85, 5)])
    loc, conf_a, anchors = _synthetic(boxes, sa, input_hw, 600)
    _, conf_b, _ = _synthetic(boxes, sb, input_hw, 600)
    locs, confs = np.stack([loc, loc]), np.stack([conf_a, conf_b])
    ours, ref = _select(locs, confs, anchors, input_hw, input_hw)
    _detections_equal(ours, ref)
    assert ours.valid.sum(1).tolist() == [4, 4]
    truncated = TB.select_faces_batch(_t(locs), _t(confs), _t(anchors),
                                      input_hw, input_hw, nms_exact=False)
    assert truncated.valid[0].sum() == 1          # why the fallback exists
    one = TB.select_faces(_t(loc), _t(conf_a), _t(anchors), input_hw,
                          input_hw)
    np.testing.assert_array_equal(one.boxes.numpy(), ours.boxes[0].numpy())


@pytest.mark.parametrize("chunk", [64, 256])
def test_nms_streaming_matches(chunk):
    """Random boxes, a third masked: sorted scores, keep and order equal
    facekit's chunked streaming NMS."""
    rng = np.random.default_rng(chunk)
    n = 500
    centers = rng.uniform(40, 600, size=(n, 2))
    sizes = rng.uniform(15, 150, size=(n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           1).astype(np.float32)
    scores = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    scores[rng.uniform(size=n) < 0.33] = -np.inf
    ref = JB.nms_streaming(jnp.asarray(boxes), jnp.asarray(scores), 0.4,
                           chunk=chunk)
    ours = TB.nms_streaming(_t(boxes), _t(scores), 0.4, chunk=chunk)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    ref = JB.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4, top_k=128)
    ours = TB.nms(_t(boxes), _t(scores), 0.4, top_k=128)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_iou_and_decode_match():
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 100, (6, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    np.testing.assert_allclose(TB.iou_pairs(_t(a), _t(a)).numpy(),
                               np.asarray(JB.iou_matrix(jnp.asarray(a))),
                               atol=1e-7)
    anchors = TN.generate_anchors(DET_HW).numpy()
    loc = rng.normal(size=(3780, 4)).astype(np.float32)
    ldm = rng.normal(size=(3780, 10)).astype(np.float32)
    np.testing.assert_allclose(
        TB.decode_boxes(_t(loc), _t(anchors), DET_HW).numpy(),
        np.asarray(JB.decode_boxes(jnp.asarray(loc), jnp.asarray(anchors),
                                   DET_HW)), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        TB.decode_landmarks(_t(ldm), _t(anchors), DET_HW).numpy(),
        np.asarray(JB.decode_landmarks(jnp.asarray(ldm), jnp.asarray(anchors),
                                       DET_HW)), rtol=1e-6, atol=1e-4)


# -- alignment --------------------------------------------------------------------

def _landmarks(rng, angles_deg, scale=1.6, center=(320.0, 240.0)):
    """Template faces rotated by each angle, scaled, placed near
    ``center`` with a little noise: (len(angles), 5, 2)."""
    t = JA.ARCFACE_TEMPLATE_112 - 56.0
    out = []
    for a in np.deg2rad(angles_deg):
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        out.append(t @ r.T * scale + np.asarray(center)
                   + rng.normal(scale=1.0, size=(5, 2)))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("angles", [(0, 30, 60, 100), (135, 180, -75, -30)])
def test_umeyama_matches(angles):
    """Rotations on both sides of 45 and 90 degrees, and a coincident set
    (degenerate covariance: identity rotation, unit scale, finite)."""
    rng = np.random.default_rng(len(angles) + angles[1])
    lms = _landmarks(rng, angles)
    lms[-1] = 300.0                                    # coincident points
    tmpl = JA.ARCFACE_TEMPLATE_112
    ours = TA.umeyama(_t(lms), _t(tmpl)).numpy()
    ref = np.stack([np.asarray(JA.umeyama(jnp.asarray(lm), jnp.asarray(tmpl)))
                    for lm in lms])
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours[-1, :, :2], np.eye(2), atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_align_frames_matches(dtype):
    """Two frames of four faces each: rotations past 45 degrees (the
    per-face axis swap) and a coincident landmark set. f32 passes within
    ``PIXEL_ATOL``; bf16 pass products within 2 LSB (a position an ulp
    apart can round a weight to the neighbouring bf16 value)."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    lms = np.stack([_landmarks(rng, (0, 50, 95, 170)),
                    _landmarks(rng, (-60, 20, 135, 0), scale=0.8,
                               center=(100.0, 400.0))])
    lms[1, 3] = 250.0
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(JA.warp_align_frames(jnp.asarray(frames),
                                          jnp.asarray(lms), dtype=jd))
    ours = TA.warp_align_frames(torch.tensor(frames), torch.tensor(lms),
                                dtype=td).numpy()
    assert ours.shape == (2, 4, 112, 112, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=PIXEL_ATOL if dtype == "float32" else 2.0)
    one = TA.warp_align(torch.tensor(frames[0]), torch.tensor(lms[0]),
                        dtype=td).numpy()
    np.testing.assert_array_equal(one, ours[0])
