"""facekit_torch's FacePipeline against facekit's: embed + match on crops,
and detect -> align -> embed -> match on frames (``recognize_and_match``,
the WS /inference batch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.models import retinaface_init
from facekit.ops.resize import resize_image as jax_resize_image
from facekit.pipeline import FacePipeline as JaxPipeline
from facekit_torch.config import FaceKitConfig
from facekit_torch.ops.resize import resize_image
from facekit_torch.pipeline import FacePipeline
from facekit_torch.pipeline.recognize import _own_frames
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params)

_CFG = dict(rec_network="ir_tiny", compute_dtype="float32",
            gallery_dtype="float32")


@pytest.fixture(scope="module")
def pipelines():
    import jax
    params = random_arcface_params("ir_tiny", seed=4)
    ref = JaxPipeline(JaxConfig(**_CFG),
                      retinaface_init(jax.random.PRNGKey(0)), params)
    return FacePipeline(FaceKitConfig(**_CFG), params, device="cpu"), ref


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("hw", [(100, 90), (56, 28)])
def test_resize_image_matches(rng, hw):
    img = rng.integers(0, 256, (*hw, 3)).astype(np.float32)
    ours = resize_image(torch.tensor(img), (112, 112))
    ref = jax_resize_image(jnp.asarray(img), (112, 112), "linear")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)
    ours = resize_image(torch.tensor(img), (112, 112), saturate=True).numpy()
    ref = np.asarray(jax_resize_image(jnp.asarray(img), (112, 112), "linear",
                                      saturate=True))
    if hw == (56, 28):
        # power-of-two ratios: every weight and sum is exact in f32
        np.testing.assert_array_equal(ours, ref)
    else:
        # sums in another order can round a .5 the other way: 1 LSB, rarely
        assert np.abs(ours - ref).max() <= 1
        assert (ours != ref).mean() < 1e-3


# (56, 28) resizes exactly (see above), so facekit and the port embed the
# same pixels
@pytest.mark.parametrize("hw", [(112, 112), (56, 28)])
def test_embed_cropped_matches(pipelines, rng, hw):
    ours, ref = pipelines
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    e = ours.embed_cropped(img)
    assert e.shape == (512,) and e.dtype == np.float32
    np.testing.assert_allclose(e, ref.embed_cropped(img), rtol=0, atol=1e-5)


def test_embed_and_match_at_bucket_padding(pipelines, rng):
    """Three crops padded to a batch of 8 with zero crops, as the server's
    micro-batcher pads them, against a capacity-bucketed gallery."""
    ours, ref = pipelines
    crops = rng.integers(0, 256, (3, 112, 112, 3), dtype=np.uint8)
    padded = np.concatenate([crops, np.zeros((5, 112, 112, 3), np.uint8)])
    gallery = rng.normal(size=(64, 512)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    gallery[7] = ours.embed_cropped_batch(crops[1:2])[0]
    emb, vals, idx = ours.embed_and_match(padded, torch.tensor(gallery), 40,
                                          k=3)
    r_emb, r_vals, r_idx = ref.embed_and_match(padded, jnp.asarray(gallery),
                                               40, k=3)
    np.testing.assert_allclose(emb.numpy(), np.asarray(r_emb), atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), atol=1e-5)
    assert idx[1, 0] == 7 and vals[1, 0] > 0.999
    np.testing.assert_allclose(ours.embed_cropped_batch(padded), emb.numpy(),
                               atol=1e-6)


def test_match_flat_keeps_leading_dims(pipelines, rng):
    ours, _ = pipelines
    gallery = torch.tensor(rng.normal(size=(16, 512)).astype(np.float32))
    vals, idx = ours.match_flat(gallery[:6].reshape(2, 3, 512), gallery, 16,
                                k=2)
    assert vals.shape == idx.shape == (2, 3, 2)


def test_own_frames_copies_caller_buffers(rng):
    frame = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
    t = _own_frames(frame, torch.device("cpu"))
    frame[:] = 0
    assert t.sum() > 0


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        FacePipeline(FaceKitConfig(**_CFG), random_arcface_params("ir_tiny"))


# -- detect -> align -> embed -> match ------------------------------------------

def _frame_pipelines(align=True, dtype="float32"):
    """The port's and facekit's pipelines on one config and one numpy-drawn
    tree per model. Random detector weights score every anchor near 0.55,
    so a threshold of 0.5 finds 4 faces in any frame."""
    cfg = dict(_CFG, compute_dtype=dtype, det_threshold_bbox=0.5,
               extras={"rec_useAlignment": align})
    rp = random_arcface_params("ir_tiny", seed=4)
    dp = random_retinaface_params(seed=0)
    return (FacePipeline(FaceKitConfig(**cfg), rp, dp, device="cpu"),
            JaxPipeline(JaxConfig(**cfg), dp, rp))


@pytest.fixture(scope="module")
def frame_pipelines():
    return _frame_pipelines()


def _frames(seed, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, 480, 640, 3),
                                                dtype=np.uint8)


def _unit_gallery(seed, rows=16):
    g = np.random.default_rng(seed).normal(size=(rows, 512))
    return (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("align", [True, False])
def test_recognize_and_match_matches(align):
    """f32, ir_tiny, one numpy-drawn tree per model on both sides: valid
    masks and gallery indices equal; boxes, landmarks and similarities
    close; embeddings within 1e-4; crops within 1e-4 of the 0..255 scale
    (aligned) or within one LSB (cubic crop, saturated)."""
    ours, ref = _frame_pipelines(align)
    assert ours.align == ref.align == align and ours.use_landmarks
    frames = _frames(1)
    g = _unit_gallery(2)
    # two gallery rows are faces of these frames, so matches are real
    g[3] = ours.recognize_frames(frames).embeddings[0, 1].numpy()
    g[9] = ours.recognize_frames(frames).embeddings[1, 0].numpy()
    res, vals, idx = ours.recognize_and_match(frames, torch.tensor(g), 12,
                                              k=2, return_crops=True)
    r_res, r_vals, r_idx = ref.recognize_and_match(
        frames, jnp.asarray(g), 12, k=2, return_crops=True)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(r_res.valid))
    assert res.valid.all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    assert idx[0, 1, 0] == 3 and idx[1, 0, 0] == 9
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), atol=1e-5)
    np.testing.assert_allclose(res.boxes.numpy(), np.asarray(r_res.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(r_res.scores),
                               atol=1e-6)
    np.testing.assert_allclose(res.landmarks.numpy(),
                               np.asarray(r_res.landmarks), atol=1e-3)
    np.testing.assert_allclose(res.embeddings.numpy(),
                               np.asarray(r_res.embeddings), atol=1e-4)
    crops, r_crops = res.crops.numpy(), np.asarray(r_res.crops)
    assert crops.shape == (2, 4, 112, 112, 3)
    np.testing.assert_allclose(crops, r_crops, atol=255e-4 if align else 1)


def test_recognize_frame_and_detect_frames_match(frame_pipelines):
    """The single-frame path (``/insert/face`` uncropped) equals facekit's
    ``_recognize_frame``, and detection alone equals ``_detect_frames``."""
    ours, ref = frame_pipelines
    frames = _frames(3)
    one = ours.recognize_frame(frames[0], return_crops=True)
    r_one = ref.recognize_frame(frames[0], return_crops=True)
    assert one.embeddings.shape == (4, 512) and one.crops.shape[0] == 4
    np.testing.assert_array_equal(one.valid.numpy(), np.asarray(r_one.valid))
    np.testing.assert_allclose(one.embeddings.numpy(),
                               np.asarray(r_one.embeddings), atol=1e-4)
    det = ours.detect_frames(frames)
    r_det = ref.detect_frames(frames)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(r_det.valid))
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(r_det.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(det.landmarks.numpy(),
                               np.asarray(r_det.landmarks), atol=1e-3)
    np.testing.assert_array_equal(det.boxes[0].numpy(), one.boxes.numpy())


def test_recognize_and_match_bf16_within_cosine_bar(frame_pipelines):
    """The port in bf16 (detector, warp passes and embedder) against
    facekit in f32 on the same frames: the same number of faces, and each
    slot that holds the same face (landmarks within 1 px) within facekit's
    1e-3 cosine bar. Random detector weights score thousands of anchors
    within a few bf16 steps of 0.5, so bf16 rounding can reorder near-tied
    candidates and put another face in a later slot; the leading slots
    must still agree."""
    _, ref = frame_pipelines
    ours, _ = _frame_pipelines(dtype="bfloat16")
    frames = _frames(5)
    g = _unit_gallery(6)
    res, _, _ = ours.recognize_and_match(frames, torch.tensor(g), 16)
    r_res, _, _ = ref.recognize_and_match(frames, jnp.asarray(g), 16)
    assert res.embeddings.dtype == torch.float32
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(r_res.valid))
    same = np.abs(res.landmarks.numpy()
                  - np.asarray(r_res.landmarks)).max((-1, -2)) < 1.0
    assert same[:, 0].all() and same.mean() >= 0.5
    cos = (res.embeddings.numpy() * np.asarray(r_res.embeddings)).sum(-1)
    assert (1 - cos[same]).max() < 1e-3


def test_pipeline_without_detector_refuses_frames():
    ours = FacePipeline(FaceKitConfig(**_CFG), random_arcface_params(
        "ir_tiny", seed=4), device="cpu")
    assert not ours.use_landmarks and not ours.align
    with pytest.raises(ValueError, match="no detector"):
        ours.detect_frames(_frames(0, 1))
