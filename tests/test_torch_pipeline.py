"""facekit_torch's FacePipeline (embed + match) against facekit's."""

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
from facekit_torch.weights import random_arcface_params

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
