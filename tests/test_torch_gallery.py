"""facekit_torch's GalleryStore against facekit's, step for step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.gallery import GalleryStore as JaxStore
from facekit_torch.gallery import GalleryStore

BUCKETS = (16, 64, 256)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _unit(rng, n):
    x = rng.normal(size=(n, 512)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_sequence_same_results(rng, dtype):
    """load, snapshot, add across a bucket boundary, search: both stores
    give the same capacities, names and search results."""
    ours = GalleryStore(buckets=BUCKETS, dtype=dtype, device="cpu")
    ref = JaxStore(buckets=BUCKETS, dtype=dtype, use_pallas=False)
    emb = _unit(rng, 80)
    names = [f"u{i}" for i in range(80)]
    for s in (ours, ref):
        s.load(names[:20], emb[:20])
    assert ours.capacity == ref.capacity == 64
    snap = ours.snapshot()
    before = snap.arr[:20].clone()
    for i in range(20, 70):
        ours.add(names[i], emb[i])
        ref.add(names[i], emb[i])
        assert (ours.count, ours.capacity) == (ref.count, ref.capacity)
    assert ours.capacity == 256 and ours.count == 70
    # the snapshot taken before the adds still sees its own rows and names
    assert snap.count == 20 and snap.names == names[:20]
    assert torch.equal(snap.arr[:20], before)
    q = np.concatenate([emb[[3, 45, 69]], _unit(rng, 2)])
    for k in (1, 3):
        v, i, n = ours.search(q, k=k)
        rv, ri, rn = ref.search(jnp.asarray(q), k=k)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-5)
        assert n == rn == names[:70]
    assert [n[j] for j in i[:3, 0]] == ["u3", "u45", "u69"]


def test_add_in_place_within_capacity(rng):
    store = GalleryStore(buckets=BUCKETS, dtype="float32", device="cpu")
    emb = _unit(rng, 3)
    store.load(["a", "b"], emb[:2])
    arr = store.snapshot().arr
    store.add("c", emb[2])
    assert store.snapshot().arr is arr                  # no rebuild
    np.testing.assert_array_equal(arr[2].numpy(), emb[2])


def test_device_tensor_is_a_copy_of_the_host_mirror(rng):
    store = GalleryStore(buckets=BUCKETS, dtype="float32", device="cpu")
    emb = _unit(rng, 2)
    store.load(["a", "b"], emb)
    arr = store.snapshot().arr
    assert arr.data_ptr() != store._host_buf.ctypes.data
    store._host_buf[:] = 7.0
    np.testing.assert_array_equal(arr[:2].numpy(), emb)


def test_empty_search_and_int8_refusal(rng):
    """An empty gallery refuses a search with the reference's message, for
    every dtype; a dtype the store does not have is refused at
    construction (int8 is served since the int8 slice)."""
    for dtype in ("bfloat16", "int8"):
        store = GalleryStore(dtype=dtype, device="cpu")
        with pytest.raises(ValueError, match="Feature matching: No faces in "
                                             "database"):
            store.search(_unit(rng, 1))
    with pytest.raises(ValueError, match="gallery_dtype 'float16'"):
        GalleryStore(dtype="float16", device="cpu")


def test_int8_store_matches_facekit(rng):
    """int8 rows and per-row scales equal facekit's (use_pallas=False), and
    so do the search results, bit for bit: after load, after adds within
    the capacity (in place), and after an add across a bucket."""
    ours = GalleryStore(buckets=BUCKETS, dtype="int8", device="cpu")
    ref = JaxStore(buckets=BUCKETS, dtype="int8", use_pallas=False)
    emb = _unit(rng, 80)
    names = [f"u{i}" for i in range(80)]
    q = np.concatenate([emb[[3, 17, 40, 64]], _unit(rng, 3)])

    def same():
        snap, rsnap = ours.snapshot(), ref.snapshot()
        assert snap.arr.dtype == torch.int8 and snap.scales.dtype == \
            torch.float32
        np.testing.assert_array_equal(snap.arr.numpy(), np.asarray(rsnap.arr))
        np.testing.assert_array_equal(snap.scales.numpy(),
                                      np.asarray(rsnap.scales))
        for k in (1, 4):
            v, i, n = ours.search(q, k=k)
            rv, ri, rn = ref.search(jnp.asarray(q), k=k)
            np.testing.assert_array_equal(i, ri)
            np.testing.assert_array_equal(v, rv)
            assert n == rn

    for s in (ours, ref):
        s.load(names[:20], emb[:20])
    same()
    arr = ours.snapshot().arr
    for i in range(20, 64):
        ours.add(names[i], emb[i])
        ref.add(names[i], emb[i])
    assert ours.snapshot().arr is arr and ours.capacity == 64   # in place
    same()
    ours.add(names[64], emb[64])
    ref.add(names[64], emb[64])
    assert ours.capacity == ref.capacity == 256
    same()
    v, i, _ = ours.search(q[:4])
    np.testing.assert_array_equal(i[:, 0], [3, 17, 40, 64])
    assert (v[:, 0] > 0.99).all()


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        GalleryStore()
