"""facekit_torch.parallel against facekit.parallel on conftest's 8-device
CPU mesh: the row-sharded search (float and int8, with and without a
query axis), the mesh-backed GalleryStore, the pipeline's mesh path, and
make_mesh's refusals.

facekit's mesh is 8 virtual XLA CPU devices; the port's puts torch's one
CPU device at all 8 positions (``make_mesh(axes, devices=["cpu"] * 8)``),
which is how one process drives a mesh on CPU tensors: each block of the
gallery is its own tensor, searched by the plain version of the kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.gallery import GalleryStore as JaxStore
from facekit.ops.similarity import quantize_rows_int8 as jax_quantize
from facekit.parallel import make_mesh as jax_make_mesh
from facekit.parallel import shard_gallery as jax_shard_gallery
from facekit.parallel import shard_rows as jax_shard_rows
from facekit.parallel import sharded_cosine_topk as jax_sharded_topk
from facekit.pipeline import FacePipeline as JaxPipeline
from facekit_torch.config import FaceKitConfig
from facekit_torch.gallery import GalleryStore
from facekit_torch.models import detector_family
from facekit_torch.ops.similarity import (cosine_topk, cosine_topk_int8,
                                          quantize_rows_int8)
from facekit_torch.parallel import (ShardedRows, make_mesh, shard_gallery,
                                    shard_rows, sharded_cosine_topk)
from facekit_torch.pipeline import FacePipeline
from facekit_torch.weights import random_arcface_params

MESHES = {"gallery8": ({"gallery": 8}, None),
          "data2_gallery4": ({"data": 2, "gallery": 4}, "data")}
N = 64          # 8 rows a shard at {"gallery": 8}, 16 at {"gallery": 4}
B = 8


@pytest.fixture()
def rng():
    return np.random.default_rng(17)


def _unit(rng, n):
    x = rng.normal(size=(n, 512)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _meshes(axes):
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return make_mesh(axes, devices=["cpu"] * 8), jax_make_mesh(axes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_search_matches_facekit(rng, mesh_name, dtype):
    """Indices equal to facekit's sharded search and to the port's
    unsharded one at counts 0, n_local, n_local + 1 and N and k 1, 5 and
    n_local; scores within 1e-6 of facekit's and equal to the unsharded
    search's. Rows 3 and 10 recur in later shards (ties across shards,
    the lower index first) and are queries."""
    axes, qaxis = MESHES[mesh_name]
    mesh, jmesh = _meshes(axes)
    n_local = N // axes["gallery"]
    g = _unit(rng, N)
    g[[N // 2 + 1, N - 1]] = g[3]
    g[N - 5] = g[10]
    q = np.concatenate([g[[3, 10]], _unit(rng, B - 2)])
    if dtype == "int8":
        gt, st = quantize_rows_int8(torch.tensor(g))
        gj, sj = jax_quantize(jnp.asarray(g))
        ours_g, ours_s = shard_gallery(gt, mesh), shard_rows(st, mesh)
        ref_g, ref_s = jax_shard_gallery(gj, jmesh), jax_shard_rows(sj, jmesh)
        qt, qj = torch.tensor(q), jnp.asarray(q)
    else:
        td = getattr(torch, dtype)
        gt, qt = torch.tensor(g).to(td), torch.tensor(q).to(td)
        gj, qj = (jnp.asarray(x, getattr(jnp, dtype)) for x in (g, q))
        ours_g, ours_s = shard_gallery(gt, mesh), None
        ref_g, ref_s = jax_shard_gallery(gj, jmesh), None
    assert len(ours_g.blocks) == axes["gallery"]
    for count in (0, n_local, n_local + 1, N):
        for k in (1, 5, n_local):
            v, i = sharded_cosine_topk(ours_g, qt, count, k, mesh=mesh,
                                       query_axis=qaxis, scales=ours_s)
            rv, ri = jax_sharded_topk(ref_g, qj, jnp.int32(count), k=k,
                                      mesh=jmesh, query_axis=qaxis,
                                      scales=ref_s)
            what = f"count={count} k={k}"
            np.testing.assert_array_equal(i.numpy(), np.asarray(ri), what)
            np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0,
                                       atol=1e-6, err_msg=what)
            uv, ui = (cosine_topk(gt, qt, count, k) if ours_s is None else
                      cosine_topk_int8(gt, st, qt, count, k))
            assert torch.equal(i, ui) and torch.equal(v, uv), what
            if count >= 1 + max(N // 2 + 1, 10):
                # the duplicates: the lower index wins the tie
                assert i[0, 0] == 3 and i[1, 0] == 10


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mesh_store_matches_facekit(rng, dtype):
    """A mesh-backed store against facekit's and the port's single-device
    store, step for step: load, adds within the capacity (each writing
    its row's block only), an add across a bucket, reset, search."""
    mesh, jmesh = _meshes({"gallery": 8})
    buckets = (16, 64)
    ours = GalleryStore(buckets=buckets, dtype=dtype, device="cpu",
                        mesh=mesh)
    one = GalleryStore(buckets=buckets, dtype=dtype, device="cpu")
    ref = JaxStore(buckets=buckets, dtype=dtype, use_pallas=False,
                   mesh=jmesh)
    emb = _unit(rng, 24)
    names = [f"u{i}" for i in range(24)]
    q = np.concatenate([emb[[1, 9, 15, 20]], _unit(rng, 4)])

    def same(k_values=(1, 2)):
        assert ours.capacity == one.capacity == ref.capacity
        arr = ours.snapshot().arr
        assert isinstance(arr, ShardedRows) and len(arr.blocks) == 8
        rows = torch.cat([next(iter(b.values())) for b in arr.blocks])
        assert torch.equal(rows, one.snapshot().arr)
        for k in k_values:
            v, i, n = ours.search(q, k=k)
            rv, ri, rn = ref.search(jnp.asarray(q), k=k)
            ov, oi, _ = one.search(q, k=k)
            np.testing.assert_array_equal(i, ri)
            np.testing.assert_array_equal(i, oi)
            np.testing.assert_allclose(v, rv, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(v, ov)
            assert n == rn

    for s in (ours, one, ref):
        s.load(names[:6], emb[:6])
    same()
    blocks = [dict(b) for b in ours.snapshot().arr.blocks]
    for s in (ours, one, ref):
        for j in range(6, 16):
            s.add(names[j], emb[j])
    # in place, into the blocks' own tensors
    arr = ours.snapshot().arr
    assert all(arr.blocks[b][d] is blocks[b][d] for b in range(8)
               for d in blocks[b])
    same()
    for s in (ours, one, ref):
        for j in range(16, 24):
            s.add(names[j], emb[j])
    assert ours.capacity == 64
    same()
    for s in (ours, one, ref):
        s.reset()
    with pytest.raises(ValueError, match="No faces"):
        ours.search(q)
    assert ours.capacity == 16 and len(ours.snapshot().arr.blocks) == 8


def _pipelines(gallery_dtype):
    """The port's pipeline and facekit's on one numpy-drawn slim detector
    and ir_tiny embedder, 160x120 frames, detector input 64x64."""
    kw = dict(det_network="slim", rec_network="ir_tiny",
              det_inputShape=(3, 64, 64), input_frameWidth=160,
              input_frameHeight=120, compute_dtype="float32",
              gallery_dtype=gallery_dtype, det_threshold_bbox=0.3)
    rp = random_arcface_params("ir_tiny", seed=3)
    dp = detector_family("slim").random_params(0, True)
    return (FacePipeline(FaceKitConfig(**kw), rp, dp, device="cpu"),
            JaxPipeline(JaxConfig(**kw), dp, rp))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mesh_pipeline_matches_single_device_and_facekit(rng, dtype):
    """``recognize_and_match`` and ``embed_and_match`` on a
    {"data": 2, "gallery": 4} mesh (frames and crops split over "data",
    the gallery over "gallery"): equal to the port's single-device
    program (indices and detections equal, floats to rounding) and,
    within the frame path's tolerances, to facekit's mesh program."""
    ours, ref = _pipelines(dtype)
    axes = {"data": 2, "gallery": 4}
    mesh, jmesh = _meshes(axes)
    frames = rng.integers(0, 256, (4, 120, 160, 3), dtype=np.uint8)
    crops = rng.integers(0, 256, (4, 112, 112, 3), dtype=np.uint8)
    g = _unit(rng, 1024)
    # the gallery holds two crops' own embeddings: a top-1 by a margin
    g[[300, 900]] = ours.embed_cropped_batch(crops[[1, 3]])
    count = 1000
    if dtype == "int8":
        gt, st = quantize_rows_int8(torch.tensor(g))
        gj, sj = jax_quantize(jnp.asarray(g))
        one = dict(gallery_arr=gt, gallery_scale=st)
        sharded = dict(gallery_arr=shard_gallery(gt, mesh),
                       gallery_scale=shard_rows(st, mesh), mesh=mesh)
        jax_kw = dict(gallery_scale=jax_shard_rows(sj, jmesh), mesh=jmesh)
    else:
        gt, gj = torch.tensor(g), jnp.asarray(g)
        one = dict(gallery_arr=gt)
        sharded = dict(gallery_arr=shard_gallery(gt, mesh), mesh=mesh)
        jax_kw = dict(mesh=jmesh)
    jg = jax_shard_gallery(gj, jmesh)

    res, vals, idx = ours.recognize_and_match(frames, count=count, k=2,
                                              return_crops=True, **sharded)
    r1, v1, i1 = ours.recognize_and_match(frames, count=count, k=2,
                                          return_crops=True, **one)
    # each data position runs half the batch: PyTorch's CPU convs may
    # pick another algorithm by batch size, so floats agree to rounding
    for a, b in zip(res, r1):
        assert (a is None and b is None) or torch.allclose(a.float(),
                                                           b.float(),
                                                           rtol=0, atol=1e-5)
    assert torch.equal(res.valid, r1.valid) and torch.equal(idx, i1)
    # an int8 search quantizes the queries: a rounding difference of an
    # embedding can move one query component by a step (amax / 127)
    sim_atol = 1e-3 if dtype == "int8" else 1e-5
    assert torch.allclose(vals, v1, rtol=0, atol=sim_atol)
    assert ours._replicas == {}     # one device: no replica was made
    rres, rvals, ridx = ref.recognize_and_match(frames, jg, count, k=2,
                                                return_crops=True, **jax_kw)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(rres.valid))
    assert res.valid.any()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(res.embeddings.numpy(),
                               np.asarray(rres.embeddings), atol=1e-4)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals),
                               atol=max(sim_atol, 1e-4))

    emb, vals, idx = ours.embed_and_match(crops, count=count, **sharded)
    e1, v1, i1 = ours.embed_and_match(crops, count=count, **one)
    assert torch.equal(idx, i1)
    assert torch.allclose(emb, e1, rtol=0, atol=1e-5)
    assert torch.allclose(vals, v1, rtol=0, atol=sim_atol)
    assert idx[1, 0] == 300 and idx[3, 0] == 900
    remb, rvals, ridx = ref.embed_and_match(crops, jg, count, **jax_kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(emb.numpy(), np.asarray(remb), atol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals),
                               atol=sim_atol)


def test_replica_made_once_per_device():
    """A data position on another device gets its own copy of the
    networks and anchors, made once; the pipeline's device keeps the
    served ones (checked on the meta device: no data moves)."""
    ours, _ = _pipelines("float32")
    det, rec, anchors = ours._replica("cpu")
    assert (det, rec, anchors) == (ours.det_net, ours.rec_net, anchors) and \
        anchors is ours.anchors
    with torch.inference_mode():        # as the serving methods call it
        det, rec, anchors = ours._replica("meta")
    assert det is not ours.det_net and rec is not ours.rec_net
    # normal tensors: the fused blocks' operand cache reads _version
    assert not any(p.is_inference() for p in rec.parameters())
    assert {p.device.type for p in rec.parameters()} == {"meta"}
    assert anchors.device.type == "meta"
    assert ours._replica(torch.device("meta"))[1] is rec


@pytest.mark.parametrize("case", ["more_than_given", "no_gpu", "rows",
                                  "unsharded", "k_past_shard", "queries",
                                  "buckets"])
def test_mesh_refusals(case):
    """make_mesh refuses a mesh larger than its devices (facekit's
    message) and, by default, to run without a GPU; sharding refuses rows
    or queries that do not split, a gallery not sharded, k past a shard's
    rows, and a store bucket the shards do not divide."""
    mesh = make_mesh({"data": 2, "gallery": 4}, devices=["cpu"] * 8)
    g = torch.zeros((64, 512))
    if case == "more_than_given":
        with pytest.raises(ValueError, match="mesh needs 9 devices, have 8"):
            make_mesh({"gallery": 9}, devices=["cpu"] * 8)
        with pytest.raises(AssertionError, match="mesh needs 9 devices"):
            jax_make_mesh({"gallery": 9})
    elif case == "no_gpu":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
    elif case == "rows":
        with pytest.raises(ValueError, match="do not split into 4 shards"):
            shard_gallery(g[:62], mesh)
    elif case == "unsharded":
        with pytest.raises(TypeError, match="must be sharded"):
            sharded_cosine_topk(g, g[:2], 64, 1, mesh=mesh)
    elif case == "k_past_shard":
        with pytest.raises(ValueError, match="k=17"):
            sharded_cosine_topk(shard_gallery(g, mesh), g[:2], 64, 17,
                                mesh=mesh)
    elif case == "queries":
        with pytest.raises(ValueError, match="3 queries"):
            sharded_cosine_topk(shard_gallery(g, mesh), g[:3], 64, 1,
                                mesh=mesh, query_axis="data")
    else:
        with pytest.raises(ValueError, match=r"\[6\] are not multiples"):
            GalleryStore(buckets=(4, 6, 8), device="cpu", mesh=mesh)
