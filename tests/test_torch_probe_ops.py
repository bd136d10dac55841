"""The server and op remainder of facekit_torch against facekit's:
``/probe/device``, ``GalleryStore.reset``, ``iou_matrix``,
``warp_align_gather`` (with its ``_bilinear_sample``), the ops package's
re-exports, ``StageTimer`` and ``profile_trace``.
"""

import contextlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facekit.ops as jax_ops
from facekit.config import FaceKitConfig as JaxConfig
from facekit.gallery import GalleryStore as JaxStore
from facekit.ops import align as JA
from facekit.server import FaceServer as JaxServer
from facekit.server import make_app as jax_make_app
from facekit.utils import LatencyTracker as JaxTracker
from facekit.utils import StageTimer as JaxStageTimer
import facekit_torch.ops as ops
from facekit_torch.config import FaceKitConfig
from facekit_torch.gallery import GalleryStore
from facekit_torch.ops import align as TA
from facekit_torch.server import FaceServer, make_app
from facekit_torch.utils import LatencyTracker, StageTimer, profile_trace
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params)

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

_COMMON = dict(rec_network="ir_tiny", compute_dtype="float32",
               gallery_dtype="float32", gallery_bucket_sizes=(16, 64))
# facekit's /probe/device reply
PROBE_KEYS = {"bytes", "upload_s", "upload_MBps", "dispatch_ms", "platform"}


@contextlib.asynccontextmanager
async def _clients(tmp, extras):
    """Test clients of facekit's server and the port's, on one config."""
    rec = random_arcface_params("ir_tiny", seed=31)
    det = random_retinaface_params(seed=0)
    ref = JaxServer(JaxConfig(database_path=str(tmp / "jax.db"),
                              use_pallas_search=False, extras=dict(extras),
                              **_COMMON),
                    det_params=det, rec_params=rec, warmup=False)
    ours = FaceServer(FaceKitConfig(database_path=str(tmp / "torch.db"),
                                    extras=dict(extras), **_COMMON),
                      rec_params=rec, warmup=False, device="cpu")
    clients = [TestClient(TestServer(jax_make_app(ref))),
               TestClient(TestServer(make_app(ours)))]
    try:
        for c in clients:
            await c.start_server()
        yield clients
    finally:
        for c in clients:
            await c.close()
        ours.close()


async def _both(clients, path):
    out = []
    for c in clients:
        r = await c.get(path)
        out.append((r.status, r.headers.get("Retry-After"), await r.text()))
    return out


async def test_probe_device_matches_facekit(tmp_path):
    """400 for a bad or out-of-range ``mb`` (the same bodies), 200 with
    facekit's keys and ``platform`` "cpu" here, then 429 with Retry-After
    inside the default 10 s cooldown."""
    async with _clients(tmp_path, {}) as clients:
        for bad in ("x", "0.1", "65"):
            ref, ours = await _both(clients, f"/probe/device?mb={bad}")
            assert ours == ref and ours[0] == 400
        ref, ours = await _both(clients, "/probe/device?mb=0.5")
        assert ref[0] == ours[0] == 200
        got, want = json.loads(ours[2]), json.loads(ref[2])
        assert set(got) == set(want) == PROBE_KEYS
        assert got["bytes"] == want["bytes"] == 1 << 19
        assert got["platform"] == want["platform"] == "cpu"
        assert got["upload_s"] >= 0 and got["dispatch_ms"] >= 0
        assert got["upload_MBps"] == pytest.approx(
            0.5 / max(got["upload_s"], 1e-9))
        ref, ours = await _both(clients, "/probe/device")
        assert ref[0] == ours[0] == 429
        assert int(ours[1]) >= 1 and int(ref[1]) >= 1
        assert ours[2] == ref[2]


async def test_probe_device_cooldown_off(tmp_path):
    """``server_probeCooldownS: 0`` disables the cooldown: two probes in a
    row both answer 200, in both servers."""
    async with _clients(tmp_path, {"server_probeCooldownS": 0}) as clients:
        for _ in range(2):
            ref, ours = await _both(clients, "/probe/device?mb=0.125")
            assert ref[0] == ours[0] == 200
            assert json.loads(ours[2])["bytes"] == 1 << 17


def _unit(rng, n):
    x = rng.normal(size=(n, 512)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gallery_reset_matches_facekit(dtype):
    """reset empties the store to its first bucket; it fills and searches
    again as facekit's does."""
    rng = np.random.default_rng(32)
    buckets = (16, 64)
    ours = GalleryStore(buckets=buckets, dtype=dtype, device="cpu")
    ref = JaxStore(buckets=buckets, dtype=dtype, use_pallas=False)
    emb = _unit(rng, 40)
    for s in (ours, ref):
        s.load([f"u{i}" for i in range(30)], emb[:30])
    assert ours.capacity == ref.capacity == 64
    for s in (ours, ref):
        s.reset()
    assert (ours.count, ours.capacity, ours.names) == (
        ref.count, ref.capacity, ref.names) == (0, 16, [])
    assert ours.snapshot().count == 0
    for i in range(30, 40):
        ours.add(f"u{i}", emb[i])
        ref.add(f"u{i}", emb[i])
    q = _unit(rng, 3)
    vals, idx, names = ours.search(q, k=4)
    r_vals, r_idx, r_names = ref.search(jnp.asarray(q), k=4)
    assert names == r_names == [f"u{i}" for i in range(30, 40)]
    np.testing.assert_array_equal(idx, np.asarray(r_idx))
    np.testing.assert_allclose(vals, np.asarray(r_vals), rtol=0, atol=1e-6)


def test_iou_matrix_matches_facekit():
    """Pairwise IoU with the +1 area convention, disjoint, nested,
    identical and degenerate (x1 == x2) boxes included."""
    rng = np.random.default_rng(33)
    xy = np.sort(rng.uniform(0, 100, (12, 2, 2)), axis=1)
    boxes = np.concatenate([xy[:, 0], xy[:, 1]], 1).astype(np.float32)
    boxes[1] = boxes[0]
    boxes[2, 2] = boxes[2, 0]
    boxes[3] = [200, 200, 210, 230]
    ours = ops.iou_matrix(torch.tensor(boxes)).numpy()
    ref = np.asarray(jax_ops.iou_matrix(jnp.asarray(boxes)))
    np.testing.assert_array_equal(ours, ref)
    assert ours[0, 1] == 1 and ours[3, :3].max() == 0


def test_bilinear_sample_bit_equal():
    """The gather sampler against facekit's (op by op, outside jit) at
    coordinates inside, across and outside the frame: bit for bit."""
    rng = np.random.default_rng(34)
    frame = rng.uniform(0, 255, (60, 80, 3)).astype(np.float32)
    xs = rng.uniform(-3, 83, (2, 30, 40)).astype(np.float32)
    ys = rng.uniform(-3, 63, (2, 30, 40)).astype(np.float32)
    xs[0, 0, :4] = [0, 79, -1, 80]
    ours = TA._bilinear_sample(torch.tensor(frame), torch.tensor(xs),
                               torch.tensor(ys)).numpy()
    ref = np.asarray(JA._bilinear_sample(jnp.asarray(frame), jnp.asarray(xs),
                                         jnp.asarray(ys)))
    np.testing.assert_array_equal(ours, ref)


# umeyama's matrices differ by 1-3 ulps between the frameworks
# (tests/test_torch_detect.py, test_umeyama_matches), which moves each
# sample position by up to about 1e-4 px, and a pixel by that times the
# frame's local gradient (up to 255 / px on noise): the bar of
# warp_align_frames, 1e-4 of full scale (measured: 1.0e-2)
PIXEL_ATOL = 255 * 1e-4


@pytest.mark.parametrize("out_hw", [(112, 112), (96, 80)])
def test_warp_align_gather_matches_facekit(out_hw):
    """Faces rotated up to 35 degrees, scaled 0.5-1.2, some partly out of
    the frame (zero fill), at the template's size and a scaled one."""
    rng = np.random.default_rng(35)
    frame = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    lms = []
    for _ in range(5):
        a = rng.uniform(-0.6, 0.6)
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        lms.append(TA.ARCFACE_TEMPLATE_112 @ r.T * rng.uniform(0.5, 1.2)
                   + rng.uniform([-30, -20], [80, 30])
                   + rng.normal(0, 1, (5, 2)))
    lms = np.asarray(lms, np.float32)
    ours = ops.warp_align_gather(torch.tensor(frame), torch.tensor(lms),
                                 out_hw).numpy()
    ref = np.asarray(jax_ops.warp_align_gather(jnp.asarray(frame),
                                               jnp.asarray(lms), out_hw))
    assert ours.shape == (5, *out_hw, 3) and (ours == 0).any()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PIXEL_ATOL)


def test_ops_exports_facekits_detect_and_align_names():
    names = ("letterbox", "letterbox_geometry", "crop_resize",
             "generate_anchors", "decode_boxes", "decode_landmarks",
             "unletterbox_boxes", "iou_matrix", "nms", "select_faces",
             "umeyama", "warp_align", "warp_align_gather",
             "warp_align_shear")
    for name in names:
        assert callable(getattr(jax_ops, name)), name
        assert callable(getattr(ops, name)), name
    assert ops.warp_align is ops.warp_align_shear


def test_stage_timer_and_profile_trace(tmp_path):
    """StageTimer feeds the tracker under prefix + name, as facekit's;
    profile_trace writes a torch.profiler trace into its folder."""
    snaps = []
    for tracker_cls, timer_cls in ((LatencyTracker, StageTimer),
                                   (JaxTracker, JaxStageTimer)):
        tracker = tracker_cls()
        timer = timer_cls(tracker, prefix="rec/")
        for _ in range(3):
            with timer.stage("embed"):
                pass
        snaps.append({k: v["count"] for k, v in tracker.snapshot().items()})
    assert snaps[0] == snaps[1] == {"rec/embed": 3}
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        torch.ones(8).mul(2).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
