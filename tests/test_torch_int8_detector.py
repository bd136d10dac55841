"""facekit_torch's int8 detectors (``det_quantize``) against facekit's.

``quantize_detector`` against ``quantize_detector_params`` on RetinaFace,
slim and RFB (weights and scales bit for bit, 47 / 25 / 23 sites, heads
float); every int8 site's s32 sum and dequantized output against
facekit's s8 conv on the same input, depthwise sites included; the whole
int8 detector against facekit's within facekit's own int8 bars
(``tests/test_model_parity.py:311-369``); batch invariance; and
``FacePipeline`` with ``det_quantize`` against facekit's. The port runs
the plain s8 conv here (a float64 ``F.conv2d``, exact). Inputs and
parameters are drawn with numpy from a local seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.models import layers as JL
from facekit.models.lightdet import lightdet_apply
from facekit.models.retinaface import (quantize_detector_params,
                                       retinaface_apply)
from facekit.pipeline import FacePipeline as JaxPipeline
from facekit_torch.config import FaceKitConfig
from facekit_torch.models import LightDet, RetinaFace, quantize_detector
from facekit_torch.models import layers as TL
from facekit_torch.pipeline import FacePipeline
from facekit_torch.weights import (from_jax, random_arcface_params,
                                   random_lightdet_params,
                                   random_retinaface_params)
from test_torch_lightdet import PIPE, pipelines_agree

FAMILIES = ("mobilenet0.25", "slim", "rfb")
SITES = {"mobilenet0.25": 47, "slim": 25, "rfb": 23}
DW_SITES = {"mobilenet0.25": 13, "slim": 12, "rfb": 11}
HEADS = {"mobilenet0.25": ("class_head", "bbox_head", "ldm_head"),
         "slim": ("loc", "conf", "landm", "conv14_a", "conv14_b"),
         "rfb": ("loc", "conf", "landm", "conv14_a", "conv14_b", "rfb8")}


def _tree(family, seed=0):
    if family == "mobilenet0.25":
        return random_retinaface_params(seed=seed)
    return random_lightdet_params(family, seed=seed)


def _module(family):
    return RetinaFace() if family == "mobilenet0.25" else LightDet(family)


def _jax_apply(family, params, x):
    if family == "mobilenet0.25":
        return retinaface_apply(params, x)
    return lightdet_apply(params, x, variant=family)


class _Family:
    """One family's float tree, facekit's quantized tree, the port's
    float and int8 modules, and facekit's int8 outputs on ``x``."""

    def __init__(self, family):
        self.family = family
        self.tree = _tree(family, seed=3)
        self.qtree = quantize_detector_params(
            jax.tree.map(jnp.asarray, self.tree))
        net = _module(family)
        net.load_state_dict(from_jax(self.tree, net))
        self.net = net.eval()
        self.qnet = quantize_detector(self.net)
        self.x = np.random.default_rng(4).uniform(
            -130, 130, (2, 64, 96, 3)).astype(np.float32)
        self.ref = [np.asarray(o) for o in _jax_apply(
            family, self.qtree, jnp.asarray(self.x))]


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return _Family(request.param)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU ops of this file in one thread. Its many small convs
    spend most of their time in OpenMP barriers when other processes hold
    the cores: with every core busy elsewhere the file took over 380 s on
    torch's default threads and 65 s on one (49 s alone either way). No
    result depends on it: the s8 sums are exact in float64 in any order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qconvs(net):
    return {name: m for name, m in net.named_modules()
            if isinstance(m, TL.QConv)}


def test_quantize_detector_matches_facekit(fam):
    """Every site's int8 weight and f32 scale equal facekit's bit for bit
    (depthwise (C, 1, 3, 3) weights with per-channel scales too), at 47 /
    25 / 23 sites, 13 / 12 / 11 of them depthwise; the heads, conv14 and
    the RFB block stay float; the float module is left as it was."""
    sites = _qconvs(fam.qnet)
    assert len(sites) == SITES[fam.family]
    assert sum(m.q.shape[1] == 1 for m in sites.values()) == \
        DW_SITES[fam.family]
    expected = from_jax(jax.tree.map(np.asarray, fam.qtree), fam.qnet)
    got = fam.qnet.state_dict()
    assert sorted(got) == sorted(expected)
    for key, ref in expected.items():
        assert got[key].dtype == ref.dtype, key
        assert got[key].numpy().tobytes() == ref.numpy().tobytes(), key
    for name in sites:
        assert name.split(".")[0] not in HEADS[fam.family], name
    for head in HEADS[fam.family]:
        assert not any(isinstance(m, TL.QConv)
                       for m in getattr(fam.qnet, head).modules())
    assert not _qconvs(fam.net)
    no_dw = quantize_detector(fam.net, include_depthwise=False)
    assert len(_qconvs(no_dw)) == SITES[fam.family] - DW_SITES[fam.family]
    with pytest.raises(ValueError, match="float f32"):
        quantize_detector(fam.qnet)


# RetinaFace's cases of the two tests below are the slowest of this file;
# they run from test_torch_int8_detector_retinaface.py, on a worker of
# their own under ``--dist loadfile``
LIGHT = ("slim", "rfb")


@pytest.mark.parametrize("fam", LIGHT, indirect=True)
def test_every_site_equals_facekit_on_its_inputs(fam, monkeypatch):
    """Each int8 site, fed the activation the port's int8 forward gives
    it: the s8 x s8 -> s32 sum of the quantized input equals XLA's
    ``conv_general_dilated`` (``feature_group_count`` = C at the depthwise
    sites) bit for bit, and the dequantized output equals facekit's
    ``conv2d_int8``."""
    every_site_equals_facekit(fam, monkeypatch)


def every_site_equals_facekit(fam, monkeypatch):
    calls = []
    real = TL.conv2d_int8

    def record(x, wq, wscale, stride=1, padding=0, groups=1, ascale=None):
        calls.append((x, wq, wscale, stride, padding, groups))
        return real(x, wq, wscale, stride=stride, padding=padding,
                    groups=groups, ascale=ascale)
    monkeypatch.setattr(TL, "conv2d_int8", record)
    with torch.inference_mode():
        fam.qnet(torch.tensor(fam.x))
    assert len(calls) == SITES[fam.family]
    assert sum(g > 1 for *_, g in calls) == DW_SITES[fam.family]
    for x, wq, wscale, stride, pad, groups in calls:
        w_hwio = jnp.asarray(wq.permute(2, 3, 1, 0).numpy())
        xj = jnp.asarray(x.numpy())
        np.testing.assert_array_equal(
            real(x, wq, wscale, stride=stride, padding=pad,
                 groups=groups).numpy(),
            np.asarray(JL.conv2d_int8(xj, w_hwio, jnp.asarray(wscale.numpy()),
                                      stride=stride, padding=pad,
                                      groups=groups)))
        amax = x.float().abs().amax(dim=(1, 2, 3), keepdim=True)
        xq = torch.clamp(torch.round(x / (torch.clamp_min(amax, 1e-12)
                                          / 127.0)), -127, 127).to(torch.int8)
        ours = TL.conv_s8(xq, wq.permute(0, 2, 3, 1), stride, pad, groups)
        theirs = jax.lax.conv_general_dilated(
            jnp.asarray(xq.numpy()), w_hwio, (stride, stride),
            [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups, preferred_element_type=jnp.int32)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_int8_detector_within_facekit_bars(fam):
    """The port's int8 detector against facekit's on the same input, held
    to facekit's own int8 bars: conf within 1e-3, loc and ldm within 20 %
    of their largest magnitude; and against the port's float detector,
    the drift facekit allows its own int8 detector."""
    with torch.inference_mode():
        outs = [o.numpy() for o in fam.qnet(torch.tensor(fam.x))]
        floats = [o.numpy() for o in fam.net(torch.tensor(fam.x))]
    for against in (fam.ref, floats):
        loc, conf, ldm = against
        assert np.abs(outs[1] - conf).max() < 1e-3
        assert np.abs(outs[0] - loc).max() < 0.2 * np.abs(loc).max()
        assert np.abs(outs[2] - ldm).max() < 0.2 * np.abs(ldm).max()


@pytest.mark.parametrize("fam", LIGHT, indirect=True)
def test_int8_detector_is_batch_invariant(fam, monkeypatch):
    """Per-sample activation scales: every int8 site's output for a frame
    is the same bits alone as in the batch, and RetinaFace's whole int8
    detector too. The light detectors' float convs (their heads, conv14,
    RFB's block) run PyTorch's CPU convolution, which picks its algorithm
    by batch size at some of their shapes and so moves an output by an
    ulp (their float detectors are not batch-invariant here either); their
    whole outputs are held to facekit's int8 bars instead."""
    int8_detector_is_batch_invariant(fam, monkeypatch)


def int8_detector_is_batch_invariant(fam, monkeypatch):
    calls = []
    real = TL.conv2d_int8

    def record(x, *args, **kwargs):
        out = real(x, *args, **kwargs)
        calls.append((x, args, kwargs, out))
        return out
    monkeypatch.setattr(TL, "conv2d_int8", record)
    with torch.inference_mode():
        both = fam.qnet(torch.tensor(fam.x))
        ones = [fam.qnet(torch.tensor(fam.x[i:i + 1])) for i in range(2)]
        monkeypatch.setattr(TL, "conv2d_int8", real)
        for x, args, kwargs, out in calls[:SITES[fam.family]]:
            for i in range(2):
                assert torch.equal(real(x[i:i + 1], *args, **kwargs)[0],
                                   out[i])
    for i, one in enumerate(ones):
        for a, b in zip(one, both):
            if fam.family == "mobilenet0.25":
                assert torch.equal(a[0], b[i])
        assert (one[1][0] - both[1][i]).abs().max() < 1e-3
        for k in (0, 2):
            assert (one[k][0] - both[k][i]).abs().max() < \
                0.2 * both[k][i].abs().max()


@pytest.mark.parametrize("family", ["mobilenet0.25", "rfb"])
def test_pipeline_det_quantize_matches_facekit(family):
    """``FacePipeline`` with ``det_quantize`` (the detector quantized
    before it moves to the device) against facekit's on the same frames,
    compared as the float light detectors are."""
    rp = random_arcface_params("ir_tiny", seed=4)
    dp = _tree(family, seed=0)
    cfg = dict(PIPE, det_network=family, det_quantize=True)
    ours = FacePipeline(FaceKitConfig(**cfg), rp, dp, device="cpu")
    ref = JaxPipeline(JaxConfig(**cfg), dp, rp)
    assert len(_qconvs(ours.det_net)) == SITES[family]
    assert pipelines_agree(ours, ref, seed=32, int8=True) == 3
