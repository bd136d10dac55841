"""facekit_torch's slim and RFB light detectors against facekit's.

The module (``LightDet``) against ``lightdet_apply`` in f32 and bf16, its
anchors, the weight carry-over (``from_jax``, ``random_lightdet_params``),
the checkpoint converter, the param files and the converter CLI's
``slim`` / ``rfb`` modes, and ``FacePipeline`` with either detector
against facekit's. Inputs and parameters are drawn with numpy from a
local seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from facekit.config import FaceKitConfig as JaxConfig
from facekit.models.lightdet import lightdet_apply, lightdet_init
from facekit.ops import anchors as JN
from facekit.pipeline import FacePipeline as JaxPipeline
from facekit.weights import convert as jax_convert
from facekit.weights import load_params as jax_load_params
from facekit.weights.__main__ import main as jax_cli_main
from facekit_torch.config import FaceKitConfig
from facekit_torch.models import LightDet
from facekit_torch.ops import anchors as TN
from facekit_torch.pipeline import FacePipeline
from facekit_torch.server.app import load_detector_params
from facekit_torch.weights import (ConversionError,
                                   convert_lightdet_state_dict, from_jax,
                                   load_params, random_arcface_params,
                                   random_lightdet_params, save_params)
from facekit_torch.weights.__main__ import main as cli_main
from test_torch_gen_mode import SCORE_MARGIN, _faces_at
from test_torch_weights import assert_same_leaves
from torch_reference_layout import lightdet_state_dict

VARIANTS = ("slim", "rfb")
DET_HW = (96, 128)
# the pipeline tests' geometry, small enough for XLA on the CPU
PIPE = dict(rec_network="ir_tiny", compute_dtype="float32",
            gallery_dtype="float32", input_frameWidth=160,
            input_frameHeight=120, det_inputShape=(3, 96, 128),
            det_threshold_bbox=0.5, extras={"rec_useAlignment": True})


def _net(variant, seed=1):
    params = random_lightdet_params(variant, seed=seed)
    net = LightDet(variant)
    net.load_state_dict(from_jax(params, net))
    return params, net.eval()


def _x(seed, n=2, hw=DET_HW):
    return np.random.default_rng(seed).uniform(-120, 130, (n, *hw, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lightdet_f32_matches(variant):
    params, net = _net(variant)
    x = _x(2)
    ref = lightdet_apply(params, jnp.asarray(x), variant=variant)
    with torch.inference_mode():
        outs = net(torch.tensor(x))
    a = TN.num_anchors(DET_HW, TN.SLIM_RFB_STEPS, TN.SLIM_RFB_MIN_SIZES)
    for out, r, dim in zip(outs, ref, (4, 2, 10)):
        assert out.shape == (2, a, dim) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lightdet_bf16_close(variant):
    """bf16 compute on both sides, the bars RetinaFace is held to: each
    conv rounds its output to bf16 once from f32 sums taken in another
    order (loc / ldm within 1e-2; softmax in f32: 2e-3)."""
    params, net = _net(variant)
    x = _x(3, n=1)
    ref = lightdet_apply(params, jnp.asarray(x), variant=variant,
                         dtype=jnp.bfloat16)
    net.set_compute_dtype(torch.bfloat16)
    assert net.conv1.conv.dtype == torch.bfloat16
    assert net.loc[0].dw_b.dtype == torch.float32
    with torch.inference_mode():
        loc, conf, ldm = net(torch.tensor(x))
    np.testing.assert_allclose(loc.numpy(), np.asarray(ref[0]), atol=1e-2)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref[1]), atol=2e-3)
    np.testing.assert_allclose(ldm.numpy(), np.asarray(ref[2]), atol=1e-2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_from_jax_takes_lightdet_init(variant):
    """facekit's own tree (jax arrays, lists, RFB's ``None``) fits the
    module, and the module runs it as facekit does."""
    tree = lightdet_init(jax.random.PRNGKey(5), variant=variant)
    assert (tree["dw"][6] is None) == (variant == "rfb")
    net = LightDet(variant)
    net.load_state_dict(from_jax(tree, net))
    assert ("rfb8.b2.3.w" in net.state_dict()) == (variant == "rfb")
    assert ("dw.6.dw_conv" in net.state_dict()) == (variant == "slim")
    x = _x(4, n=1)
    ref = lightdet_apply(tree, jnp.asarray(x), variant=variant)
    with torch.inference_mode():
        outs = net.eval()(torch.tensor(x))
    for out, r in zip(outs, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_random_params_have_facekit_structure(variant):
    """Same tree paths, shapes and dtypes as ``lightdet_init``, ``None``
    where it has one; the other variant's tree does not fit."""
    ours = random_lightdet_params(variant, seed=0)
    theirs = lightdet_init(jax.random.PRNGKey(0), variant=variant)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    other = LightDet("rfb" if variant == "slim" else "slim")
    with pytest.raises(ValueError, match="does not fit"):
        from_jax(ours, other)


@pytest.mark.parametrize("hw", [(288, 320), (96, 128)])
def test_lightdet_anchors_match(hw):
    """The 4-level anchors equal facekit's, and there are as many as the
    detector has outputs (5,295 at 288x320)."""
    ours = TN.generate_anchors(hw, TN.SLIM_RFB_STEPS, TN.SLIM_RFB_MIN_SIZES)
    ref = JN.generate_anchors(hw, JN.SLIM_RFB_STEPS, JN.SLIM_RFB_MIN_SIZES)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    _, net = _net("slim")
    with torch.inference_mode():
        loc, _, _ = net(torch.zeros((1, *hw, 3)))
    assert loc.shape[1] == ours.shape[0] == TN.num_anchors(
        hw, TN.SLIM_RFB_STEPS, TN.SLIM_RFB_MIN_SIZES)
    if hw == (288, 320):
        assert ours.shape[0] == 36 * 40 * 3 + 18 * 20 * 2 + 9 * 10 * 2 \
            + 5 * 5 * 3 == 5295


# -- weights -------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_matches_facekit(variant, tmp_path):
    """A reference-layout state_dict converts to facekit's tree leaf for
    leaf and bit for bit, which is the tree it was made from; the file is
    the bytes flax writes for facekit's conversion and loads back with
    RFB's ``None``."""
    tree = random_lightdet_params(variant, seed=7)
    sd = lightdet_state_dict(tree)
    ours = convert_lightdet_state_dict(sd, variant)
    theirs = jax_convert.convert_lightdet_state_dict(sd, variant)
    assert_same_leaves(ours, jax.tree.map(np.asarray, theirs))
    assert_same_leaves(ours, tree)
    path = str(tmp_path / "d.msgpack")
    save_params(ours, path)
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(theirs)
    back = load_params(path)
    assert (back["dw"]["6"] is None) == (variant == "rfb")
    net = LightDet(variant)
    net.load_state_dict(from_jax(back, net))
    template = lightdet_init(jax.random.PRNGKey(0), variant=variant)
    assert_same_leaves(jax.tree.map(np.asarray,
                                    jax_load_params(template, path)), tree)


def test_save_params_equals_flax_for_rfb(tmp_path):
    """RFB's ``None`` is written as msgpack nil, as flax writes it, and
    facekit restores the file into its own template."""
    tree = random_lightdet_params("rfb", seed=8)
    path = str(tmp_path / "rfb.msgpack")
    save_params(tree, path)
    with open(path, "rb") as f:
        data = f.read()
    assert data == serialization.to_bytes(tree)
    assert load_params(path)["dw"]["6"] is None


@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_refusals_match_facekit(variant):
    """An unused key refuses the checkpoint with facekit's message; a
    slim checkpoint is not an RFB one."""
    tree = random_lightdet_params(variant, seed=9)
    sd = dict(lightdet_state_dict(tree))
    sd["extra.weight"] = torch.zeros(3)
    msgs = []
    for convert, err in ((convert_lightdet_state_dict, ConversionError),
                         (jax_convert.convert_lightdet_state_dict,
                          jax_convert.ConversionError)):
        with pytest.raises(err, match="never consumed") as e:
            convert(sd, variant)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "extra.weight" in msgs[0]
    del sd["extra.weight"]
    assert convert_lightdet_state_dict(sd, variant, strict=True)
    other = "rfb" if variant == "slim" else "slim"
    with pytest.raises(ConversionError):
        convert_lightdet_state_dict(sd, other)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cli_modes_match_facekit(variant, tmp_path, capsys):
    """``python -m facekit_torch.weights slim|rfb`` writes the file
    facekit's CLI writes, and ``--verify --device cpu`` runs LightDet on
    it."""
    tree = random_lightdet_params(variant, seed=10)
    ckpt = str(tmp_path / "m.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               lightdet_state_dict(tree).items()}}, ckpt)
    ours, theirs = str(tmp_path / "o.msgpack"), str(tmp_path / "t.msgpack")
    cli_main([variant, ckpt, ours, "--verify", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "verify: [(1, 5875, 4), (1, 5875, 2), (1, 5875, 10)] " \
           "finite = True" in printed
    jax_cli_main([variant, ckpt, theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_light_detector_file_loads_with_landmarks(tmp_path):
    """``det_withLandmarks: true`` (the default) with a slim or RFB file:
    its landmark heads are ``landm``, not ``ldm_head``, and it loads; a
    file without them is refused."""
    for variant in VARIANTS:
        path = str(tmp_path / f"{variant}.msgpack")
        tree = random_lightdet_params(variant, seed=11)
        save_params(tree, path)
        cfg = FaceKitConfig(det_network=variant, det_weights=path,
                            det_withLandmarks=True)
        params = load_detector_params(cfg)
        assert "landm" in params
        net = LightDet(variant)
        net.load_state_dict(from_jax(params, net))
        save_params({k: v for k, v in tree.items() if k != "landm"}, path)
        with pytest.raises(ValueError, match="no landm"):
            load_detector_params(cfg)


# -- the pipeline ----------------------------------------------------------------

def pipelines_agree(ours, ref, seed, int8=False):
    """``recognize_frames`` of the port's and facekit's pipelines on the
    same frames, where a frame's face count holds with the threshold moved
    by SCORE_MARGIN: the same valid slots; in float, boxes and landmarks
    within 1e-3 px, scores within 1e-6 and embeddings within 1e-4. An int8
    detector's scores move by about 1e-5 where a float difference of an
    ulp flips an int8 rounding, which reorders the near-tied candidates of
    random weights: there the leading slot of every frame and half of all
    slots must hold the same face (landmarks within 1 px), and those slots
    match within facekit's int8 conf bar (1e-3) and 1e-4 in embedding.
    Returns how many frames were compared."""
    frames = np.random.default_rng(seed).integers(0, 256, (3, 120, 160, 3),
                                                  dtype=np.uint8)
    res = ours.recognize_frames(frames)
    r_res = ref.recognize_frames(frames)
    thr = ours.config.det_threshold_bbox
    low, high = (_faces_at(ours, frames, thr + d)
                 for d in (-SCORE_MARGIN, SCORE_MARGIN))
    clear = ((low == high) & (high == res.valid.sum(-1))).numpy()
    assert ours.use_landmarks and ref.use_landmarks
    valid = res.valid.numpy()[clear]
    np.testing.assert_array_equal(valid, np.asarray(r_res.valid)[clear])
    assert valid.any()

    def pair(a, b):
        return a.numpy()[clear], np.asarray(b)[clear]
    lm, r_lm = pair(res.landmarks, r_res.landmarks)
    if int8:
        same = valid & (np.abs(lm - r_lm).max((-1, -2)) < 1.0)
        assert same[:, 0].all() and same.sum() >= 0.5 * valid.sum()
        bars = ((res.scores, r_res.scores, 1e-3),
                (res.embeddings, r_res.embeddings, 1e-4))
    else:
        same = valid
        bars = ((res.boxes, r_res.boxes, 1e-3),
                (res.landmarks, r_res.landmarks, 1e-3),
                (res.scores, r_res.scores, 1e-6),
                (res.embeddings, r_res.embeddings, 1e-4))
    for ours_t, theirs, atol in bars:
        a, b = pair(ours_t, theirs)
        np.testing.assert_allclose(a[same], b[same], atol=atol)
    return int(clear.sum())


@pytest.mark.parametrize("variant", VARIANTS)
def test_pipeline_matches_facekit(variant):
    """``FacePipeline`` with ``det_network`` slim / rfb (its module, its
    anchors, landmarks from ``landm``, alignment) against facekit's."""
    rp = random_arcface_params("ir_tiny", seed=4)
    dp = random_lightdet_params(variant, seed=0)
    cfg = dict(PIPE, det_network=variant)
    ours = FacePipeline(FaceKitConfig(**cfg), rp, dp, device="cpu")
    ref = JaxPipeline(JaxConfig(**cfg), dp, rp)
    assert isinstance(ours.det_net, LightDet) and ours.align
    assert ours.anchors.shape[0] == TN.num_anchors(
        DET_HW, TN.SLIM_RFB_STEPS, TN.SLIM_RFB_MIN_SIZES)
    assert pipelines_agree(ours, ref, seed=30) == 3
