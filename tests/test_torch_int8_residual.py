"""facekit_torch's int8-residual ArcFace against facekit's, on the CPU at
ir_tiny (``rec_int8Residual``, ``facekit/models/arcface.py:121-224``).

The same float parameters, drawn from a seed with numpy, go to both
packages, and one ``act_amax`` dict computed by facekit goes to both
quantizers: every weight, ``ascale`` and ``oscale`` must then be
bit-equal. The residual form adds one 127-level quantization of every
block output to the calibrated form, which turns the last-bit
differences of the two frameworks' float batch-norm
(``tests/test_torch_int8_model.py``) into whole int8 steps more often:

  * one block fed the same s8 input and scale: measured over seeds 3, 5,
    8 and 11 on block 0, 100 % of the s8 outputs equal on three seeds and
    all but 2 of 802,816 on the fourth, each 1 step apart. The bar: at
    least 99.99 % equal, no element more than 1 step apart;
  * end to end: cosine distance 2.2e-5 to 8.3e-5 between the two
    packages' residual embedders (calibrated: 1.2e-7 to 3.0e-5). The
    bar: 2e-4.

facekit's relation between the residual and the calibrated drift from
float (``tests/test_model_parity.py:300-303``) holds for the port alone:
measured 5.8e-4 to 6.8e-4 against 3.7e-4 to 4.6e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.models.arcface import _block_apply_q8
from facekit.models.arcface import arcface_act_amax as jax_act_amax
from facekit.models.arcface import arcface_apply, quantize_arcface_params
from facekit_torch.config import FaceKitConfig
from facekit_torch.engine import (export_embed_engine, load_serving_engines,
                                  save_engine)
from facekit_torch.models import ArcFace
from facekit_torch.models.arcface import (arcface_act_amax,
                                          calibrate_arcface_int8,
                                          quantize_act, quantize_arcface)
from facekit_torch.pipeline import FacePipeline
from facekit_torch.weights import from_jax, random_arcface_params

NET = "ir_tiny"
HEADROOM = 1.25
RESIDUAL_COS_TOL = 2e-4      # port against facekit, residual, end to end
BLOCK_EQUAL_SHARE = 0.9999
BLOCK_MAX_STEP = 1


@pytest.fixture(scope="module")
def params():
    return random_arcface_params(NET, seed=3)


@pytest.fixture(scope="module")
def float_net(params):
    net = ArcFace(NET)
    net.load_state_dict(from_jax(params, net))
    return net.eval()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (4, 112, 112, 3)).astype(np.float32)
    calib = rng.uniform(-1, 1, (3, 112, 112, 3)).astype(np.float32)
    return x, calib


@pytest.fixture(scope="module")
def act_amax(params, data):
    """facekit's activation maxima of one calibration batch, with the
    headroom, in Python floats."""
    stats = jax_act_amax(params, jnp.asarray(data[1]), network=NET)
    return {k: float(v) * HEADROOM for k, v in stats.items()}


@pytest.fixture(scope="module")
def residual(params, float_net, act_amax):
    """(facekit's residual tree, the port's residual ArcFace)."""
    return (quantize_arcface_params(params, act_amax=act_amax,
                                    int8_residual=True),
            quantize_arcface(float_net, act_amax, int8_residual=True))


def _cos_dist(a, b):
    return float((1.0 - (np.asarray(a) * np.asarray(b)).sum(-1)).max())


def _embed(net, x):
    with torch.inference_mode():
        return net(torch.tensor(x)).numpy()


def test_scales_and_weights_bit_equal(residual):
    """facekit's residual tree, carried over by ``from_jax``, equals the
    port's own quantization entry for entry: the q weights, their scales,
    every ``ascale`` and the stem's and each block's ``oscale``."""
    tree, ours = residual
    assert ours.int8 == "residual"
    carried = from_jax(tree, ArcFace(NET, int8="residual"))
    state = ours.state_dict()
    assert sorted(carried) == sorted(state)
    oscales = [k for k in state if k.endswith(".oscale")]
    assert oscales == ["input.oscale"] + [f"blocks.{i}.oscale"
                                          for i in range(4)]
    assert sum(k.endswith(".ascale") for k in state) == 12
    for key, value in state.items():
        assert carried[key].dtype == value.dtype, key
        assert torch.equal(carried[key], value), key


def test_from_jax_refuses_another_form(residual):
    """A residual tree fits only a residual module: its ``oscale`` leaves
    are unused keys for a calibrated one, and a calibrated module's tree
    lacks them for a residual one."""
    tree, _ = residual
    with pytest.raises(ValueError, match="unused.*oscale"):
        from_jax(tree, ArcFace(NET, int8="static"))
    static = {**tree, "input": {k: v for k, v in tree["input"].items()
                                if k != "oscale"}}
    with pytest.raises(ValueError, match="missing.*oscale"):
        from_jax(static, ArcFace(NET, int8="residual"))


def test_quantize_act_matches_facekit():
    """Round half to even after an f32 division, clamped to +-127."""
    from facekit.models.arcface import _quantize_act
    rng = np.random.default_rng(9)
    scale = np.float32(0.0173)
    x = np.concatenate([rng.normal(0, 1.5, 4000),
                        (np.arange(-130, 131) + 0.5) * scale]
                       ).astype(np.float32)
    ours = quantize_act(torch.tensor(x), torch.tensor(scale)).numpy()
    ref = np.asarray(_quantize_act(jnp.asarray(x), jnp.asarray(scale)))
    assert ours.dtype == np.int8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("block", [0, 2])
def test_residual_block_matches_facekit(residual, block):
    """One block fed the same s8 input at the same scale (the stem's or
    the previous block's ``oscale``): the share of s8 outputs equal to
    facekit's ``_block_apply_q8`` and the largest step apart (module
    docstring), and the same output scale."""
    tree, ours = residual
    rng = np.random.default_rng(10 + block)
    in_c = ours.blocks[block].bn1.scale.shape[0]
    hw = 112 >> block
    xq = rng.integers(-127, 128, (2, hw, hw, in_c)).astype(np.int8)
    xs = np.float32(tree["input"]["oscale"] if block == 0
                    else tree["blocks"][block - 1]["oscale"])
    ref_q, ref_s = _block_apply_q8(jnp.asarray(xq), jnp.asarray(xs),
                                   tree["blocks"][block], 2, jnp.float32)
    with torch.inference_mode():
        got_q, got_s = ours.blocks[block].forward_q8(
            torch.tensor(xq), torch.tensor(xs), torch.float32)
    steps = np.abs(got_q.numpy().astype(np.int32)
                   - np.asarray(ref_q).astype(np.int32))
    assert got_q.dtype == torch.int8 and got_q.shape == ref_q.shape
    assert (steps == 0).mean() >= BLOCK_EQUAL_SHARE
    assert steps.max() <= BLOCK_MAX_STEP
    assert float(got_s) == float(ref_s)


def test_residual_embedder_matches_facekit(residual, data):
    tree, ours = residual
    x = data[0]
    got = _embed(ours, x)
    ref = np.asarray(arcface_apply(tree, jnp.asarray(x), network=NET))
    assert got.shape == (4, 512) and np.isfinite(got).all()
    assert _cos_dist(got, ref) < RESIDUAL_COS_TOL


def test_residual_drift_relation(float_net, residual, act_amax, data):
    """facekit's relation (``tests/test_model_parity.py:300-303``) on the
    port alone: the residual embedder's drift from float stays within
    five times the calibrated one's, or 2e-2."""
    x = data[0]
    e_f = _embed(float_net, x)
    drift_r = _cos_dist(_embed(residual[1], x), e_f)
    drift_q = _cos_dist(_embed(quantize_arcface(float_net, act_amax), x),
                        e_f)
    assert 0 < drift_q and drift_r < max(5 * drift_q, 2e-2)


def test_calibration_builds_the_residual_form(float_net, data):
    """``calibrate_arcface_int8(int8_residual=True)`` equals quantizing
    with the port's own maxima of the batch (the block outputs among
    them) times the headroom."""
    calib = torch.tensor(data[1])
    net = calibrate_arcface_int8(float_net, [calib], headroom=HEADROOM,
                                 int8_residual=True)
    assert net.int8 == "residual"
    amax = {k: v * HEADROOM
            for k, v in arcface_act_amax(float_net, calib).items()}
    assert {"stem.out", "b3.out"} <= set(amax)
    ref = quantize_arcface(float_net, amax, int8_residual=True)
    got = net.state_dict()
    for key, value in ref.state_dict().items():
        assert torch.equal(got[key], value), key


def test_uncalibrated_residual_raises(float_net):
    with pytest.raises(ValueError, match="int8_residual requires"):
        quantize_arcface(float_net, None, int8_residual=True)
    with pytest.raises(ValueError, match="int8_residual requires"):
        quantize_arcface_params(random_arcface_params(NET, seed=3),
                                int8_residual=True)


# -- the pipeline and its engines -----------------------------------------------

_CFG = dict(rec_network=NET, compute_dtype="float32", gallery_dtype="int8",
            rec_quantize=True)


def _crops(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 112, 112, 3),
                                                dtype=np.uint8)


def _pipeline(residual_mode):
    extras = {"rec_int8Residual": True} if residual_mode else {}
    pipe = FacePipeline(FaceKitConfig(**_CFG, extras=extras),
                        random_arcface_params(NET, seed=4), device="cpu")
    pipe.calibrate_embedder([_crops(7, 4)])
    return pipe


@pytest.fixture(scope="module")
def pipes():
    return {"residual": _pipeline(True), "calibrated": _pipeline(False)}


def test_pipeline_passes_the_flag(pipes):
    assert pipes["residual"].rec_net.int8 == "residual"
    assert pipes["calibrated"].rec_net.int8 == "static"


def test_residual_engine_exports_and_loads(pipes, tmp_path):
    """An embed engine of the residual pipeline says so in its metadata
    and equals the eager embedder; an engine of the calibrated pipeline
    refuses a residual one, and the other way round (facekit's
    ``_check_meta``)."""
    crops = torch.tensor(_crops(8, 1))
    dirs = {}
    for name, pipe in pipes.items():
        program, meta = export_embed_engine(pipe, 1)
        assert meta["rec_int8_residual"] == (name == "residual")
        assert meta["rec_calibrated"]
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        save_engine(str(dirs[name] / "embed.fke"), program, meta)
        with torch.inference_mode():
            got = program.module()(pipe.rec_net.state_dict(), crops)
        assert torch.equal(got, pipe._embed(crops))
    res, cal = pipes["residual"], pipes["calibrated"]
    with pytest.raises(ValueError, match="rec_int8_residual=False"):
        load_serving_engines(str(dirs["calibrated"]), res.config, res, [1])
    with pytest.raises(ValueError, match="rec_int8_residual=True"):
        load_serving_engines(str(dirs["residual"]), cal.config, cal, [1])
    # with its own pipeline the residual engine passes every check and
    # lacks only the recognize program of its bucket
    with pytest.raises(ValueError, match="no engine pair"):
        load_serving_engines(str(dirs["residual"]), res.config, res, [1])


def test_residual_flag_waits_for_calibration():
    """The flag is read by the calibration only: until then the pipeline
    serves dynamic int8 (the server refuses such a config instead,
    ``tests/test_torch_server.py``)."""
    cfg = FaceKitConfig(**_CFG, extras={"rec_int8Residual": True})
    pipe = FacePipeline(cfg, random_arcface_params(NET, seed=4),
                        device="cpu")
    assert pipe.rec_net.int8 == "dynamic"
    pipe.calibrate_embedder([_crops(7, 4)])
    assert pipe.rec_net.int8 == "residual"
