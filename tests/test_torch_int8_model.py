"""facekit_torch's int8 ArcFace against facekit's, on the CPU at ir_tiny.

The same float parameters, drawn from a seed with numpy, go to both
packages; each quantizes them its own way (``quantize_arcface`` /
``quantize_arcface_params``). Quantized trees must carry over bit for bit;
fed facekit's own activations, every int8 conv site must give facekit's
output bit for bit; end to end, embeddings must agree within the stated
cosine distances; the calibration forward must record the same sites;
and, as in facekit, an embedding must not depend on its batch neighbours.

Why the f32 end-to-end bar is 1e-4 and not tighter: the two packages'
float batch-norm differs in the last bit on some elements (XLA's CPU
``rsqrt`` is not correctly rounded, and XLA contracts ``x * s + b`` into
an FMA). Where such a 1-ulp difference straddles a rounding boundary of
the next activation quantization it becomes a whole int8 step, and the
steps compound block by block. Measured at ir_tiny over seeds 3, 5 and 8:
1.8e-5 to 6.7e-5 dynamic, 3.5e-5 to 6.8e-5 calibrated, against 2.3e-4 to
3.1e-4 between the int8 and the float embedder.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.models import layers as JL
from facekit.models.arcface import (arcface_act_amax as jax_act_amax,
                                    arcface_apply,
                                    calibrate_arcface_int8 as jax_calibrate,
                                    quantize_arcface_params)
from facekit_torch.models import ArcFace, block_specs
from facekit_torch.models import layers as TL
from facekit_torch.models.arcface import (QConv, arcface_act_amax,
                                          calibrate_arcface_int8,
                                          quantize_arcface)
from facekit_torch.weights import from_jax, random_arcface_params

NET = "ir_tiny"
HEADROOM = 1.25


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
    calib = [rng.uniform(-1, 1, (3, 112, 112, 3)).astype(np.float32)
             for _ in range(2)]
    return x, calib


@pytest.fixture(scope="module")
def calibrated_trees(params, data):
    """facekit's tree calibrated from the test's calibration batches."""
    _, calib = data
    return jax_calibrate(params, [jnp.asarray(c) for c in calib], network=NET,
                         headroom=HEADROOM)


def _embed(net, x):
    with torch.inference_mode():
        return net(torch.tensor(x)).float().numpy()


def _cos_dist(a, b):
    return float((1 - (a * b).sum(-1)).max())


def test_quantize_arcface_carries_facekit_tree_bit_for_bit(params,
                                                            float_net):
    """quantize_arcface's sites equal quantize_arcface_params' leaves
    carried over by from_jax, and the int8 weight stays int8 all the way
    (no float round trip)."""
    tree = quantize_arcface_params(params)
    net = ArcFace(NET, int8="dynamic")
    carried = from_jax(tree, net)
    assert carried["blocks.0.conv1.q"].dtype == torch.int8
    assert carried["blocks.0.conv1.scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        carried["blocks.3.shortcut.conv.q"].numpy(),
        np.asarray(tree["blocks"][3]["shortcut"]["conv"]["q"])
        .transpose(3, 2, 0, 1))
    ours = quantize_arcface(float_net).state_dict()
    assert ours.keys() == carried.keys()
    for key, value in carried.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key], value), key
    net.load_state_dict(carried)
    # the int8 weight is stored channels-last: its (O, KH, KW, I) view is
    # what the kernel reads, without a copy
    assert net.blocks[0].conv1.q.permute(0, 2, 3, 1).is_contiguous()


def test_from_jax_takes_calibrated_tree(params, calibrated_trees):
    net = ArcFace(NET, int8="static")
    carried = from_jax(calibrated_trees, net)
    for i, blk in enumerate(calibrated_trees["blocks"]):
        a = carried[f"blocks.{i}.conv2.ascale"]
        assert a.dtype == torch.float32 and a.shape == ()
        assert a.numpy().tobytes() == np.asarray(blk["conv2"]["ascale"]) \
            .tobytes()
    assert carried["input.conv.ascale"].numpy().tobytes() == np.asarray(
        calibrated_trees["input"]["conv"]["ascale"]).tobytes()
    with pytest.raises(ValueError, match="missing"):
        from_jax(calibrated_trees, ArcFace(NET, int8="dynamic"))
    with pytest.raises(ValueError, match="unused"):
        from_jax(quantize_arcface_params(params), ArcFace(NET, int8="static"))
    with pytest.raises(ValueError, match="dtype"):
        bad = quantize_arcface_params(params)
        bad["input"]["conv"]["q"] = np.asarray(bad["input"]["conv"]["q"],
                                               np.float32)
        from_jax(bad, ArcFace(NET, int8="dynamic"))


def test_every_conv_site_equals_facekit_on_its_inputs(params, float_net,
                                                      data):
    """Each int8 conv site, fed the activation facekit's forward gives it,
    returns facekit's output bit for bit (f32, dynamic scales): the stem,
    conv1, conv2 and the shortcut convs of every block."""
    x, _ = data
    tree = quantize_arcface_params(params)
    net = quantize_arcface(float_net)
    sites = []

    def site(h, leaf, qconv, stride, pad):
        ref = JL.conv2d_int8(h, leaf["q"], leaf["scale"], stride=stride,
                             padding=pad)
        ours = TL.conv2d_int8(torch.tensor(np.asarray(h)), qconv.q,
                              qconv.scale, stride=stride, padding=pad)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        sites.append(ref.shape)
        return ref

    h = site(jnp.asarray(x), tree["input"]["conv"], net.input.conv, 1, 1)
    h = JL.prelu(JL.batch_norm(h, tree["input"]["bn"]),
                 tree["input"]["prelu"])
    for (_, _, stride), p, blk in zip(block_specs(NET), tree["blocks"],
                                      net.blocks):
        if "shortcut" in p:
            sc = JL.batch_norm(site(h, p["shortcut"]["conv"],
                                    blk.shortcut.conv, stride, 0),
                               p["shortcut"]["bn"])
        else:
            sc = JL.strided_identity(h, stride)
        r = site(JL.batch_norm(h, p["bn1"]), p["conv1"], blk.conv1, 1, 1)
        r = site(JL.prelu(r, p["prelu"]), p["conv2"], blk.conv2, stride, 1)
        h = JL.batch_norm(r, p["bn2"]) + sc
    assert len(sites) == 1 + 2 * 4 + 3


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-4),
                                       ("bfloat16", 1e-3)])
def test_int8_embedder_matches_facekit(params, float_net, data, dtype, bar):
    """End to end (see the module docstring for the f32 bar). Measured on
    the CPU at seed 3: f32 5.3e-5, bf16 4.1e-4."""
    x, _ = data
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(arcface_apply(quantize_arcface_params(params),
                                   jnp.asarray(x), network=NET, dtype=jd),
                     np.float32)
    net = quantize_arcface(float_net).set_compute_dtype(getattr(torch, dtype))
    ours = _embed(net, x)
    assert _cos_dist(ours, ref) <= bar, _cos_dist(ours, ref)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-5)


def test_calibrated_embedder_matches_facekit(float_net, data,
                                             calibrated_trees):
    """Both packages calibrate from the same batches (headroom 1.25).
    Measured cosine distance on the CPU at seed 3: 3.9e-5 (the bar as for
    dynamic f32, see the module docstring)."""
    x, calib = data
    ref = np.asarray(arcface_apply(calibrated_trees, jnp.asarray(x),
                                   network=NET, dtype=jnp.float32))
    net = calibrate_arcface_int8(float_net, [torch.tensor(c) for c in calib],
                                 headroom=HEADROOM)
    assert net.int8 == "static"
    assert all(isinstance(m.conv1, QConv) and m.conv1.ascale is not None
               for m in net.blocks)
    ours = _embed(net, x)
    assert _cos_dist(ours, ref) <= 1e-4, _cos_dist(ours, ref)


def test_act_amax_sites_match_facekit(params, float_net, data):
    x, _ = data
    ref = {k: float(v) for k, v in
           jax_act_amax(params, jnp.asarray(x), network=NET).items()}
    ours = arcface_act_amax(float_net, torch.tensor(x))
    assert set(ours) == set(ref)
    assert {"input", "stem.out", "b0.conv1", "b0.conv2", "b0.out",
            "b1.shortcut"} <= set(ours)
    for k in ref:
        assert abs(ours[k] - ref[k]) <= 1e-6 * abs(ref[k]), k


def test_int8_embedder_is_batch_invariant(float_net, data):
    """Per-sample dynamic scales and an exact integer conv: replacing one
    batch neighbour with a 50x louder face leaves the others' embeddings
    bit-identical (facekit's tests/test_model_parity.py:178-197)."""
    x, _ = data
    y = x.copy()
    y[0] *= 50.0
    net = quantize_arcface(float_net)
    e_x, e_y = _embed(net, x), _embed(net, y)
    np.testing.assert_array_equal(e_x[1:], e_y[1:])


def test_quantize_and_stats_need_the_float_f32_model(float_net):
    qnet = quantize_arcface(float_net)
    with pytest.raises(ValueError, match="float f32"):
        quantize_arcface(qnet)
    with pytest.raises(ValueError, match="float f32"):
        arcface_act_amax(qnet, torch.zeros(1, 112, 112, 3))
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_arcface_int8(float_net, [])
