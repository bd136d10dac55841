"""facekit_torch's layers, ArcFace and parameter bridge against facekit's.

The same parameters, drawn from a seed with numpy, go to both packages
(facekit takes the pytree as is, the port through ``from_jax``). f32 must
agree to float tolerance (atol 1e-5 at ir_tiny, 1e-4 at IR-50); bf16
within facekit's own 1e-3 cosine bar (BASELINE.json north star).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.models import layers as JL
from facekit.models.arcface import arcface_apply, arcface_init
from facekit.weights import save_params
from facekit_torch.models import ArcFace
from facekit_torch.models import layers as TL
from facekit_torch.weights import from_jax, load_params, random_arcface_params


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(ours, ref, atol=1e-5):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("stride,padding,bias,groups", [
    (1, 1, False, 1), (2, 1, False, 1), (2, 0, False, 1), (1, 1, True, 1),
    (1, 1, False, 4)])
def test_conv2d_matches(rng, stride, padding, bias, groups):
    x = rng.normal(size=(2, 9, 10, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8 // groups, 12)).astype(np.float32)  # HWIO
    b = rng.normal(size=(12,)).astype(np.float32) if bias else None
    ref = JL.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                    padding=padding, groups=groups,
                    bias=None if b is None else jnp.asarray(b))
    ours = TL.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), stride=stride,
                     padding=padding, groups=groups,
                     bias=None if b is None else _t(b))
    _close(ours, ref)


def test_biased_bf16_conv_rounds_once(rng):
    x = rng.normal(size=(1, 6, 6, 16)).astype(np.float32)
    w = rng.normal(size=(3, 3, 16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    ref = JL.conv2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), padding=1,
                    bias=jnp.asarray(b))
    ours = TL.conv2d(_t(x).to(torch.bfloat16), _t(w.transpose(3, 2, 0, 1)),
                     padding=1, bias=_t(b))
    assert ours.dtype == torch.bfloat16
    # the f32 sums differ in order only; one bf16 rounding of nearly equal
    # sums lands on the same or the neighbouring bf16 value
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_prelu_linear_match(rng, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 16), "bias": rng.normal(size=16),
         "mean": rng.normal(size=16), "var": rng.uniform(0.5, 1.5, 16)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    alpha = rng.uniform(0, 0.5, 16).astype(np.float32)
    xj, xt = jnp.asarray(x, jd), _t(x).to(td)
    atol = 1e-5 if dtype == "float32" else 2e-2
    _close(TL.batch_norm(xt, *(_t(p[k]) for k in ("scale", "bias", "mean",
                                                  "var"))),
           JL.batch_norm(xj, {k: jnp.asarray(v) for k, v in p.items()}), atol)
    _close(TL.prelu(xt, _t(alpha)), JL.prelu(xj, jnp.asarray(alpha)), atol)
    _close(TL.strided_identity(xt, 2), JL.strided_identity(xj, 2), 0)
    v = rng.normal(size=(3, 40)).astype(np.float32)
    w = rng.normal(size=(7, 40)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    lin = TL.linear(_t(v).to(td), _t(w), _t(b))
    assert lin.dtype == td
    ref = JL.linear(jnp.asarray(v, jd), jnp.asarray(w), jnp.asarray(b))
    # bf16: one rounding of f32 sums that differ in order only
    np.testing.assert_allclose(lin.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0 if dtype == "float32" else 2 ** -7,
                               atol=1e-4 if dtype == "float32" else 0)


def _arcface_pair(network, seed=0):
    params = random_arcface_params(network, seed=seed)
    net = ArcFace(network)
    net.load_state_dict(from_jax(params, net))
    return params, net.eval()


def _embed(net, x):
    with torch.inference_mode():
        return net(torch.tensor(x)).numpy()


@pytest.mark.parametrize("network", ["ir_tiny", "ir_se_tiny"])
def test_arcface_f32_matches(network):
    params, net = _arcface_pair(network)
    x = np.random.default_rng(1).uniform(-1, 1, (3, 112, 112, 3)) \
        .astype(np.float32)
    ref = np.asarray(arcface_apply(params, jnp.asarray(x), network=network,
                                   dtype=jnp.float32))
    ours = _embed(net, x)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-5)


def test_arcface_bf16_within_cosine_bar():
    params, net = _arcface_pair("ir_tiny")
    x = np.random.default_rng(2).uniform(-1, 1, (4, 112, 112, 3)) \
        .astype(np.float32)
    ref_f32 = np.asarray(arcface_apply(params, jnp.asarray(x),
                                       network="ir_tiny", dtype=jnp.float32))
    ref_bf16 = np.asarray(arcface_apply(params, jnp.asarray(x),
                                        network="ir_tiny",
                                        dtype=jnp.bfloat16))
    ours = _embed(net.set_compute_dtype(torch.bfloat16), x)
    assert net.input.conv.dtype == torch.bfloat16
    assert net.input.bn.scale.dtype == torch.float32
    for ref in (ref_f32, ref_bf16):
        assert (1 - (ours * ref).sum(-1)).max() < 1e-3


def test_arcface_ir50_f32_batch1_matches():
    """IR-50 runs its 20 stride-1 identity blocks through ``ops.ir_block``
    (the fused block's plain version on the CPU): f32 within 1e-4 of
    facekit's op-by-op forward, and the port's bf16 forward within the
    1e-3 cosine bar of that same f32 reference."""
    params, net = _arcface_pair("ir_50", seed=5)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 112, 112, 3)) \
        .astype(np.float32)
    ref = np.asarray(arcface_apply(params, jnp.asarray(x), network="ir_50",
                                   dtype=jnp.float32))
    np.testing.assert_allclose(_embed(net, x), ref, rtol=0, atol=1e-4)
    ours_bf16 = _embed(net.set_compute_dtype(torch.bfloat16), x)
    assert (1 - (ours_bf16 * ref).sum(-1)).max() < 1e-3


def test_from_jax_takes_facekit_init_and_msgpack(tmp_path):
    """A tree from facekit's own init (lists, jax arrays) and the msgpack
    file facekit writes from it carry over to the same state_dict."""
    import jax
    tree = arcface_init(jax.random.PRNGKey(0), network="ir_tiny")
    path = str(tmp_path / "rec.msgpack")
    save_params(tree, path)
    net = ArcFace("ir_tiny")
    direct = from_jax(tree, net)
    loaded = from_jax(load_params(path), net)
    assert direct.keys() == loaded.keys() == net.state_dict().keys()
    for key in direct:
        assert torch.equal(direct[key], loaded[key]), key
    # HWIO -> OIHW
    np.testing.assert_array_equal(
        direct["blocks.0.conv1"].numpy(),
        np.asarray(tree["blocks"][0]["conv1"]).transpose(3, 2, 0, 1))


def test_load_params_reads_bf16_leaves(tmp_path):
    tree = {"a": jnp.asarray([[1.5, -2.25]], jnp.bfloat16),
            "b": [jnp.arange(3, dtype=jnp.float32)]}
    path = str(tmp_path / "p.msgpack")
    save_params(tree, path)
    got = load_params(path)
    np.testing.assert_array_equal(got["a"], [[1.5, -2.25]])
    np.testing.assert_array_equal(got["b"]["0"], [0, 1, 2])


def test_from_jax_refuses_mismatched_trees():
    params = random_arcface_params("ir_tiny")
    net = ArcFace("ir_tiny")
    del params["output"]["bn1d"]
    with pytest.raises(ValueError, match="missing"):
        from_jax(params, net)
    params = random_arcface_params("ir_tiny")
    params["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unused"):
        from_jax(params, net)
    with pytest.raises(ValueError, match="does not fit"):
        from_jax(random_arcface_params("ir_tiny", embed_dim=256), net)
