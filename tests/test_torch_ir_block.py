"""Kernel #3: the port's fused IR block against facekit's.

The plain version ``ir_block_reference`` is held against the TPU kernel
``ir_block_fused`` (``docs/experiments/fused_block_kernel.py``) run in
Pallas interpret mode, and the wrapper ``ir_block`` against facekit's
op-by-op IR block (``_block_apply``), on the same inputs drawn with numpy.
Small widths of each IR-50 shape class, n = 2.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.models.arcface import _block_apply
from facekit_torch.models.arcface import ArcFace, IRBlock
from facekit_torch.ops.ir_block import (_ir_block_cuda, block_operands,
                                        fused_affine, ir_block,
                                        ir_block_reference)
from facekit_torch.weights import from_jax, random_arcface_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (H, W, C): the four IR-50 classes (56x56x64 ... 7x7x512) at small widths
SHAPES = [(14, 14, 32), (7, 7, 64), (9, 6, 16)]


def _kernel3_script():
    spec = importlib.util.spec_from_file_location(
        "fused_block_kernel",
        os.path.join(REPO, "docs", "experiments", "fused_block_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bn(rng, c):
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
            "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _block_params(rng, c):
    a = np.sqrt(6.0 / (18 * c))
    return {"bn1": _bn(rng, c),
            "conv1": rng.uniform(-a, a, (3, 3, c, c)).astype(np.float32),
            "prelu": rng.uniform(0.1, 0.4, c).astype(np.float32),
            "conv2": rng.uniform(-a, a, (3, 3, c, c)).astype(np.float32),
            "bn2": _bn(rng, c)}


def _operands(p, dtype):
    """The port's (w1, w2, par) from a facekit block tree."""
    t = {k: torch.tensor(v) for k, v in p["bn1"].items()}
    s1, b1 = fused_affine(t["scale"], t["bias"], t["mean"], t["var"])
    t = {k: torch.tensor(v) for k, v in p["bn2"].items()}
    s2, b2 = fused_affine(t["scale"], t["bias"], t["mean"], t["var"])
    par = torch.stack([s1, b1, torch.tensor(p["prelu"]), s2, b2])
    # HWIO -> (O, 3, 3, I)
    w1 = torch.tensor(p["conv1"].transpose(3, 0, 1, 2).copy()).to(dtype)
    w2 = torch.tensor(p["conv2"].transpose(3, 0, 1, 2).copy()).to(dtype)
    return w1, w2, par


def _bf16_tol(ref):
    """Two bf16 ulps of each output's magnitude, plus 2**-9 for outputs
    near 0: both sides round u and the output to bf16 once, from f32 sums
    taken in another order, so either rounding can land one bf16 step
    apart, and a step of u moves the output by less than a step of it."""
    return 2.0 ** -6 * np.abs(ref) + 2.0 ** -9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,c", SHAPES)
def test_plain_matches_ir_block_fused_interpret(h, w, c, dtype):
    """f32 within atol 1e-5 (facekit recorded 3e-6 for the kernel against
    XLA's block); bf16 within two bf16 ulps (``_bf16_tol``)."""
    m = _kernel3_script()
    rng = np.random.default_rng(h * 100 + c)
    p = _block_params(rng, c)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(m.ir_block_fused(jnp.asarray(x, jd), p, interpret=True),
                     np.float32)
    w1, w2, par = _operands(p, td)
    ours = ir_block_reference(torch.tensor(x).to(td), w1, w2, par)
    assert ours.dtype == td and ours.shape == (2, h, w, c)
    ours = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    else:
        assert (np.abs(ours - ref) <= _bf16_tol(ref)).all(), \
            np.abs(ours - ref).max()


def _port_block(p, c):
    blk = IRBlock(c, c, 1, se=False)
    blk.load_state_dict(from_jax(p, blk))
    return blk.eval()


@pytest.mark.parametrize("h,w,c", SHAPES)
def test_wrapper_matches_facekit_block(h, w, c):
    """``ir_block`` on CPU tensors (the plain version, no launch) against
    facekit's op-by-op ``_block_apply`` in f32: the two differ only in the
    BN shift's product order and in where the f32 sums round, so atol
    1e-5."""
    rng = np.random.default_rng(c)
    p = _block_params(rng, c)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    ref = np.asarray(_block_apply(jnp.asarray(x), p, stride=1))
    blk = _port_block(p, c)
    before = ir_block.launches
    with torch.inference_mode():
        ours = blk(torch.tensor(x))
    assert ir_block.launches == before
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_calibration_forward_keeps_the_composition():
    """With ``stats`` the block runs op by op and records the amax of each
    inner conv's input, which a fused kernel never holds; its output is
    the fused one's within f32 tolerance."""
    rng = np.random.default_rng(3)
    p = _block_params(rng, 32)
    blk = _port_block(p, 32)
    x = torch.tensor(rng.normal(size=(2, 7, 7, 32)).astype(np.float32))
    stats = {}
    with torch.inference_mode():
        composed = blk(x, stats=stats, prefix="b")
        fused = blk(x)
    assert set(stats) == {"b.conv1", "b.conv2", "b.out"}
    np.testing.assert_allclose(composed.numpy(), fused.numpy(), atol=1e-5)


def test_which_blocks_fuse():
    """IR-50: the 20 stride-1 identity blocks; IR-SE and int8 blocks and
    the 4 stride-2 blocks keep the composition."""
    net = ArcFace("ir_50")
    assert [b.fusable() for b in net.blocks].count(True) == 20
    assert not any(b.fusable() for b in ArcFace("ir_se_50").blocks)
    assert not any(b.fusable() for b in ArcFace("ir_50",
                                                int8="dynamic").blocks)
    assert not any(b.fusable() for b in ArcFace("ir_tiny").blocks)


def test_operands_follow_the_weights():
    """``block_operands`` caches (w1, w2, par) on the block and rebuilds
    them when a weight is replaced or edited in place, or the dtype
    changes."""
    rng = np.random.default_rng(4)
    blk = _port_block(_block_params(rng, 16), 16)
    w1, w2, par = block_operands(blk, torch.float32)
    assert w1.shape == (16, 3, 3, 16) and par.shape == (5, 16)
    assert block_operands(blk, torch.float32)[0] is w1
    with torch.no_grad():
        blk.conv1.mul_(2)
    np.testing.assert_allclose(block_operands(blk, torch.float32)[0].numpy(),
                               2 * w1.numpy())
    with torch.no_grad():
        blk.bn2.var.fill_(4.0)
    assert torch.allclose(block_operands(blk, torch.float32)[2][3],
                          blk.bn2.scale / 2)
    assert block_operands(blk, torch.bfloat16)[1].dtype == torch.bfloat16


def test_kernel_path_refuses_cpu_tensors():
    rng = np.random.default_rng(5)
    w1, w2, par = _operands(_block_params(rng, 64), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        _ir_block_cuda(torch.zeros((1, 7, 7, 64)), w1, w2, par)


def test_ir50_blocks_through_the_plain_version(monkeypatch):
    """A float IR-50 forward on the CPU sends its 20 identity blocks
    through ``ir_block`` (plain version, no launch) and stays finite and
    normalized."""
    import facekit_torch.models.arcface as arcface_mod
    params = random_arcface_params("ir_50", seed=9)
    net = ArcFace("ir_50")
    net.load_state_dict(from_jax(params, net))
    calls = []

    def spy(x, block):
        calls.append(tuple(x.shape))
        return ir_block(x, block)

    monkeypatch.setattr(arcface_mod, "ir_block", spy)
    before = ir_block.launches
    with torch.inference_mode():
        emb = net.eval()(torch.zeros((1, 112, 112, 3)))
    assert ir_block.launches == before
    assert sorted(set(calls)) == [(1, 7, 7, 512), (1, 14, 14, 256),
                                  (1, 28, 28, 128), (1, 56, 56, 64)]
    assert len(calls) == 20
    assert torch.isfinite(emb).all()
    np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, atol=1e-5)
