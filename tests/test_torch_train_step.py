"""facekit_torch's train step against facekit's (``facekit/train/step.py``)
on the same param tree, head and batch.

The network is ``ir_tiny2``, stage units (2, 1, 1, 1), put into both
packages' ``ARCFACE_STAGE_UNITS`` for this file only: unlike ``ir_tiny``
its block 1 is a stride-1 identity block, the kind ``IRBlock.forward``
sends to the fused kernel when nothing needs a gradient.

Tolerances, set from the f32 noise floor: against a float64 run of the
port's step on this batch (loss near 35), facekit's f32 gradients lie up
to 8e-5 (norm-relative, per leaf) and the port's up to 2.8e-4 on
PyTorch's default CPU convs (oneDNN), 4.6e-4 on its native ones; with
the BN statistics drawn at random (``random_arcface_params``) the
port's reached 2.1e-3. So f32 gradients (the momentum after one step)
and each leaf's update (new minus initial value) are held to 5e-3 per
leaf; the loss to 1e-5 relative. bf16 rounds each
activation to 8 bits; both packages' bf16 gradients lie up to about 10%
from f32 in the first blocks, so the port's bf16 step is held to
facekit's bf16 step at 0.25 per leaf and 0.1 over all leaves, the loss at
1e-3.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import facekit.models.arcface as JA
import facekit_torch.models.arcface as TA
from facekit.train import TrainState as FkTrainState
from facekit.train import make_optimizer as fk_make_optimizer
from facekit.train import make_train_step as fk_make_train_step
from facekit_torch.ops.ir_block import ir_block, needs_grad
from facekit_torch.train import (make_optimizer, make_train_step,
                                 train_state_init,
                                 warmup_cosine_decay_schedule)
from facekit_torch.weights import to_jax
from facekit_torch.weights.bridge import _flatten

NET = "ir_tiny2"
C, B = 8, 4


@contextlib.contextmanager
def _ir_tiny2():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JA, TA):
            mp.setitem(mod.ARCFACE_STAGE_UNITS, NET, (2, 1, 1, 1))
        yield


@pytest.fixture(autouse=True)
def ir_tiny2():
    with _ir_tiny2():
        yield


def _batch(seed=160):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 112, 112, 3)).astype(np.float32)
    return x, np.array([0, 1, 2, 3], np.int32)


def _flat(tree):
    out = {}
    _flatten(jax.device_get(tree), "", out)
    return out


def _fk_momentum(opt_state):
    """facekit's momentum (optax ``trace``) of (params, head)."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "trace")):
        if hasattr(node, "trace"):
            return node.trace
    raise AssertionError("no trace in the optimizer state")


def _run_facekit(steps, compute_dtype=jnp.float32, **kw):
    """facekit's state after ``steps`` steps from the port's initial
    params and head, its losses, and the port's initial state."""
    state = train_state_init(C, NET, lr=0.1, seed=3, device="cpu", **kw)
    params = jax.tree.map(jnp.asarray, to_jax(state.params))
    head = {"w": jnp.asarray(state.head["w"].numpy())}
    fk = FkTrainState(params, head,
                      fk_make_optimizer(0.1, **kw).init((params, head)),
                      jnp.zeros((), jnp.int32))
    step = fk_make_train_step(NET, lr=0.1, compute_dtype=compute_dtype, **kw)
    x, y = _batch()
    losses = []
    for _ in range(steps):
        fk, loss = step(fk, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return fk, losses, state


@pytest.fixture(scope="module")
def fk_f32():
    with _ir_tiny2():
        return _run_facekit(1)


@pytest.fixture(scope="module")
def fk_bf16():
    with _ir_tiny2():
        return _run_facekit(1, jnp.bfloat16)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_momentum(state, fk, per_leaf, overall):
    ref = _fk_momentum(fk.opt_state)
    ref_p, ref_h = _flat(ref[0]), np.asarray(ref[1]["w"])
    ours = _flatten_port(state.momentum["params"])
    assert set(ours) == set(ref_p)
    worst = max((_rel(ours[k], ref_p[k]), k) for k in ref_p)
    assert worst[0] <= per_leaf, worst
    allo = np.concatenate([ours[k].ravel() for k in ref_p])
    allr = np.concatenate([ref_p[k].ravel() for k in ref_p])
    assert _rel(allo, allr) <= overall
    assert _rel(state.momentum["head"]["w"].numpy(), ref_h) <= per_leaf


def _flatten_port(leaves):
    return _flat(to_jax(leaves))


def _check_updates(state, new, fk, tol):
    """Every leaf's update (BN mean and var among them) and the head's,
    norm-relative to facekit's, within ``tol``."""
    p0, ref, ours = (_flatten_port(state.params), _flat(fk.params),
                     _flatten_port(new.params))
    assert set(ours) == set(ref) == set(p0)
    assert any(k.endswith("bn1.mean") for k in ref)
    worst = max((_rel(ours[k] - p0[k], ref[k] - p0[k]), k) for k in ref)
    assert worst[0] <= tol, worst
    h0 = state.head["w"].numpy()
    assert _rel(new.head["w"].numpy() - h0,
                np.asarray(fk.head["w"]) - h0) <= tol


def test_one_f32_step_matches_facekit(fk_f32):
    """Loss, every updated leaf (BN mean and var included) and the
    momentum buffers after one f32 step."""
    fk, losses, state = fk_f32
    new, loss = make_train_step(NET, lr=0.1)(state, *_batch())
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-5)
    assert new.step == 1 and int(fk.step) == 1
    _check_updates(state, new, fk, 5e-3)
    _check_momentum(new, fk, 5e-3, 5e-3)
    # the state given to the step is left as it was
    assert not any(torch.equal(new.params[k], state.params[k])
                   for k in state.params)
    assert all(float(v.abs().max()) == 0
               for v in state.momentum["params"].values())


def test_fused_block_leaves_get_gradients(monkeypatch):
    """Block 1 of ir_tiny2 is fusable, but a step runs it op by op: the
    wrapper is never called, and every leaf of that block (and of the
    network) gets a non-zero gradient; BN statistics are leaves."""
    state = train_state_init(C, NET, seed=3, device="cpu")
    assert TA.ArcFace(NET).blocks[1].fusable()
    calls = []
    monkeypatch.setattr(TA, "ir_block",
                        lambda *a: calls.append(1) or ir_block(*a))
    new, _ = make_train_step(NET, lr=0.1)(state, *_batch())
    assert not calls
    block1 = [k for k in new.momentum["params"] if k.startswith("blocks.1.")]
    assert {"blocks.1.bn1.mean", "blocks.1.bn2.var", "blocks.1.conv1",
            "blocks.1.prelu"} <= set(block1)
    zero = [k for k, g in new.momentum["params"].items()
            if float(g.abs().max()) == 0]
    assert not zero, zero


def test_ir_block_refuses_grad_mode():
    """``ir_block`` with grad mode on and a weight requiring grad raises;
    under ``no_grad`` it runs; a forward that needs no gradient fuses."""
    blk = TA.IRBlock(64, 64, 1, se=False).eval()
    x = torch.randn((1, 7, 7, 64), generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no backward"):
        ir_block(x, blk)
    with torch.no_grad():
        out = ir_block(x, blk)
    assert out.shape == x.shape
    assert needs_grad(x, blk)
    with torch.inference_mode():
        assert not needs_grad(x, blk)


def test_cosine_schedule_with_weight_decay_matches_facekit():
    """Three steps of warmup-cosine with weight decay 5e-4: the port's lr
    per update is optax's (to f32 rounding, 1e-6 relative), the first
    update's lr is 0, rank-1 leaves take no decay, and the params after
    three steps match facekit's."""
    kw = dict(weight_decay=5e-4, schedule="cosine", warmup_steps=1,
              total_steps=4)
    fk, losses, state = _run_facekit(3, **kw)
    step = make_train_step(NET, lr=0.1, **kw)
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.1, 1, 4)
    lrs = [step.optimizer.lr(i) for i in range(6)]
    np.testing.assert_allclose(lrs, [float(sched(i)) for i in range(6)],
                               rtol=1e-6, atol=1e-9)
    assert lrs[0] == 0.0
    x, y = _batch()
    ours, start = [], state
    for _ in range(3):
        state, loss = step(state, x, y)
        ours.append(float(loss))
    np.testing.assert_allclose(ours, losses, rtol=1e-5)
    _check_updates(start, state, fk, 5e-3)


def test_weight_decay_mask():
    """Zero gradients at constant lr: rank >= 2 leaves move by
    -lr * wd * p, rank-1 leaves (BN, PReLU) not at all."""
    opt = make_optimizer(0.1, weight_decay=5e-4)
    params = [torch.ones(3, 3, 3, 3), torch.ones(4), torch.ones(2, 5)]
    new, bufs = opt.update(params, [torch.zeros_like(p) for p in params],
                           [torch.zeros_like(p) for p in params], 0)
    np.testing.assert_allclose(new[0].numpy(), 1 - 0.1 * 5e-4, rtol=1e-7)
    assert torch.equal(new[1], params[1])
    np.testing.assert_allclose(new[2].numpy(), 1 - 0.1 * 5e-4, rtol=1e-7)
    assert float(bufs[0][0, 0, 0, 0]) == pytest.approx(5e-4)
    with pytest.raises(ValueError, match="total_steps"):
        make_optimizer(0.1, schedule="cosine")
    with pytest.raises(ValueError, match="decay_steps"):
        warmup_cosine_decay_schedule(0.0, 0.1, 4, 4)


def test_bf16_step_matches_facekit_and_remat(fk_bf16):
    """The bf16 recipe: masters, momentum and head stay f32; the loss and
    the gradients lie within the bf16 tolerance of facekit's bf16 step;
    ``remat=True`` gives the same step as ``remat=False``, bit for bit."""
    fk, losses, state = fk_bf16
    x, y = _batch()
    new, loss = make_train_step(NET, lr=0.1,
                                compute_dtype=torch.bfloat16)(state, x, y)
    assert all(v.dtype == torch.float32 for v in new.params.values())
    assert all(v.dtype == torch.float32
               for v in new.momentum["params"].values())
    assert new.head["w"].dtype == torch.float32
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-3)
    _check_momentum(new, fk, 0.25, 0.1)
    re, re_loss = make_train_step(NET, lr=0.1, remat=True,
                                  compute_dtype=torch.bfloat16)(state, x, y)
    assert torch.equal(re_loss, loss)
    for k in new.params:
        assert torch.equal(re.params[k], new.params[k]), k
        assert torch.equal(re.momentum["params"][k],
                           new.momentum["params"][k]), k


def test_ir50_step_reaches_every_leaf():
    """One IR-50 step at batch 2 (its 20 fusable blocks among them): every
    leaf of the backbone and the head gets a non-zero gradient, and the
    loss is finite."""
    state = train_state_init(4, "ir_50", seed=5, device="cpu")
    x = np.random.default_rng(5).normal(size=(2, 112, 112, 3)).astype(
        np.float32)
    new, loss = make_train_step("ir_50", lr=0.1)(state, x, np.array([0, 1]))
    assert np.isfinite(float(loss))
    assert len(new.momentum["params"]) == len(state.params)
    zero = [k for k, g in new.momentum["params"].items()
            if float(g.abs().max()) == 0]
    assert not zero, zero
    assert float(new.momentum["head"]["w"].abs().max()) > 0
