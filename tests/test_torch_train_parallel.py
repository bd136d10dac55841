"""facekit_torch's data-parallel train step with the class-split head
(``train_shardings``, ``place_state``, ``make_train_step(mesh=)``)
against the port's single-device step and facekit's
``test_train_step_dp_tp`` setup (``tests/test_parallel.py:52-79``):
ir_tiny, 64 classes, lr 0.02, batch 8, on ``{"data": 4, "model": 2}``
(the port's mesh puts torch's one CPU device at all 8 positions,
facekit's is 8 virtual XLA CPU devices).

Tolerances. Each data position runs the backbone on its slice of 2, so
the mesh step sums its gradients in another order than the
single-device step. Run in float64, the two agree to the last bits:
losses within 7.9e-16 relative and every leaf's update and momentum
within 7.8e-14 norm-relative over three steps (CPU readings), held at
1e-12 and 1e-10. In f32 this setup amplifies that rounding from step
to step (the loss goes 36 -> 27 -> 36; the single-device f32 step
itself lies 2.3e-4, 5.4e-4 and 1.1e-3 from its float64 run after steps
1, 2 and 3): mesh against single reads 3.3e-5, 2.4e-4 and 1.2e-3 (worst
leaf, update or momentum) and losses 0, 0 and 8.2e-6 relative, held at
1e-4, 1e-3 and 5e-3, and 1e-5, 1e-5 and 3e-5. A mesh step with a
fault reads far above either: with the head blocks' label columns not
offset, 9.4e-2 after one step; with every head block given block 0's
gradient, 0.74 after two (float64, a scratch copy of the step).
Against facekit's mesh step the mesh step's losses read 1.1e-7, 4.6e-6
and 2.2e-5, its head update 2.2e-6, 6.5e-6 and 2.7e-5 and its worst
backbone leaf 7.0e-4, 9.4e-4 and 1.7e-3, held at the loss tolerances
above and at ``test_one_f32_step_matches_facekit``'s 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.parallel import make_mesh as jax_make_mesh
from facekit.train import TrainState as FkTrainState
from facekit.train import make_optimizer as fk_make_optimizer
from facekit.train import make_train_step as fk_make_train_step
from facekit.train import train_shardings as fk_train_shardings
from facekit_torch.parallel import (Replicated, ShardedRows, device_put,
                                    gather, make_mesh)
from facekit_torch.train import (make_train_step, place_state,
                                 train_shardings, train_state_init)
from facekit_torch.train.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
from facekit_torch.train.step import TrainState
from facekit_torch.weights import to_jax

C, B, LR, STEPS = 64, 8, 0.02, 3
AXES = {"data": 4, "model": 2}
LOSS_RTOL = {"float32": (1e-5, 1e-5, 3e-5), "float64": (1e-12,) * 3}
LEAF_TOL = {"float32": (1e-4, 1e-3, 5e-3), "float64": (1e-10,) * 3}
FK_LEAF_TOL = 5e-3


def _mesh():
    return make_mesh(AXES, devices=["cpu"] * 8)


def _batch():
    rng = np.random.default_rng(42)
    return (rng.normal(0, 1, size=(B, 112, 112, 3)).astype(np.float32),
            rng.integers(0, C, size=B).astype(np.int32))


def _state(dtype=torch.float32):
    s = train_state_init(C, "ir_tiny", lr=LR, seed=0, device="cpu")

    def cast(d):
        return {k: v.to(dtype) for k, v in d.items()}
    return TrainState(cast(s.params), cast(s.head),
                      {k: cast(v) for k, v in s.momentum.items()}, s.step)


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _run(dtype):
    """STEPS steps from one state: the single-device step's states and
    losses, and the mesh step's on a state placed by train_shardings and
    a batch placed by its batch shardings."""
    s0 = _state(dtype)
    x, y = _batch()
    single, placed = [], []
    step = make_train_step("ir_tiny", lr=LR, compute_dtype=dtype)
    mesh = _mesh()
    state_sh, (img_sh, lbl_sh) = train_shardings(s0, mesh)
    a, b = s0, place_state(s0, state_sh)
    xs = device_put(torch.tensor(x), img_sh)
    ys = device_put(torch.tensor(y), lbl_sh)
    for _ in range(STEPS):
        a, la = step(a, x, y)
        b, lb = step(b, xs, ys)
        single.append((a, float(la)))
        placed.append((b, float(lb)))
    return s0, single, placed


@pytest.fixture(scope="module")
def runs():
    return _run(torch.float32)


@pytest.fixture(scope="module")
def runs64():
    return _run(torch.float64)


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mesh_steps_equal_single_device(request, dtype, i):
    """Step i + 1 on the mesh: the loss, every backbone leaf's update (BN
    mean and var included), the head's, and every momentum buffer as the
    single-device step's (tolerances in the module docstring)."""
    s0, single, placed = request.getfixturevalue(
        "runs" if dtype == "float32" else "runs64")
    (a, la), (b, lb) = single[i], placed[i]
    tol = LEAF_TOL[dtype][i]
    np.testing.assert_allclose(lb, la, rtol=LOSS_RTOL[dtype][i])
    assert b.step == a.step == i + 1
    assert gather(b.head["w"]).dtype == getattr(torch, dtype)
    worst = max((_rel(gather(b.params[k]) - s0.params[k],
                      a.params[k] - s0.params[k]), k) for k in s0.params)
    assert worst[0] <= tol, worst
    assert _rel(gather(b.head["w"]) - s0.head["w"],
                a.head["w"] - s0.head["w"]) <= tol
    worst = max((_rel(gather(b.momentum["params"][k]),
                      a.momentum["params"][k]), k) for k in s0.params)
    assert worst[0] <= tol, worst
    assert _rel(gather(b.momentum["head"]["w"]),
                a.momentum["head"]["w"]) <= tol


def test_head_stays_split_over_model(runs):
    """After every step the head and its momentum are split by rows over
    "model" (C / 2 rows a block, a copy on the devices at that
    coordinate), the backbone and its momentum replicated; the mesh
    step's replicas agree with one another."""
    _, _, placed = runs
    for b, _ in placed:
        for w in (b.head["w"], b.momentum["head"]["w"]):
            assert isinstance(w, ShardedRows) and w.axis == "model"
            assert len(w.blocks) == 2 and w.n_local == C // 2
        assert all(isinstance(v, Replicated) for v in b.params.values())
        assert all(isinstance(v, Replicated)
                   for v in b.momentum["params"].values())


def test_mesh_argument_places_a_single_device_state():
    """``make_train_step(mesh=)`` places a state on one device itself
    (and the host batch): the same step as placing it first."""
    s0 = _state()
    x, y = _batch()
    mesh = _mesh()
    got, loss = make_train_step("ir_tiny", lr=LR, mesh=mesh)(s0, x, y)
    want, want_loss = make_train_step("ir_tiny", lr=LR)(
        place_state(s0, train_shardings(s0, mesh)[0]), x, y)
    assert isinstance(got.head["w"], ShardedRows)
    assert float(loss) == float(want_loss)
    for k in s0.params:
        assert torch.equal(gather(got.params[k]), gather(want.params[k])), k
    assert torch.equal(gather(got.head["w"]), gather(want.head["w"]))


def test_losses_match_facekit_dp_tp(runs):
    """facekit's ``test_train_step_dp_tp`` setup on its 8-device mesh,
    from the port's initial state (one numpy-drawn state for both): at
    each step the port's mesh step (and its single-device step) has
    facekit's loss, and the mesh step's head update (the head facekit
    splits over "model") and every backbone leaf's update are facekit's
    (tolerances in the module docstring)."""
    s0, single, placed = runs
    params = jax.tree.map(jnp.asarray, to_jax(s0.params))
    head = {"w": jnp.asarray(s0.head["w"].numpy())}
    fk = FkTrainState(params, head,
                      fk_make_optimizer(LR).init((params, head)),
                      jnp.zeros((), jnp.int32))
    mesh = jax_make_mesh(AXES)
    state_sh, (img_sh, lbl_sh) = fk_train_shardings(fk, mesh)
    fk = jax.device_put(fk, state_sh)
    x, y = _batch()
    xs, ys = jax.device_put(jnp.asarray(x), img_sh), jax.device_put(
        jnp.asarray(y), lbl_sh)
    step = fk_make_train_step(network="ir_tiny", lr=LR)
    p0, h0 = to_jax(s0.params), s0.head["w"].numpy()
    for i in range(STEPS):
        fk, loss = step(fk, xs, ys)
        rtol = LOSS_RTOL["float32"][i]
        np.testing.assert_allclose(placed[i][1], float(loss), rtol=rtol)
        np.testing.assert_allclose(single[i][1], float(loss), rtol=rtol)
        b = placed[i][0]
        assert _rel(gather(b.head["w"]).numpy() - h0,
                    np.asarray(fk.head["w"]) - h0) <= FK_LEAF_TOL
        ours = to_jax({k: gather(v) for k, v in b.params.items()})
        worst = max(jax.tree.leaves(jax.tree.map(
            lambda o, r, z: _rel(np.asarray(o) - z, np.asarray(r) - z),
            ours, fk.params, p0)))
        assert worst <= FK_LEAF_TOL, (i, worst)
    assert "model" in str(fk.head["w"].sharding.spec)


@pytest.mark.parametrize("case", ["classes", "batch", "axes"])
def test_indivisible_refused(case):
    """A head whose C rows the model axis does not divide and a batch
    the data axis does not divide are refused, as ``jax.device_put``
    refuses them; so is a mesh without the axes."""
    mesh = _mesh()
    if case == "classes":
        s = train_state_init(63, "ir_tiny", lr=LR, seed=0, device="cpu")
        with pytest.raises(ValueError, match="63 rows do not split into 2 "
                           "shards of mesh axis 'model'"):
            place_state(s, train_shardings(s, mesh)[0])
    elif case == "batch":
        s0 = _state()
        x, y = _batch()
        with pytest.raises(ValueError, match="batch of 6 does not split "
                           "over the 4 positions of mesh axis 'data'"):
            make_train_step("ir_tiny", lr=LR, mesh=mesh)(s0, x[:6], y[:6])
        img_sh = train_shardings(s0, mesh)[1][0]
        with pytest.raises(ValueError, match="6 rows do not split into 4"):
            device_put(torch.tensor(x[:6]), img_sh)
    else:
        with pytest.raises(ValueError, match=r"no axes \['model'\]"):
            train_shardings(_state(), make_mesh({"data": 8},
                                                devices=["cpu"] * 8))


def test_placed_checkpoint_round_trip(runs, tmp_path):
    """A placed state saves whole (the head put back together) and
    restores into a placed template with the head on its blocks."""
    s0, _, placed = runs
    state = placed[-1][0]
    path = str(tmp_path / "step_3")
    save_checkpoint(path, state)
    mesh = _mesh()
    template = place_state(train_state_init(C, "ir_tiny", lr=LR, seed=9,
                                            device="cpu"),
                           train_shardings(s0, mesh)[0])
    back = restore_checkpoint(path, template)
    assert back.step == STEPS
    assert isinstance(back.head["w"], ShardedRows)
    assert back.head["w"].axis == "model" and len(back.head["w"].blocks) == 2
    assert torch.equal(gather(back.head["w"]), gather(state.head["w"]))
    assert torch.equal(gather(back.momentum["head"]["w"]),
                       gather(state.momentum["head"]["w"]))
    for k in s0.params:
        assert isinstance(back.params[k], Replicated)
        assert torch.equal(gather(back.params[k]), gather(state.params[k]))
    # and into a template on one device: the whole head there
    whole = restore_checkpoint(path, s0)
    assert torch.equal(whole.head["w"], gather(state.head["w"]))
