"""Train -> checkpoint -> ``train-checkpoint`` CLI -> serve, on the port.

The port's counterpart of ``tests/test_train_to_serve.py`` at ``ir_tiny``
on the CPU: from an initial state of facekit's ``train_state_init``
(jitted), ten steps on synthetic identities lower the loss; the
state
goes through ``save_checkpoint`` / ``latest_step_dir`` /
``restore_checkpoint`` bit for bit; ``python -m facekit_torch.weights
train-checkpoint`` writes a param file that facekit's ``load_params``
reads equal to the trained leaves; the port's ``FacePipeline`` and
``GalleryStore`` serve it and recognize held-out samples (accuracy >=
0.75, as facekit's test asks). An interrupted save leaves the previous
checkpoint readable, and an orbax directory (facekit's format) or a
template of another shape is refused.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.train import TrainState as FkTrainState
from facekit.train import train_state_init as fk_train_state_init
from facekit.train.checkpoint import save_checkpoint as fk_save_checkpoint
from facekit.weights.io import load_params as fk_load_params
from facekit_torch.config import FaceKitConfig
from facekit_torch.gallery.store import GalleryStore
from facekit_torch.pipeline import FacePipeline
from facekit_torch.train import checkpoint as ckpt
from facekit_torch.train import make_train_step, train_state_init
from facekit_torch.weights import load_params, random_arcface_params, to_jax
from facekit_torch.weights.__main__ import main as cli_main
from facekit_torch.weights.bridge import _flatten

N_IDS = 6


def _sampler(seed=42):
    rng = np.random.default_rng(seed)
    base = rng.uniform(40, 215, size=(N_IDS, 112, 112, 3))

    def sample(k):
        return np.clip(base[k] + rng.normal(0, 12, base[k].shape),
                       0, 255).astype(np.float32)
    return sample


@pytest.fixture(scope="module")
def trained():
    sample = _sampler()
    imgs = np.stack([sample(k) for k in range(N_IDS) for _ in range(2)])
    labels = np.repeat(np.arange(N_IDS), 2).astype(np.int32)
    fk = jax.jit(fk_train_state_init, static_argnums=(1,),
                 static_argnames=("network",))(
        jax.random.PRNGKey(0), N_IDS, network="ir_tiny")
    state = train_state_init(N_IDS, "ir_tiny", lr=0.003,
                             params=jax.device_get(fk.params), device="cpu")
    state = state._replace(head={"w": torch.tensor(np.asarray(fk.head["w"]))})
    step = make_train_step("ir_tiny", lr=0.003)
    losses = []
    for _ in range(10):
        state, loss = step(state, (imgs - 127.5) / 128.0, labels)
        losses.append(float(loss))
    return state, losses, sample


def _equal_states(a, b):
    assert a.step == b.step
    for x, y in ((a.params, b.params), (a.head, b.head),
                 (a.momentum["params"], b.momentum["params"]),
                 (a.momentum["head"], b.momentum["head"])):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k


def test_loss_falls(trained):
    _, losses, _ = trained
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_checkpoint_round_trip(trained, tmp_path):
    state = trained[0]
    root = tmp_path / "ckpt"
    assert ckpt.latest_step_dir(str(root)) is None
    ckpt.save_checkpoint(str(root / "step_2"), state._replace(step=2))
    ckpt.save_checkpoint(str(root / "step_10"), state)
    (root / "step_x").mkdir()
    latest = ckpt.latest_step_dir(str(root))
    assert latest == str(root / "step_10")
    template = train_state_init(N_IDS, "ir_tiny", seed=9, device="cpu")
    _equal_states(ckpt.restore_checkpoint(latest, template), state)
    # a template of another shape is refused
    other = train_state_init(N_IDS + 1, "ir_tiny", seed=9, device="cpu")
    with pytest.raises(ValueError, match="head w"):
        ckpt.restore_checkpoint(latest, other)


def test_interrupted_save_keeps_previous(trained, tmp_path, monkeypatch):
    state = trained[0]
    path = str(tmp_path / "step_1")
    ckpt.save_checkpoint(path, state)

    def torn(tree, file):
        with open(file, "wb") as f:
            f.write(b"\x85partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_params", torn)
    later = state._replace(step=state.step + 1)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, later)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(str(tmp_path / "step_2"), later)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    template = train_state_init(N_IDS, "ir_tiny", seed=9, device="cpu")
    _equal_states(ckpt.restore_checkpoint(path, template), state)
    monkeypatch.undo()
    ckpt.save_checkpoint(path, later)          # replaces the old one
    assert ckpt.restore_checkpoint(path, template).step == later.step


def test_orbax_directory_refused(tmp_path):
    fk_state = FkTrainState({"a": jnp.zeros(3)}, {"w": jnp.ones((2, 3))}, (),
                            jnp.zeros((), jnp.int32))
    path = str(tmp_path / "orbax_step")
    fk_save_checkpoint(path, fk_state)
    template = train_state_init(4, "ir_tiny", device="cpu")
    with pytest.raises(ValueError, match="orbax checkpoint.*JAX"):
        ckpt.restore_checkpoint(path, template)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        cli_main(["train-checkpoint", path, str(tmp_path / "o.msgpack"),
                  "--network", "ir_tiny", "--num-classes", "4"])
    with pytest.raises(ValueError, match="not a facekit_torch checkpoint"):
        ckpt.save_checkpoint(path, template)


def test_cli_to_served_gallery(trained, tmp_path, capsys):
    """The CLI's file equals the trained leaves in facekit's reader, and
    the port serves it: held-out samples find their identity."""
    state, _, sample = trained
    path = str(tmp_path / "run" / "step_10")
    ckpt.save_checkpoint(path, state)
    out = str(tmp_path / "trained.msgpack")
    cli_main(["train-checkpoint", ckpt.latest_step_dir(
        str(tmp_path / "run")), out, "--network", "ir_tiny",
        "--num-classes", str(N_IDS), "--verify", "--device", "cpu"])
    assert "verify: emb (1, 512) finite=True" in capsys.readouterr().out
    ref = {}
    # the template gives facekit's reader the tree's structure only
    _flatten(jax.device_get(fk_load_params(
        random_arcface_params("ir_tiny", seed=1), out)), "", ref)
    trained_tree = {}
    _flatten(to_jax(state.params), "", trained_tree)
    assert set(ref) == set(trained_tree)
    for k in ref:
        np.testing.assert_array_equal(ref[k], trained_tree[k], err_msg=k)

    pipe = FacePipeline(FaceKitConfig(rec_network="ir_tiny",
                                      compute_dtype="float32"),
                        load_params(out), device="cpu")
    store = GalleryStore(dtype="float32", device="cpu")
    store.load([f"id{k}" for k in range(N_IDS)], pipe.embed_cropped_batch(
        np.stack([sample(k) for k in range(N_IDS)])))
    queries = np.stack([sample(k) for k in range(N_IDS) for _ in range(2)])
    vals, idx, names = store.search(pipe.embed_cropped_batch(queries), k=1)
    pred = np.array([int(names[i][2:]) for i in idx[:, 0]])
    acc = float((pred == np.repeat(np.arange(N_IDS), 2)).mean())
    assert acc >= 0.75, (acc, pred)
    assert np.median(vals[:, 0]) > 0.5, vals[:, 0]
