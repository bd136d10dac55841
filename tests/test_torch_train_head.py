"""facekit_torch's margin heads against facekit's
(``facekit/train/arcface_head.py``): the logits and their gradients, on
one numpy-drawn head and batch, with rows in the degenerate region (an
embedding pointed almost away from its class center).

Tolerances: logits (scale 64) within 1e-4 absolute; gradients within
rtol 1e-4 and atol 1e-3 (the arccos near the antipode amplifies f32
rounding by 1 / sin(theta), about 100 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facekit.train import arcface_head as JH
from facekit_torch.train import arcface_head as TH

C, D = 16, 32


@pytest.fixture()
def batch():
    rng = np.random.default_rng(160)
    w = TH.head_init(C, D, generator=rng)["w"].numpy()
    emb = rng.normal(size=(8, D))
    labels = rng.integers(0, C, size=8).astype(np.int32)
    # rows 0-2 near the antipode of their class center: theta + m > pi
    for r in range(3):
        wn = w[labels[r]] / np.linalg.norm(w[labels[r]])
        emb[r] = -wn + 0.01 * rng.normal(size=D)
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(
        np.float32)
    return w, emb, labels


def _logits_fns(kind):
    if kind == "arc":
        return (lambda h, e, l: JH.arc_margin_logits(h, e, l, 0.5, 64.0),
                lambda h, e, l: TH.arc_margin_logits(h, e, l, 0.5, 64.0))
    m = kind

    def jfn(h, e, l):
        return JH.combined_margin_logits(h, e, l, *m, 64.0)

    def tfn(h, e, l):
        return TH.combined_margin_logits(h, e, l, *m, 64.0)
    return jfn, tfn


KINDS = ["arc", (1.0, 0.5, 0.0), (1.0, 0.0, 0.35), (1.35, 0.0, 0.0)]


@pytest.mark.parametrize("kind", KINDS)
def test_logits_match(batch, kind):
    w, emb, labels = batch
    jfn, tfn = _logits_fns(kind)
    ref = np.asarray(jfn({"w": jnp.asarray(w)}, jnp.asarray(emb),
                         jnp.asarray(labels)))
    ours = tfn({"w": torch.tensor(w)}, torch.tensor(emb),
               torch.tensor(labels)).numpy()
    cos = emb @ (w / np.linalg.norm(w, axis=1, keepdims=True)).T
    tgt = cos[np.arange(8), labels]
    assert (tgt[:3] < np.cos(np.pi - 0.5)).all()     # degenerate rows
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match(batch, kind):
    """d(sum(logits * r)) / d(embeddings, head) against ``jax.grad``."""
    w, emb, labels = batch
    r = np.random.default_rng(161).normal(size=(8, C)).astype(np.float32)
    jfn, tfn = _logits_fns(kind)

    def jloss(wj, ej):
        return jnp.sum(jfn({"w": wj}, ej, jnp.asarray(labels)) * r)

    gw_ref, ge_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w),
                                                      jnp.asarray(emb))
    wt = torch.tensor(w, requires_grad=True)
    et = torch.tensor(emb, requires_grad=True)
    (tfn({"w": wt}, et, torch.tensor(labels)) * torch.tensor(r)).sum() \
        .backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge_ref),
                               rtol=1e-4, atol=1e-3)
    assert np.abs(et.grad.numpy()[:3]).max() > 1e-3   # hard rows keep one


def test_head_init_generators():
    """A numpy generator draws what ``normal * 0.01`` draws from it; a
    torch generator is repeatable; the head is f32 (C, D)."""
    w = TH.head_init(4, 8, generator=np.random.default_rng(3))["w"]
    np.testing.assert_array_equal(
        w.numpy(), (np.random.default_rng(3).normal(size=(4, 8))
                    .astype(np.float32) * np.float32(0.01)))
    a = TH.head_init(4, 8, generator=torch.Generator().manual_seed(1))["w"]
    b = TH.head_init(4, 8, generator=torch.Generator().manual_seed(1))["w"]
    assert a.dtype == torch.float32 and a.shape == (4, 8)
    assert torch.equal(a, b)
