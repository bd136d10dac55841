"""The ArcFace train step, the port of ``facekit/train/step.py``.

State: the backbone's leaves as one flat dict of f32 tensors keyed by
facekit's pytree paths (``input.conv``, ``blocks.3.bn1.mean``,
``output.linear.w``; conv weights OIHW), BN ``mean`` and ``var``
included, since facekit differentiates and updates them like any other
leaf; the margin head ``{"w": (C, D)}``; one momentum buffer per leaf
and per head tensor; and the update count.

The forward is ``torch.func.functional_call`` of an ``ArcFace`` (built on
the meta device, so it holds no tensor of its own) on those leaves. Its
fused IR blocks run op by op whenever autograd records them
(``ops.ir_block.needs_grad``), as facekit's step differentiates
``_block_apply``.

The optimizer is optax's ``sgd`` as facekit chains it (``:35-61``):
weight decay added to the gradient of rank >= 2 leaves, then
m = g + momentum * m and p = p - lr_t * m, lr_t the schedule at the count
of updates before this one, so a warmup schedule's first update only
fills the momentum buffer. The step returns a new state and leaves the
one it was given as it was, as facekit's jitted step does.

``train_shardings`` and the data-parallel step are not ported here.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from facekit_torch.models.arcface import ArcFace
from facekit_torch.train.arcface_head import (arc_margin_logits,
                                              combined_margin_logits,
                                              head_init)
from facekit_torch.utils.device import resolve_device
from facekit_torch.weights.bridge import from_jax, random_arcface_params


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]        # backbone leaves, f32
    head: Dict[str, torch.Tensor]          # {"w": (C, D)} f32
    momentum: Dict[str, Dict[str, torch.Tensor]]   # {"params": .., "head": ..}
    step: int                              # updates taken


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (counted from 0), constant after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return sched


class SGD(NamedTuple):
    """SGD with momentum, masked weight decay and a schedule; see the
    module docstring."""
    schedule: Callable[[int], float]
    momentum: float
    weight_decay: float

    def lr(self, count: int) -> float:
        return float(self.schedule(count))

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               bufs: List[torch.Tensor], count: int
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(new params, new momentum buffers), new tensors."""
        if self.weight_decay:
            grads = [g + self.weight_decay * p if p.dim() >= 2 else g
                     for g, p in zip(grads, params)]
        new_bufs = torch._foreach_add(grads, torch._foreach_mul(
            bufs, self.momentum))
        step = torch._foreach_mul(new_bufs, -self.lr(count))
        return torch._foreach_add(params, step), new_bufs


def make_optimizer(lr: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 0.0, schedule=None,
                   warmup_steps: int = 0, total_steps: int = 0) -> SGD:
    """SGD + momentum with the ArcFace recipe's extras (``step.py:35-61``).

    ``schedule``: None, a constant ``lr``; ``"cosine"``, linear warmup over
    ``warmup_steps`` from 0 then cosine decay to 0 at ``total_steps``; or
    a callable of the update count. ``weight_decay`` applies to rank >= 2
    leaves only (conv, linear and head weights)."""
    if callable(schedule):
        sched = schedule
    elif schedule == "cosine":
        if total_steps <= 0:
            raise ValueError("cosine schedule needs total_steps > 0")
        sched = warmup_cosine_decay_schedule(0.0, lr, max(warmup_steps, 1),
                                             total_steps)
    elif schedule is None:
        def sched(count):
            return lr
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return SGD(sched, momentum, weight_decay)


def _zeros_like(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in tensors.items()}


def _fresh_backbone(network: str, seed: int, embed_dim: int):
    """facekit's ``arcface_init`` drawn with numpy: xavier-uniform conv and
    linear weights (``random_arcface_params``), a zero linear bias, every
    BN at identity (scale 1, bias 0, mean 0, var 1) and PReLU slopes
    0.25; ``random_arcface_params`` draws the BN statistics and slopes at
    random instead, to exercise the carry-over of each field."""
    tree = random_arcface_params(network, seed=seed, embed_dim=embed_dim)

    def reset(node):
        if isinstance(node, list):
            return [reset(v) for v in node]
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = len(node["scale"])
            return {"scale": np.ones(c, np.float32),
                    "bias": np.zeros(c, np.float32),
                    "mean": np.zeros(c, np.float32),
                    "var": np.ones(c, np.float32)}
        out = {k: (reset(v) if isinstance(v, (dict, list)) else v)
               for k, v in node.items()}
        if "prelu" in out:
            out["prelu"] = np.full_like(out["prelu"], 0.25)
        return out

    tree = reset(tree)
    tree["output"]["linear"]["b"] = np.zeros(embed_dim, np.float32)
    return tree


def train_state_init(num_classes: int, network: str = "ir_50",
                     lr: float = 0.1, *, seed: int = 0, generator=None,
                     params=None, embed_dim: int = 512, device=None,
                     **opt_kwargs) -> TrainState:
    """A fresh state on ``device`` (default ``"cuda"``).

    The backbone is ``params`` (a facekit param tree, carried over by
    ``from_jax``) or one drawn from ``seed`` as facekit's ``arcface_init``
    draws it (``_fresh_backbone``); the head is ``head_init`` drawn from ``generator`` (a torch or numpy
    generator; default numpy's from ``seed + 1``). ``lr`` and
    ``opt_kwargs`` are those of ``make_train_step``, checked here as
    facekit builds its optimizer here."""
    make_optimizer(lr, **opt_kwargs)
    dev = resolve_device(device)
    if params is None:
        params = _fresh_backbone(network, seed, embed_dim)
    with torch.device("meta"):
        net = ArcFace(network, embed_dim=embed_dim)
    leaves = {k: v.to(dev) for k, v in from_jax(params, net).items()}
    head = head_init(num_classes, leaves["output.linear.w"].shape[0],
                     generator=(np.random.default_rng(seed + 1)
                                if generator is None else generator),
                     device=dev)
    return TrainState(leaves, head, {"params": _zeros_like(leaves),
                                     "head": _zeros_like(head)}, 0)


@functools.lru_cache(maxsize=8)
def _backbone(network: str, input_size: int, embed_dim: int,
              compute_dtype: torch.dtype) -> ArcFace:
    """The module whose forward ``functional_call`` runs: no tensors of
    its own (meta device), computing in ``compute_dtype`` from whatever
    leaves it is given."""
    with torch.device("meta"):
        net = ArcFace(network, input_size=input_size, embed_dim=embed_dim)
    net.compute_dtype = compute_dtype
    return net.eval()


def _as_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A tensor on ``device`` that owns its memory: the loader reuses no
    buffer today, but a caller's numpy array may be rewritten while the
    step that reads it is queued (``torch.from_numpy`` would alias it)."""
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=device, dtype=dtype)
    return torch.as_tensor(x, device=device, dtype=dtype)


def make_train_step(network: str = "ir_50", lr: float = 0.1,
                    margin: float = 0.5, scale: float = 64.0,
                    remat: bool = False, margins=None,
                    compute_dtype: torch.dtype = torch.float32,
                    **opt_kwargs):
    """``train_step(state, images, labels) -> (state, loss)``.

    ``images`` (B, H, W, 3) normalized RGB and ``labels`` (B,), numpy or
    tensors, go to the state's device with a copy. The backbone computes
    in ``compute_dtype`` from the f32 leaves (each use casts, which
    autograd differentiates), so the masters, the momentum, the
    embedding, the margin head and the loss stay f32: facekit's bf16
    recipe. ``margins`` (m1, m2, m3) selects ``combined_margin_logits``,
    else ``arc_margin_logits`` with ``margin``. The loss is the mean
    softmax cross-entropy. ``remat=True`` recomputes the backbone's
    forward in the backward (``torch.utils.checkpoint``, non-reentrant),
    as ``jax.checkpoint(backbone)``. ``opt_kwargs`` go to
    ``make_optimizer``; give ``train_state_init`` the same."""
    opt = make_optimizer(lr, **opt_kwargs)

    def loss_fn(leaves, head, images, labels):
        w = leaves["output.linear.w"]
        net = _backbone(network, 16 * math.isqrt(w.shape[1] // 512),
                        w.shape[0], compute_dtype)

        def backbone(x):
            return torch.func.functional_call(net, leaves, (x,), strict=True)

        emb = (checkpoint(backbone, images, use_reentrant=False) if remat
               else backbone(images)).float()
        if margins is not None:
            m1, m2, m3 = margins
            logits = combined_margin_logits(head, emb, labels, m1, m2, m3,
                                            scale)
        else:
            logits = arc_margin_logits(head, emb, labels, margin, scale)
        return F.cross_entropy(logits, labels.long())

    def train_step(state: TrainState, images, labels
                   ) -> Tuple[TrainState, torch.Tensor]:
        dev = state.head["w"].device
        if dev.type == "cuda":
            # products and convs in full f32, not TF32, as FacePipeline
            # sets them (process-wide switches): the f32 step, the margin
            # head and the bf16 recipe's f32 linear layer are facekit's f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        x = _as_device(images, dev, torch.float32)
        y = _as_device(labels, dev, torch.int64)
        keys = list(state.params)
        leaves = {k: state.params[k].detach().requires_grad_()
                  for k in keys}
        head = {"w": state.head["w"].detach().requires_grad_()}
        loss = loss_fn(leaves, head, x, y)
        grads = torch.autograd.grad(loss, [*leaves.values(), head["w"]])
        params, bufs = opt.update(
            [*state.params.values(), state.head["w"]], list(grads),
            [*(state.momentum["params"][k] for k in keys),
             state.momentum["head"]["w"]], state.step)
        n = len(keys)
        new = TrainState(dict(zip(keys, params[:n])), {"w": params[n]},
                         {"params": dict(zip(keys, bufs[:n])),
                          "head": {"w": bufs[n]}}, state.step + 1)
        return new, loss.detach()

    train_step.optimizer = opt
    return train_step
