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

On a device mesh with a ``"data"`` and a ``"model"`` axis
(``train_shardings``, ``facekit/train/step.py:75-92``) the state is
placed as facekit's GSPMD step holds it: every backbone leaf and its
momentum replicated, one copy on each distinct device; the head ``w``
(C, D) and its momentum split by rows (classes) over ``"model"``;
images and labels split over ``"data"``. ``make_train_step`` given such
a state (or ``mesh=``) runs one step in one process, as the port's
serving does: each data position runs the backbone on its replica and
its slice of the batch; its embeddings go to every model position's
block of head rows, whose cosines and margin give that block's logit
columns; the logit blocks come together on the data position's device
for the softmax cross-entropy, and the per-sample losses on the home
device for the mean. Autograd carries the gradients back across the
copies; the replicas' gradients are summed by copies to one device (the
home for the backbone, one flat buffer per replica, the block's first
device for a head block) and sent back to every copy, and each copy
takes the same ``SGD.update``
(weight-decay mask, schedule). facekit's BN statistics are trained
leaves used in inference form, so there is no batch statistic to
synchronize, and the step is the single-device step up to the order of
f32 sums.

One process, not ``torch.distributed`` (DDP): the port drives every
local GPU from one process, as its mesh serving does (ROADMAP.md, "One
process, not torch.distributed"); facekit's step is one jitted program
over the mesh, not one program per device, and DDP has no class-split
head. Copies between devices are ``.to(device)`` calls on the current
streams, which order themselves after the work that made their source.
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
from facekit_torch.parallel import (Replicated, ShardedRows, Sharding,
                                    canonical, device_put, gather)
from facekit_torch.train.arcface_head import (arc_margin, combined_margin,
                                              cosines, head_init, onehot)
from facekit_torch.utils.device import resolve_device
from facekit_torch.weights.bridge import from_jax, random_arcface_params


class TrainState(NamedTuple):
    """On one device every tensor is a ``torch.Tensor``; a state placed
    on a mesh (``place_state``) holds ``Replicated`` backbone leaves and
    momentum and a ``ShardedRows`` head and head momentum."""
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


def train_shardings(state: TrainState, mesh, data_axis: str = "data",
                    model_axis: str = "model"):
    """(state_shardings, batch_shardings) as facekit's (``:75-92``): the
    backbone leaves, their momentum and the count replicated; the head
    ``w`` split by rows over ``model_axis`` and its momentum with it
    (facekit's GSPMD gives the momentum that sharding after the first
    step); images and labels split over ``data_axis``. ``place_state``
    applies the first, ``device_put`` each of the second."""
    missing = [a for a in (data_axis, model_axis) if a not in mesh.shape]
    if missing:
        raise ValueError(f"mesh {mesh.shape} has no axes {missing}")
    repl = Sharding(mesh, ())
    head = {"w": Sharding(mesh, (model_axis, None))}
    params = {k: repl for k in state.params}
    return (TrainState(params, head, {"params": params, "head": head}, repl),
            (Sharding(mesh, (data_axis, None, None, None)),
             Sharding(mesh, (data_axis,))))


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` (on one device or placed already) placed as
    ``shardings`` says (``jax.device_put(state, state_shardings)``).
    Refuses a head whose C rows the model axis does not divide."""
    def put(tensors, shs):
        return {k: device_put(gather(v), shs[k]) for k, v in tensors.items()}
    return TrainState(put(state.params, shardings.params),
                      put(state.head, shardings.head),
                      {k: put(v, shardings.momentum[k])
                       for k, v in state.momentum.items()}, state.step)


def make_train_step(network: str = "ir_50", lr: float = 0.1,
                    margin: float = 0.5, scale: float = 64.0,
                    remat: bool = False, margins=None,
                    compute_dtype: torch.dtype = torch.float32, mesh=None,
                    data_axis: str = "data", model_axis: str = "model",
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
    ``make_optimizer``; give ``train_state_init`` the same.

    A state placed by ``train_shardings`` / ``place_state`` takes the
    data-parallel step of the module docstring, over its mesh and
    ``data_axis``; with ``mesh`` a state on one device is placed first
    (``train_shardings(state, mesh, data_axis, model_axis)``). The images
    and labels are then host arrays, tensors, or ``ShardedRows`` placed
    by the batch shardings; B must split over ``data_axis``. The new
    state is placed as the old one, the loss on the mesh's home
    device."""
    opt = make_optimizer(lr, **opt_kwargs)

    def embed(leaves, images):
        w = leaves["output.linear.w"]
        net = _backbone(network, 16 * math.isqrt(w.shape[1] // 512),
                        w.shape[0], compute_dtype)

        def backbone(x):
            return torch.func.functional_call(net, leaves, (x,), strict=True)

        # the embedding in the masters' dtype: f32 (float64 for a check
        # of f32 rounding)
        return (checkpoint(backbone, images, use_reentrant=False) if remat
                else backbone(images)).to(w.dtype)

    def logits_of(cos, target):
        if margins is not None:
            m1, m2, m3 = margins
            return combined_margin(cos, target, m1, m2, m3, scale)
        return arc_margin(cos, target, margin, scale)

    def loss_fn(leaves, head, images, labels):
        emb = embed(leaves, images)
        cos = cosines(head, emb)
        logits = logits_of(cos, onehot(labels, head["w"].shape[0], cos))
        return F.cross_entropy(logits, labels.long())

    def single_step(state: TrainState, images, labels
                    ) -> Tuple[TrainState, torch.Tensor]:
        dev = state.head["w"].device
        _no_tf32(dev)
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

    def mesh_step(state: TrainState, images, labels
                  ) -> Tuple[TrainState, torch.Tensor]:
        w_rows: ShardedRows = state.head["w"]
        mesh, axis = w_rows.mesh, w_rows.axis
        home = canonical(mesh.home)
        _no_tf32(home)
        xs = _data_slices(images, mesh, data_axis, torch.float32)
        ys = _data_slices(labels, mesh, data_axis, torch.int64)
        rows = [canonical(mesh.device_at(**{data_axis: r}))
                for r in range(len(xs))]
        keys = list(state.params)
        # one set of backbone leaves per device that runs the backbone
        leaves = {dev: {k: state.params[k].on(dev).detach()
                        .requires_grad_() for k in keys}
                  for dev in dict.fromkeys(rows)}
        # one leaf per copy of a head block that a data position reads
        blocks = len(w_rows.blocks)
        at = [[canonical(mesh.device_at(**{data_axis: r, axis: m}))
               for m in range(blocks)] for r in range(len(xs))]
        head = [{dev: w_rows.blocks[m][dev].detach().requires_grad_()
                 for dev in dict.fromkeys(a[m] for a in at)}
                for m in range(blocks)]
        c_local = w_rows.n_local
        losses = []
        for r, (x, y) in enumerate(zip(xs, ys)):
            emb = embed(leaves[rows[r]], x)
            parts = []
            for m in range(blocks):
                dev = at[r][m]
                cos = cosines({"w": head[m][dev]}, emb.to(dev))
                target = onehot(y.to(dev), c_local, cos, m * c_local)
                parts.append(logits_of(cos, target).to(rows[r]))
            losses.append(F.cross_entropy(torch.cat(parts, 1), y,
                                          reduction="none").to(home))
        loss = torch.cat(losses).mean()
        order = [(dev, k) for dev in leaves for k in keys]
        order_h = [(m, dev) for m in range(blocks) for dev in head[m]]
        grads = torch.autograd.grad(
            loss, [leaves[dev][k] for dev, k in order]
            + [head[m][dev] for m, dev in order_h])
        g_params = dict(zip(order, grads[:len(order)]))
        g_head = dict(zip(order_h, grads[len(order):]))
        # the backbone's gradients, one flat buffer per replica, summed
        # on the home device and sent back as one buffer to every copy,
        # where it splits into views; each copy takes the same update
        summed = _sum_to(home, [_flatten([g_params[(dev, k)] for k in keys])
                                for dev in leaves])
        params_out = {k: {} for k in keys}
        bufs_out = {k: {} for k in keys}
        for dev in state.params[keys[0]].copies:
            mine = [state.params[k].on(dev) for k in keys]
            new_p, new_b = opt.update(
                mine, _split_as(summed.to(dev), mine),
                [state.momentum["params"][k].on(dev) for k in keys],
                state.step)
            for k, p, b in zip(keys, new_p, new_b):
                params_out[k][dev] = p
                bufs_out[k][dev] = b
        # each head block: its copies' gradients summed on its first
        # device and sent back to every copy of the block
        w_out, wb_out = [], []
        mom_rows: ShardedRows = state.momentum["head"]["w"]
        for m in range(blocks):
            copies = w_rows.blocks[m]
            first = next(iter(copies))
            g = _sum_to(first, [g_head[(m, dev)] for dev in head[m]])
            devs = list(copies)
            new_p, new_b = opt.update(
                [copies[dev] for dev in devs], [g.to(dev) for dev in devs],
                [mom_rows.blocks[m][dev] for dev in devs], state.step)
            w_out.append(dict(zip(devs, new_p)))
            wb_out.append(dict(zip(devs, new_b)))
        new = TrainState(
            {k: Replicated(mesh, params_out[k]) for k in keys},
            {"w": ShardedRows(mesh, axis, w_out)},
            {"params": {k: Replicated(mesh, bufs_out[k]) for k in keys},
             "head": {"w": ShardedRows(mesh, axis, wb_out)}},
            state.step + 1)
        return new, loss.detach()

    def train_step(state: TrainState, images, labels
                   ) -> Tuple[TrainState, torch.Tensor]:
        placed = isinstance(state.head["w"], ShardedRows)
        if not placed and mesh is not None:
            state = place_state(state, train_shardings(
                state, mesh, data_axis, model_axis)[0])
            placed = True
        return (mesh_step if placed else single_step)(state, images, labels)

    train_step.optimizer = opt
    return train_step


def _no_tf32(dev: torch.device) -> None:
    if dev.type == "cuda":
        # products and convs in full f32, not TF32, as FacePipeline sets
        # them (process-wide switches): the f32 step, the margin head and
        # the bf16 recipe's f32 linear layer are facekit's f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _data_slices(x, mesh, data_axis: str, dtype: torch.dtype):
    """Data position r's slice of a batch, on its device: the blocks of a
    ``ShardedRows`` placed over ``data_axis``, else slices of a host
    array or tensor (copied, ``_as_device``). B must split over the
    axis."""
    d = mesh.shape[data_axis]
    devs = [canonical(mesh.device_at(**{data_axis: r})) for r in range(d)]
    if isinstance(x, ShardedRows):
        if x.axis != data_axis:
            raise ValueError(f"batch split over {x.axis!r}, the step's data "
                             f"axis is {data_axis!r}")
        return [x.block(r, dev).to(dtype) for r, dev in enumerate(devs)]
    b = x.shape[0]
    if b % d:
        raise ValueError(f"a batch of {b} does not split over the {d} "
                         f"positions of mesh axis {data_axis!r}")
    m = b // d
    return [_as_device(x[r * m:(r + 1) * m], dev, dtype)
            for r, dev in enumerate(devs)]


def _flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    """One 1-D tensor holding ``tensors`` one after another (on their
    device), so that a gradient crosses devices in one copy."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _split_as(flat: torch.Tensor, like: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """``_flatten``'s inverse: views of ``flat`` shaped as ``like``."""
    parts = flat.split([t.numel() for t in like])
    return [p.view_as(t) for p, t in zip(parts, like)]


def _sum_to(dev: torch.device, grads: List[torch.Tensor]) -> torch.Tensor:
    """The sum of ``grads`` (from any devices), copied to ``dev``."""
    total = grads[0].to(dev)
    for g in grads[1:]:
        total = total + g.to(dev)
    return total
