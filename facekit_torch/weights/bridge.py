"""Parameter carry-over from facekit's layout to the port's modules.

facekit keeps parameters as a pytree of nested dicts and lists (NHWC
layers, HWIO conv weights, ``facekit/models/layers.py:7``), saved as msgpack
by ``flax.serialization.to_bytes`` (``facekit/weights/io.py:15-17``; the
port reads and writes those files in ``weights/io.py``). The
port's modules name their parameters after the same tree paths, joined
with dots (``blocks.3.conv1``, ``output.linear.w``), so the carry-over is a
flatten plus one layout change:

  * conv weights go from HWIO to OIHW;
  * the linear weight stays in torch's ``(out, in)`` layout
    (``facekit/models/layers.py:198-201``);
  * batch-norm keeps ``scale/bias/mean/var`` (eps 1e-5);
  * a quantized tree (``quantize_arcface_params`` /
    ``calibrate_arcface_int8``, ``quantize_detector_params``) has ``{"q",
    "scale"[, "ascale"]}`` leaves at its conv sites: ``q`` goes to int8
    OIHW without passing through a float, ``scale`` and ``ascale`` stay
    f32, bit for bit, as do the ``oscale`` leaves of an int8-residual
    tree (``input.oscale``, ``blocks.<i>.oscale``);
  * a ``None`` leaf (RFB's ``dw[6]``, where its block sits) has no
    parameters and is skipped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from facekit_torch.models.arcface import block_specs


def _flatten(node, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if node is None:
        return
    if isinstance(node, Mapping):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        arr = np.asarray(node)
        out[prefix] = arr if arr.dtype == np.int8 else arr.astype(np.float32)
        return
    for key, value in items:
        _flatten(value, f"{prefix}.{key}" if prefix else str(key), out)


def from_jax(params, network: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """facekit param pytree (numpy or array leaves) -> ``network``'s
    ``state_dict``.

    Every key of the network must be supplied, every supplied key must be
    used, and shapes and dtypes (int8 or float) must match; anything else
    raises. A quantized tree needs an ``ArcFace(int8=...)`` of the same
    form: "residual" where the stem and blocks carry ``oscale``, "static"
    where only its sites carry ``ascale``, else "dynamic".
    """
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    expected = network.state_dict()
    missing = sorted(set(expected) - set(flat))
    unused = sorted(set(flat) - set(expected))
    if missing or unused:
        raise ValueError(f"param tree does not fit {type(network).__name__}: "
                         f"missing {missing[:5]}, unused {unused[:5]}")
    out = {}
    for key, ref in expected.items():
        arr = flat[key]
        if arr.ndim == 4:                      # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit "
                             f"{tuple(ref.shape)}")
        if (arr.dtype == np.int8) != (ref.dtype == torch.int8):
            raise ValueError(f"{key}: dtype {arr.dtype} does not fit "
                             f"{ref.dtype}")
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


# -- random parameters, drawn with numpy -------------------------------------

def _xavier_hwio(rng, o, i, kh, kw):
    a = np.sqrt(6.0 / (i * kh * kw + o * kh * kw))
    w = rng.uniform(-a, a, size=(o, i, kh, kw)).astype(np.float32)
    return w.transpose(2, 3, 1, 0)


def _bn(rng, c):
    """Inference BN statistics near identity, drawn so the carry-over of
    each field is exercised."""
    return {
        "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
        "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32),
        "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
        "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
    }


def random_arcface_params(network: str = "ir_50", seed: int = 0,
                          input_size: int = 112,
                          embed_dim: int = 512) -> Dict[str, Any]:
    """Random ArcFace params in facekit's layout (the tree
    ``facekit.models.arcface_init`` returns), drawn from ``seed`` with
    numpy so both packages can be fed the same values."""
    rng = np.random.default_rng(seed)
    se = network.startswith("ir_se")
    fmap = input_size // 16
    blocks = []
    for c, depth, _ in block_specs(network):
        blk = {
            "bn1": _bn(rng, c),
            "conv1": _xavier_hwio(rng, depth, c, 3, 3),
            "prelu": rng.uniform(0.2, 0.3, depth).astype(np.float32),
            "conv2": _xavier_hwio(rng, depth, depth, 3, 3),
            "bn2": _bn(rng, depth),
        }
        if c != depth:
            blk["shortcut"] = {"conv": _xavier_hwio(rng, depth, c, 1, 1),
                               "bn": _bn(rng, depth)}
        if se:
            blk["se"] = {"fc1": _xavier_hwio(rng, depth // 16, depth, 1, 1),
                         "fc2": _xavier_hwio(rng, depth, depth // 16, 1, 1)}
        blocks.append(blk)
    lin_in = 512 * fmap * fmap
    a = np.sqrt(6.0 / (lin_in + embed_dim))
    return {
        "input": {"conv": _xavier_hwio(rng, 64, 3, 3, 3), "bn": _bn(rng, 64),
                  "prelu": rng.uniform(0.2, 0.3, 64).astype(np.float32)},
        "blocks": blocks,
        "output": {
            "bn2d": _bn(rng, 512),
            "linear": {"w": rng.uniform(-a, a, (embed_dim, lin_in))
                       .astype(np.float32),
                       "b": rng.uniform(-0.01, 0.01, embed_dim)
                       .astype(np.float32)},
            "bn1d": _bn(rng, embed_dim),
        },
    }


def _kaiming_hwio(rng, o, i, kh, kw):
    """torch Conv2d's default init (kaiming uniform, a = sqrt(5)), HWIO."""
    bound = 1.0 / np.sqrt(i * kh * kw)
    w = rng.uniform(-bound, bound, size=(o, i, kh, kw)).astype(np.float32)
    return w.transpose(2, 3, 1, 0)


def random_retinaface_params(seed: int = 0, with_landmarks: bool = True
                             ) -> Dict[str, Any]:
    """Random RetinaFace-MobileNet0.25 params in facekit's layout (the
    tree ``facekit.models.retinaface_init`` returns), drawn from ``seed``
    with numpy so both packages can be fed the same values."""
    from facekit_torch.models.retinaface import (_FPN_IN, _NUM_ANCHORS,
                                                 _OUT_CH, _STAGE1, _STAGE2,
                                                 _STAGE3)
    rng = np.random.default_rng(seed)

    def conv_bn(cin, cout, k=3):
        return {"conv": _kaiming_hwio(rng, cout, cin, k, k),
                "bn": _bn(rng, cout)}

    def conv_dw(cin, cout):
        return {"dw_conv": _kaiming_hwio(rng, cin, 1, 3, 3),
                "dw_bn": _bn(rng, cin),
                "pw_conv": _kaiming_hwio(rng, cout, cin, 1, 1),
                "pw_bn": _bn(rng, cout)}

    def ssh():
        c = _OUT_CH
        return {"conv3x3": conv_bn(c, c // 2),
                "conv5x5_1": conv_bn(c, c // 4),
                "conv5x5_2": conv_bn(c // 4, c // 4),
                "conv7x7_2": conv_bn(c // 4, c // 4),
                "conv7x7_3": conv_bn(c // 4, c // 4)}

    def head(dim):
        return {"w": _kaiming_hwio(rng, _NUM_ANCHORS * dim, _OUT_CH, 1, 1),
                "b": rng.uniform(-0.1, 0.1, _NUM_ANCHORS * dim)
                .astype(np.float32)}

    params = {
        "stem": conv_bn(3, 8),
        "stage1": [conv_dw(ci, co) for ci, co, _ in _STAGE1],
        "stage2": [conv_dw(ci, co) for ci, co, _ in _STAGE2],
        "stage3": [conv_dw(ci, co) for ci, co, _ in _STAGE3],
        "fpn": {"output1": conv_bn(_FPN_IN[0], _OUT_CH, 1),
                "output2": conv_bn(_FPN_IN[1], _OUT_CH, 1),
                "output3": conv_bn(_FPN_IN[2], _OUT_CH, 1),
                "merge1": conv_bn(_OUT_CH, _OUT_CH),
                "merge2": conv_bn(_OUT_CH, _OUT_CH)},
        "ssh1": ssh(), "ssh2": ssh(), "ssh3": ssh(),
        "class_head": [head(2) for _ in range(3)],
        "bbox_head": [head(4) for _ in range(3)],
    }
    if with_landmarks:
        params["ldm_head"] = [head(10) for _ in range(3)]
    return params


def random_lightdet_params(variant: str = "slim", seed: int = 0
                           ) -> Dict[str, Any]:
    """Random slim or RFB detector params in facekit's layout (the tree
    ``facekit.models.lightdet.lightdet_init`` returns, ``None`` at RFB's
    ``dw[6]``), drawn from ``seed`` with numpy so both packages can be fed
    the same values."""
    from facekit_torch.models.lightdet import (DW_CHAIN, LEVEL_ANCHORS,
                                               LEVEL_CH, RFB_INDEX, VARIANTS)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: 'slim' or 'rfb'")
    rng = np.random.default_rng(seed)

    def bias(c):
        return rng.uniform(-0.1, 0.1, c).astype(np.float32)

    def depth_conv(cin, cout):
        return {"dw_w": _kaiming_hwio(rng, cin, 1, 3, 3), "dw_b": bias(cin),
                "pw_w": _kaiming_hwio(rng, cout, cin, 1, 1),
                "pw_b": bias(cout)}

    def basic(cin, cout, k):
        return {"w": _kaiming_hwio(rng, cout, cin, k, k), "bn": _bn(rng, cout)}

    def head(level, dim):
        cin, cout = LEVEL_CH[level], LEVEL_ANCHORS[level] * dim
        if level < 3:
            return depth_conv(cin, cout)
        return {"w": _kaiming_hwio(rng, cout, cin, 3, 3), "b": bias(cout)}

    params: Dict[str, Any] = {
        "conv1": {"conv": _kaiming_hwio(rng, 16, 3, 3, 3), "bn": _bn(rng, 16)},
        "dw": [],
        "conv14_a": {"w": _kaiming_hwio(rng, 64, 256, 1, 1), "b": bias(64)},
        "conv14_b": depth_conv(64, 256),
    }
    for i, (ci, co, _) in enumerate(DW_CHAIN):
        if variant == "rfb" and i == RFB_INDEX:
            params["dw"].append(None)
            inter = 64 // 8
            params["rfb8"] = {
                "b0": [basic(64, inter, 1), basic(inter, 2 * inter, 3),
                       basic(2 * inter, 2 * inter, 3)],
                "b1": [basic(64, inter, 1), basic(inter, 2 * inter, 3),
                       basic(2 * inter, 2 * inter, 3)],
                "b2": [basic(64, inter, 1),
                       basic(inter, (inter // 2) * 3, 3),
                       basic((inter // 2) * 3, 2 * inter, 3),
                       basic(2 * inter, 2 * inter, 3)],
                "linear": basic(6 * inter, 64, 1),
                "shortcut": basic(64, 64, 1),
            }
        else:
            params["dw"].append({
                "dw_conv": _kaiming_hwio(rng, ci, 1, 3, 3),
                "dw_bn": _bn(rng, ci),
                "pw_conv": _kaiming_hwio(rng, co, ci, 1, 1),
                "pw_bn": _bn(rng, co)})
    for name, dim in (("loc", 4), ("conf", 2), ("landm", 10)):
        params[name] = [head(lvl, dim) for lvl in range(4)]
    return params
