"""facekit_torch's weights package against facekit's: the checkpoint
converters, the param files (``save_params`` / ``load_params``) and the
converter CLI.

Reference-layout state_dicts are built from numpy-drawn trees by
``torch_reference_layout`` (the converters' inverse), so no checkpoint
file and no reference checkout is needed. Conversions and files must be
bit-equal to facekit's: every leaf, its dtype and the file's bytes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from facekit.models import arcface_apply
from facekit.models.arcface import quantize_arcface_params
from facekit.weights import convert as jax_convert
from facekit.weights import load_params as jax_load_params
from facekit.weights import save_params as jax_save_params
from facekit_torch.models import ArcFace, RetinaFace
from facekit_torch.weights import (ConversionError, convert_arcface_state_dict,
                                   convert_retinaface_state_dict, from_jax,
                                   load_params, load_torch_checkpoint,
                                   random_arcface_params,
                                   random_retinaface_params, save_params)
from facekit_torch.weights.__main__ import main as cli_main
from torch_reference_layout import arcface_state_dict, retinaface_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    """{dotted path: numpy leaf, or None}; lists and maps keyed "0", "1"
    alike."""
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def assert_same_leaves(a, b):
    """Same paths, shapes, dtypes and bits (``None`` where the other has
    ``None``), checked from both sides."""
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if fa[k] is None or fb[k] is None:
            assert fa[k] is fb[k] is None, k
            continue
        assert fa[k].dtype == fb[k].dtype, k
        assert fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


_CASES = {
    "ir_tiny": lambda: ("arcface", random_arcface_params("ir_tiny", seed=3)),
    "ir_se_tiny": lambda: ("arcface",
                           random_arcface_params("ir_se_tiny", seed=4)),
    "retinaface_ldm": lambda: ("retinaface", random_retinaface_params(seed=5)),
    "retinaface": lambda: ("retinaface", random_retinaface_params(
        seed=6, with_landmarks=False)),
}


def _convert_both(case):
    model, tree = _CASES[case]()
    if model == "arcface":
        sd = arcface_state_dict(tree)
        return (tree, convert_arcface_state_dict(sd, case),
                jax_convert.convert_arcface_state_dict(sd, case))
    sd = retinaface_state_dict(tree)
    return (tree, convert_retinaface_state_dict(sd),
            jax_convert.convert_retinaface_state_dict(sd))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_converter_matches_facekit(case, tmp_path):
    """The port's conversion equals facekit's leaf for leaf and bit for
    bit, is the tree the checkpoint was made from, and is saved as the
    same bytes that flax writes for facekit's conversion."""
    tree, ours, theirs = _convert_both(case)
    assert_same_leaves(ours, tree_np(theirs))
    assert_same_leaves(ours, tree)
    if case.startswith("retinaface"):
        assert ("ldm_head" in ours) == (case == "retinaface_ldm")
    path = str(tmp_path / "w.msgpack")
    save_params(ours, path)
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(theirs)


def _ir_tiny_sd():
    return arcface_state_dict(random_arcface_params("ir_tiny", seed=7))


def _extra_keys(sd):
    sd = dict(sd)
    sd["head.kernel"] = np.zeros((512, 10), np.float32)
    sd["optimizer.step"] = np.zeros((), np.int64)
    return sd, "ir_tiny", "never consumed"


def _missing_key(sd):
    sd = dict(sd)
    del sd["body.3.res_layer.1.weight"]
    return sd, "ir_tiny", r"missing key `body\.3\.res_layer\.1\.weight`"


def _module_prefix(sd):
    return {f"module.{k}": v for k, v in sd.items()}, "ir_tiny", None


def _wrong_variant(sd):
    return sd, "ir_50", r"missing key `body\.4\.res_layer\.0\.weight`"


@pytest.mark.parametrize("make", [_extra_keys, _missing_key, _module_prefix,
                                  _wrong_variant],
                         ids=["extra_keys", "missing_key", "module_prefix",
                              "wrong_variant"])
def test_converter_refusals_match_facekit(make):
    """``tests/test_weights_io.py``'s four refusals hold in both packages
    alike: extra keys and a missing key (named) or the wrong variant are
    refused with the same message; ``module.`` prefixes are stripped; and
    with ``strict=False`` the extra keys convert to the same leaves."""
    sd, network, refusal = make(_ir_tiny_sd())
    pair = (convert_arcface_state_dict, jax_convert.convert_arcface_state_dict)
    if refusal is None:
        ours, theirs = (conv(sd, network) for conv in pair)
        assert_same_leaves(ours, tree_np(theirs))
        assert_same_leaves(ours, tree_np(pair[0](_ir_tiny_sd(), network)))
        return
    messages = []
    for conv, err in zip(pair, (ConversionError,
                                jax_convert.ConversionError)):
        with pytest.raises(err, match=refusal) as e:
            conv(sd, network)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    if make is _extra_keys:
        assert_same_leaves(pair[0](sd, network, strict=False),
                           tree_np(pair[1](sd, network, strict=False)))


def _template(tree):
    """A restore template of the tree's structure, zero-filled: the
    structure of ``arcface_init`` / ``retinaface_init`` /
    ``quantize_arcface_params`` (``tests/test_torch_arcface.py`` and
    ``test_torch_detect.py`` hold the port's random trees to it), without
    tracing facekit's random initializers."""
    return jax.tree.map(np.zeros_like, tree)


def _file_case(case):
    if case == "retinaface":
        return random_retinaface_params(seed=9)
    tree = random_arcface_params("ir_tiny", seed=9)
    if case == "int8":
        tree = tree_np(quantize_arcface_params(jax.tree.map(jnp.asarray,
                                                            tree)))
    return tree


@pytest.mark.parametrize("case", ["arcface", "retinaface", "int8"])
def test_param_files_cross_load(case, tmp_path):
    """A file the port writes is the file facekit writes, byte for byte.
    facekit's ``load_params`` restores it into a template, and the
    port's ``load_params`` reads facekit's file, leaf for leaf; each side
    is compared with the tree from both ends (flax's restore drops keys
    its template lacks), int8 leaves stay int8 and lists come back as maps
    keyed "0", "1", ..."""
    tree = _file_case(case)
    ours, theirs = str(tmp_path / "ours.msgpack"), str(tmp_path / "j.msgpack")
    save_params(tree, ours)
    jax_save_params(tree, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert_same_leaves(serialization.msgpack_restore(data), tree)
    assert_same_leaves(tree_np(jax_load_params(_template(tree), ours)),
                       tree)
    loaded = load_params(theirs)
    assert_same_leaves(loaded, tree)
    lists = loaded["stage1" if case == "retinaface" else "blocks"]
    assert list(lists) == [str(i) for i in range(len(lists))]
    if case == "int8":
        assert loaded["blocks"]["0"]["conv1"]["q"].dtype == np.int8


def test_save_params_refuses_unknown_leaves(tmp_path):
    with pytest.raises(TypeError, match="object"):
        save_params({"a": object()}, str(tmp_path / "x.msgpack"))


def _write_ckpt(path, sd, wrap):
    """torch.save a state_dict the ways reference checkpoints come:
    plain, or under "state_dict" with DataParallel prefixes."""
    if wrap:
        sd = {"state_dict": {f"module.{k}": v for k, v in sd.items()},
              "epoch": 3}
    torch.save(sd, path)


@pytest.mark.parametrize("model", ["arcface", "retinaface"])
def test_cli_end_to_end_on_cpu(model, tmp_path, capsys):
    """checkpoint file -> ``python -m facekit_torch.weights`` -> a file
    facekit loads with the original leaves; ``--verify --device cpu``
    runs the port's model from it."""
    if model == "arcface":
        tree = random_arcface_params("ir_tiny", seed=10)
        sd, extra = arcface_state_dict(tree), ["--network", "ir_tiny"]
    else:
        tree = random_retinaface_params(seed=10)
        sd, extra = retinaface_state_dict(tree), []
    ckpt, out = str(tmp_path / "m.pth"), str(tmp_path / "m.msgpack")
    _write_ckpt(ckpt, sd, wrap=model == "arcface")
    assert "module.input_layer.0.weight" not in load_torch_checkpoint(ckpt)
    cli_main([model, ckpt, out, "--verify", "--device", "cpu", *extra])
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed
    if model == "arcface":
        assert "verify: emb (1, 512) finite=True norm=[1." in printed
    else:
        assert "verify: [(1, 3780, 4), (1, 3780, 2), (1, 3780, 10)] " \
               "finite = True" in printed
    assert_same_leaves(tree_np(jax_load_params(_template(tree), out)), tree)


def test_cli_refusals(tmp_path, capsys):
    """``train-checkpoint`` without ``--num-classes`` exits non-zero
    naming the flag, as facekit's CLI does, and with it refuses a path
    that is not a train checkpoint; a light-detector mode refuses a checkpoint of another
    model, naming the missing key; ``--verify`` defaults to the card and,
    without one, raises before anything is written; unconsumed keys need
    ``--no-strict``."""
    ckpt, out = str(tmp_path / "m.pth"), str(tmp_path / "m.msgpack")
    sd = _ir_tiny_sd()
    sd["head.kernel"] = torch.zeros(3)
    torch.save(sd, ckpt)
    with pytest.raises(SystemExit) as e:
        cli_main(["train-checkpoint", ckpt, out])
    assert e.value.code != 0
    assert "--num-classes" in capsys.readouterr().err
    with pytest.raises(ValueError, match="is a file"):
        cli_main(["train-checkpoint", ckpt, out, "--network", "ir_tiny",
                  "--num-classes", "3"])
    assert not os.path.exists(out)
    for mode in ("slim", "rfb"):
        with pytest.raises(ConversionError, match=r"missing key `conv1\.0"):
            cli_main([mode, ckpt, out])
        assert not os.path.exists(out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli_main(["arcface", ckpt, out, "--network", "ir_tiny",
                      "--verify"])
        assert not os.path.exists(out)
    with pytest.raises(ConversionError, match="head.kernel"):
        cli_main(["arcface", ckpt, out, "--network", "ir_tiny"])
    cli_main(["arcface", ckpt, out, "--network", "ir_tiny", "--no-strict"])
    assert "blocks" in load_params(out)


def test_cli_runs_as_a_module(tmp_path):
    """``python -m facekit_torch.weights`` in a fresh interpreter, which
    loads no JAX."""
    ckpt, out = str(tmp_path / "d.pth"), str(tmp_path / "d.msgpack")
    torch.save(retinaface_state_dict(random_retinaface_params(seed=11)), ckpt)
    code = ("import runpy, sys\n"
            "sys.argv = ['facekit_torch.weights'] + sys.argv[1:]\n"
            "runpy.run_module('facekit_torch.weights', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'facekit')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code, "retinaface", ckpt,
                          out, "--verify", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "finite = True" in res.stdout
    det = RetinaFace(with_landmarks=True)
    det.load_state_dict(from_jax(load_params(out), det))


def test_ir50_checkpoint_to_port_embeddings(tmp_path):
    """One IR-50 ``.pth`` through the port's CLI: the port's embeddings
    from the written file agree with facekit's conversion through
    ``arcface_apply`` in f32 within 1e-4 (the bar of
    ``tests/test_torch_arcface.py``)."""
    tree = random_arcface_params("ir_50", seed=12)
    ckpt, out = str(tmp_path / "ir50.pth"), str(tmp_path / "ir50.msgpack")
    _write_ckpt(ckpt, arcface_state_dict(tree), wrap=True)
    cli_main(["arcface", ckpt, out])
    net = ArcFace("ir_50")
    net.load_state_dict(from_jax(load_params(out), net))
    x = np.random.default_rng(13).uniform(-1, 1, (1, 112, 112, 3)) \
        .astype(np.float32)
    with torch.inference_mode():
        ours = net.eval()(torch.tensor(x)).numpy()
    theirs = jax_convert.convert_arcface_state_dict(
        jax_convert.load_torch_checkpoint(ckpt), "ir_50")
    ref = np.asarray(arcface_apply(theirs, jnp.asarray(x), network="ir_50",
                                   dtype=jnp.float32))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
