"""facekit_torch.engine: the registered ops, the exported recognize and
embed programs, their refusals and the export CLI, against the eager
pipeline and against facekit's ``FacePipeline``, whose own engines equal
it (``tests/test_engine.py``).

Small models (``ir_tiny``; RetinaFace at full width on 120x160 frames and
a 64x64 detector input); each artifact is exported once per module. Random
detector weights score every anchor near 0.55, so a threshold of 0.5
finds four faces in any frame.
"""

import dataclasses
import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

from facekit.config import FaceKitConfig as JaxConfig
from facekit.pipeline import FacePipeline as JaxPipeline
from facekit_torch.config import FaceKitConfig
from facekit_torch.engine import (engine_states, export_embed_engine,
                                  export_engines, export_recognize_engine,
                                  load_engine, load_serving_engines, main,
                                  read_meta, save_engine, state_signature)
from facekit_torch.ops.boxes import _select_faces_eager
from facekit_torch.ops.conv_s8 import conv_s8_reference
from facekit_torch.ops.ir_block import ir_block_reference
from facekit_torch.ops.similarity import (cosine_topk_int8_reference,
                                          cosine_topk_reference,
                                          quantize_rows_int8)
from facekit_torch.pipeline import FacePipeline
from facekit_torch.weights import (random_arcface_params,
                                   random_retinaface_params)

_CFG = dict(rec_network="ir_tiny", compute_dtype="float32",
            gallery_dtype="float32", det_inputShape=(3, 64, 64),
            input_frameWidth=160, input_frameHeight=120,
            det_threshold_bbox=0.5, extras={"rec_useAlignment": True})
_B = 2


def _params():
    return random_arcface_params("ir_tiny", seed=4), random_retinaface_params(
        seed=0)


def _frames(seed, n=_B):
    return np.random.default_rng(seed).integers(0, 256, (n, 120, 160, 3),
                                                dtype=np.uint8)


def _crops(seed, n=_B):
    return np.random.default_rng(seed).integers(0, 256, (n, 112, 112, 3),
                                                dtype=np.uint8)


class _F32(NamedTuple):
    pipe: FacePipeline
    out: str                # the engines directory
    records: list           # export_engines' records
    recognize: object       # the loaded programs
    embed: object


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """The f32 pipeline and its recognize / embed pair at batch 2, with
    crops, exported on the CPU into one directory and loaded back."""
    rp, dp = _params()
    pipe = FacePipeline(FaceKitConfig(**_CFG), rp, dp, device="cpu")
    out = str(tmp_path_factory.mktemp("engines"))
    records = export_engines(pipe, out, [_B])
    return _F32(pipe, out, records,
                *(load_engine(os.path.join(out, f"{name}.fke"), "cpu")[0]
                  for name in ("recognize", "embed")))


def _run(fn, *args):
    with torch.inference_mode():
        return fn(*args)


# -- the registered ops ---------------------------------------------------------

def _op_cases():
    """(op, args, plain function) per registered op, on seeded inputs."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(40, 512)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = torch.tensor(g[[3, 7, 7]] + 0.01 * rng.normal(size=(3, 512)),
                     dtype=torch.float32)
    gt = torch.tensor(g)
    gq, gs = quantize_rows_int8(gt)
    x8 = torch.tensor(rng.integers(-127, 128, (2, 9, 9, 16)), dtype=torch.int8)
    w8 = torch.tensor(rng.integers(-127, 128, (8, 3, 3, 16)), dtype=torch.int8)
    c = 64
    x = torch.tensor(rng.normal(size=(2, 6, 6, c)), dtype=torch.float32)
    w1, w2 = (torch.tensor(rng.normal(0, 0.05, (c, 3, 3, c)),
                           dtype=torch.float32) for _ in range(2))
    par = torch.tensor(np.stack([rng.uniform(0.5, 1.5, c),
                                 rng.normal(0, 0.1, c),
                                 rng.uniform(0, 0.3, c),
                                 rng.uniform(0.5, 1.5, c),
                                 rng.normal(0, 0.1, c)]), dtype=torch.float32)
    ops = torch.ops.facekit_torch
    return {
        "cosine_topk": (ops.cosine_topk, (gt, q, 30, 5),
                        cosine_topk_reference),
        "cosine_topk_int8": (ops.cosine_topk_int8, (gq, gs, q, 30, 5),
                             cosine_topk_int8_reference),
        "conv_s8": (ops.conv_s8, (x8, w8, 2, 1, 1), conv_s8_reference),
        "ir_block": (ops.ir_block, (x, w1, w2, par), ir_block_reference),
    }


def _select_case(pipe):
    """select_faces' arguments on the detector outputs of two frames, at
    the config's statics (the exactness fallback among them)."""
    cfg = pipe.config
    loc, conf, ldm = pipe._detector_outputs(torch.tensor(_frames(1)))
    return (loc, conf, pipe.anchors, ldm, list(cfg.frame_hw),
            list(cfg.det_hw), cfg.det_maxFacesPerScene,
            cfg.det_threshold_bbox, cfg.det_threshold_nms, cfg.det_nmsTopK,
            cfg.det_nmsExact)


@pytest.mark.parametrize("name", ["cosine_topk", "cosine_topk_int8",
                                  "conv_s8", "ir_block"])
def test_kernel_op_is_its_plain_version_on_cpu(name):
    """Each kernel's op on CPU tensors equals its plain version bit for
    bit, and ``torch.library.opcheck`` (schema, fake, dispatch) passes."""
    op, args, plain = _op_cases()[name]
    got, want = op(*args), plain(*args)
    for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert torch.equal(a, b)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("with_ldm", [True, False])
def test_select_faces_op_is_the_eager_selection(f32, with_ldm):
    pipe = f32.pipe
    args = list(_select_case(pipe))
    if not with_ldm:
        args[3] = None
    boxes, scores, valid, points = torch.ops.facekit_torch.select_faces(
        *args)
    det = _select_faces_eager(*args[:3], tuple(args[4]), tuple(args[5]),
                              *args[6:], args[3])
    assert valid.any()
    for a, b in zip((boxes, scores, valid), det[:3]):
        assert torch.equal(a, b)
    if with_ldm:
        assert torch.equal(points, det.landmarks)
    else:
        assert det.landmarks is None and not points.any()
    torch.library.opcheck(torch.ops.facekit_torch.select_faces, tuple(args))


# -- round trip against the eager pipeline --------------------------------------

def test_export_writes_the_pair_without_weights(f32):
    """One recognize / embed pair with sidecars; the programs keep no
    state and no example inputs: their only tensors are the constants the
    graph computes with (anchors, resize matrices), far below the
    weights."""
    pipe, out, records = f32[:3]
    assert [r["file"] for r in records] == ["recognize.fke", "embed.fke"]
    meta = read_meta(os.path.join(out, "recognize.fke"))
    assert meta["magic"] == "facekit-torch-engine-v1"
    assert meta["device"] == "cpu" and meta["batch_size"] == _B
    assert meta["return_crops"] and not meta["rec_calibrated"]
    det_state, rec_state = engine_states(pipe)
    assert meta["rec_state"] == state_signature(rec_state)
    weights = sum(t.numel() * t.element_size() for s in (det_state, rec_state)
                  for t in s.values())
    program, _ = export_embed_engine(pipe, 1)
    assert not program.state_dict and program.example_inputs is None
    consts = sum(t.numel() * t.element_size()
                 for t in program.constants.values())
    assert consts < weights / 10
    for r in records:
        assert r["bytes"] == os.path.getsize(os.path.join(out, r["file"]))


def test_recognize_engine_equals_eager(f32):
    """Boxes, scores, valid, embeddings and crops equal the eager
    ``recognize_frames`` bit for bit: the program runs the same aten ops
    and the same selection on the same inputs."""
    pipe = f32.pipe
    frames = _frames(1)
    ds, rs = engine_states(pipe)
    got = _run(f32.recognize, ds, rs, torch.tensor(frames))
    ref = pipe.recognize_frames(frames, return_crops=True)
    assert ref.valid.any()
    for a, b in zip(got, (ref.boxes, ref.scores, ref.valid, ref.embeddings,
                          ref.crops)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_embed_engine_equals_eager(f32):
    pipe = f32.pipe
    crops = _crops(2)
    _, rs = engine_states(pipe)
    got = _run(f32.embed, rs, torch.tensor(crops))
    assert torch.equal(got, pipe._embed(torch.tensor(crops)))


def test_engine_matches_facekit(f32):
    """The loaded engines against facekit's pipeline on the same params:
    embeddings within 1e-4, boxes and landmarks-driven slots equal in
    validity, boxes within 1e-3 px (``tests/test_torch_pipeline.py``'s
    bars)."""
    rp, dp = _params()
    ref = JaxPipeline(JaxConfig(**_CFG), dp, rp)
    frames, crops = _frames(3), _crops(4)
    ds, rs = engine_states(f32.pipe)
    boxes, scores, valid, emb, _ = _run(f32.recognize, ds, rs,
                                        torch.tensor(frames))
    r = ref.recognize_frames(frames)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r.valid))
    assert valid.all()
    np.testing.assert_allclose(boxes.numpy(), np.asarray(r.boxes), atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(r.scores),
                               atol=1e-6)
    np.testing.assert_allclose(emb.numpy(), np.asarray(r.embeddings),
                               atol=1e-4)
    got = _run(f32.embed, rs, torch.tensor(crops))
    np.testing.assert_allclose(got.numpy(), ref.embed_cropped_batch(crops),
                               atol=1e-4)


def test_bf16_embed_engine_within_cosine_bar():
    """A bf16 embed engine against facekit's f32 embedder: within the
    1e-3 cosine bar, and equal to the port's eager bf16 path."""
    rp, _ = _params()
    cfg = dict(_CFG, compute_dtype="bfloat16")
    pipe = FacePipeline(FaceKitConfig(**cfg), rp, device="cpu")
    program, meta = export_embed_engine(pipe, 3)
    crops = _crops(5, 3)
    got = _run(program.module(), engine_states(pipe)[1], torch.tensor(crops))
    assert meta["compute_dtype"] == "bfloat16"
    assert torch.equal(got, pipe._embed(torch.tensor(crops)))
    ref = JaxPipeline(JaxConfig(**_CFG), {}, rp).embed_cropped_batch(crops)
    assert (1 - (got.numpy() * ref).sum(-1)).max() < 1e-3


# -- the graphs -----------------------------------------------------------------

def _facekit_ops(graph_owner):
    return sorted({str(n.target) for n in graph_owner.graph.nodes
                   if str(n.target).startswith("facekit_torch.")})


def test_ir50_graph_holds_ir_block_ops():
    """IR-50's 20 stride-1 identity blocks are ``ir_block`` ops in the
    embed graph, their operands computed in the graph from the state
    (ir_tiny has no such block)."""
    cfg = FaceKitConfig(rec_network="ir_50", compute_dtype="bfloat16")
    pipe = FacePipeline(cfg, random_arcface_params("ir_50", seed=1),
                        device="cpu")
    program, _ = export_embed_engine(pipe, 1)
    n = sum(str(n.target) == "facekit_torch.ir_block.default"
            for n in program.graph.nodes)
    assert n == 20
    assert not program.state_dict


def test_int8_graph_holds_conv_s8_ops():
    """``rec_quantize`` + ``det_quantize``: every int8 site is a
    ``conv_s8`` op (47 in RetinaFace, 12 in ir_tiny), selection is one
    ``select_faces`` op, and the program equals the eager path (the f32
    tests cover the file's round trip)."""
    rp, dp = _params()
    pipe = FacePipeline(FaceKitConfig(**dict(
        _CFG, rec_quantize=True, det_quantize=True, gallery_dtype="int8")),
        rp, dp, device="cpu")
    program, meta = export_recognize_engine(pipe, 1, return_crops=True)
    assert meta["rec_quantize"] and meta["det_quantize"]
    ops = [str(n.target) for n in program.graph.nodes]
    assert ops.count("facekit_torch.conv_s8.default") == 47 + 12
    assert ops.count("facekit_torch.select_faces.default") == 1
    frames = _frames(6, 1)
    got = _run(program.module(), *engine_states(pipe), torch.tensor(frames))
    ref = pipe.recognize_frames(frames, return_crops=True)
    for a, b in zip(got, (ref.boxes, ref.scores, ref.valid, ref.embeddings,
                          ref.crops)):
        assert torch.equal(a, b)


def test_f32_graph_ops(f32):
    """The loaded f32 ir_tiny program: one ``select_faces`` op and no
    kernel op (ir_tiny has no identity block)."""
    assert _facekit_ops(f32.recognize) == [
        "facekit_torch.select_faces.default"]


# -- refusals -------------------------------------------------------------------

def _edit(out, tmp_path, name, **fields):
    """A copy of ``out`` whose ``name`` sidecar has ``fields`` changed."""
    dst = str(tmp_path / "edited")
    shutil.copytree(out, dst)
    path = os.path.join(dst, name + ".json")
    meta = json.load(open(path))
    meta.update(fields)
    json.dump(meta, open(path, "w"))
    return dst


def test_refuses_facekit_engine(f32, tmp_path):
    out = f32.out
    dst = _edit(out, tmp_path, "embed.fke", magic="facekit-engine-v1")
    with pytest.raises(ValueError, match=r"facekit \(JAX\) engine"):
        read_meta(os.path.join(dst, "embed.fke"))
    with pytest.raises(ValueError, match="JAX"):
        load_serving_engines(dst, f32.pipe.config, f32.pipe, [_B])
    os.remove(os.path.join(dst, "embed.fke.json"))
    with pytest.raises(ValueError, match="sidecar"):
        load_engine(os.path.join(dst, "embed.fke"))


@pytest.mark.parametrize("field,override", [
    ("rec_network", {"rec_network": "ir_50"}),
    ("det_threshold_bbox", {"det_threshold_bbox": 0.6}),
    ("det_threshold_nms", {"det_threshold_nms": 0.3}),
    ("frame_hw", {"input_frameWidth": 320}),
    ("compute_dtype", {"compute_dtype": "bfloat16"}),
    ("det_nms_top_k", {"det_nmsTopK": 64})])
def test_refuses_stale_statics(f32, field, override):
    """A config that differs in a frozen static refuses, naming it."""
    pipe, out = f32[:2]
    cfg = dataclasses.replace(pipe.config, **override)
    with pytest.raises(ValueError, match=f"{field}=.*re-export"):
        load_serving_engines(out, cfg, pipe, [_B])


def test_refuses_no_crops_and_other_device(f32, tmp_path):
    pipe, out = f32[:2]
    dst = _edit(out, tmp_path, "recognize.fke", return_crops=False)
    with pytest.raises(ValueError, match="--no-crops"):
        load_serving_engines(dst, pipe.config, pipe, [_B])
    shutil.rmtree(dst)
    dst = _edit(out, tmp_path, "embed.fke", device="cuda")
    with pytest.raises(ValueError, match="device='cuda'"):
        load_engine(os.path.join(dst, "embed.fke"), "cpu")
    with pytest.raises(ValueError, match="device='cuda'"):
        load_serving_engines(dst, pipe.config, pipe, [_B])


def test_refuses_differing_state(f32):
    """An embedder of another width: every static agrees but the state
    signature, and the first entry that differs is named."""
    pipe, out = f32[:2]
    cfg = dataclasses.replace(pipe.config, rec_outputDim=256)
    other = FacePipeline(cfg, random_arcface_params(
        "ir_tiny", seed=4, embed_dim=256), _params()[1], device="cpu")
    with pytest.raises(ValueError, match="rec_state differs.*output.linear"):
        load_serving_engines(out, cfg, other, [_B])


def test_calibrated_and_dynamic_int8_differ(tmp_path):
    """A calibrated int8 embedder holds an ``ascale`` per site that a
    dynamic one lacks: an engine of one refuses the other, by
    ``rec_calibrated`` and by its state."""
    rp, _ = _params()
    cfg = FaceKitConfig(**dict(_CFG, rec_quantize=True, gallery_dtype="int8"))
    dyn = FacePipeline(cfg, rp, device="cpu")
    cal = FacePipeline(cfg, rp, device="cpu")
    cal.calibrate_embedder([_crops(7, 4)])
    sig_d = state_signature(engine_states(dyn)[1])
    sig_c = state_signature(engine_states(cal)[1])
    ascales = [s[0] for s in sig_c if s[0].endswith(".ascale")]
    assert len(ascales) == 12 and not any(
        s[0].endswith(".ascale") for s in sig_d)
    program, meta = export_embed_engine(dyn, 1)
    save_engine(str(tmp_path / "embed.fke"), program, meta)
    with pytest.raises(ValueError, match="rec_calibrated=False"):
        load_serving_engines(str(tmp_path), cfg, cal, [1])
    crops = _crops(8, 1)
    got = _run(program.module(), engine_states(dyn)[1], torch.tensor(crops))
    assert torch.equal(got, dyn._embed(torch.tensor(crops)))


# -- the CLI --------------------------------------------------------------------

def _config_file(tmp_path, **fields):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(fields))
    return str(path)


def test_cli_refuses_unusable_calibration(tmp_path):
    cfg = _config_file(tmp_path, rec_network="ir_tiny", rec_quantize=True,
                       compute_dtype="float32",
                       rec_calibrationDir=str(tmp_path / "missing"))
    with pytest.raises(SystemExit, match="rec_calibrationDir"):
        main(["export", "-c", cfg, "-o", str(tmp_path / "e"),
              "--device", "cpu"])
    assert not os.path.exists(tmp_path / "e")


_IDENTIFY_ARGS = ["--identify-mesh", "gallery=2", "--gallery-rows", "1024"]


@pytest.fixture(scope="module")
def identify_cli(tmp_path_factory):
    """One CLI export with both identify options, ``_IDENTIFY_ARGS``:
    the config's pair at batch 2 and one identify engine beside it,
    over a 2-position mesh (the CPU at both)."""
    tmp = tmp_path_factory.mktemp("identify_cli")
    cfg = _config_file(tmp, **dict(_CFG, extras=dict(
        _CFG["extras"], server_batchSize=2)))
    out = str(tmp / "e")
    main(["export", "-c", cfg, "-o", out, "--device", "cpu",
          *_IDENTIFY_ARGS])
    return out


@pytest.mark.parametrize("flag", [["--platforms", "cpu"],
                                  ["--identify-mesh", "gallery=2"],
                                  ["--topology", "v5e:2x4"],
                                  ["--gallery-rows", "1024"]])
def test_cli_refuses_parallel_options(request, tmp_path, flag, capsys):
    """facekit's multi-device export options. ``--platforms`` and
    ``--topology`` name XLA backends and TPU slices: refused by design,
    exit 2, with that reason. ``--identify-mesh`` and ``--gallery-rows``
    export (one export given both, ``identify_cli``): one identify
    engine beside the pair, over the mesh at the frozen capacity."""
    if flag[0] in ("--platforms", "--topology"):
        with pytest.raises(SystemExit) as e:
            main(["export", "-o", str(tmp_path / "e"), "--device", "cpu",
                  *flag])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "by design" in err and "TPU" in err
        assert "not ported" not in err
        return
    i = _IDENTIFY_ARGS.index(flag[0])
    assert _IDENTIFY_ARGS[i:i + 2] == flag
    out = request.getfixturevalue("identify_cli")
    meta = read_meta(os.path.join(out, "identify.fke"))
    assert meta["program"] == "identify" and meta["batch_size"] == 2
    if flag[0] == "--identify-mesh":
        assert sorted(f for f in os.listdir(out) if f.endswith(".fke")) \
            == ["embed.fke", "identify.fke", "recognize.fke"]
        assert meta["mesh_shape"] == {"gallery": 2}
        assert meta["mesh_devices"] == ["cpu"] * meta["positions"] == \
            ["cpu"] * 2
    else:
        assert meta["gallery_rows"] == 1024
