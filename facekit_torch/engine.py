"""Serialized serving programs ("engines") of the port.

Port of ``facekit/engine.py``, on one device or a mesh. The reference
boots from prebuilt TensorRT engines (``src/arcface.cpp:45-69``,
``src/retinaface.cpp:31-55``); facekit from ``jax.export`` artifacts; the
port from ``torch.export`` programs: config geometry and thresholds frozen
in, static shapes, loadable and callable without the model-building code.
As in facekit the weights stay outside the file: each program takes the
detector's and the embedder's state dicts as inputs (``engine_states``),
and the sidecar records every state entry's name, shape and dtype, so a
pipeline whose state differs refuses to load.

Two programs (the two engines the reference loads):

  * ``recognize``: (det_state, rec_state, frames (B, H, W, 3) u8) ->
    (boxes, scores, valid, embeddings[, crops]), the WS /inference path;
  * ``embed``: (rec_state, crops (B, rec_h, rec_w, 3) u8) -> (B, D), the
    POST /recognize path.

And the identify engine (facekit's ``identify.fke``,
``export_identify_engine``): the whole WS /inference transaction, detect
-> align -> embed -> gallery match, as one program, optionally over a
device mesh (frames split over ``"data"``, gallery rows over
``"gallery"``):

  * ``identify``: (det_states, rec_states, gallery blocks, count, frames
    (B, H, W, 3) u8[, scale blocks]) -> (boxes, scores, valid,
    embeddings, sims, idx[, crops]). One state dict per data position,
    on its device; one gallery block per (data, gallery) position of the
    search; ``count`` a 0-d int64 CPU tensor, a runtime value of the
    program (each shard's live rows are computed from it in the graph),
    so one engine serves every gallery count up to its frozen capacity.

All three trace the functions the eager pipeline runs
(``recognize_program``, ``embed_program``, ``identify_program``). The
four kernels and the face selection are ``torch.library`` ops
(``facekit_torch::ir_block``, ``conv_s8``, ``cosine_topk``,
``cosine_topk_int8``, ``select_faces``), so a loaded program on CUDA
launches the same kernels as the eager path. An identify engine is
loaded by ``IdentifyEngine`` (standalone) or by a ``FaceServer`` with
``mesh_shape`` and an engines directory (``load_identify_engines``).

facekit's ``--topology`` and ``--platforms`` are refused by design: they
name TPU slices and XLA backends, and a torch engine is exported on the
device it serves from (``--device``).

CLI:  python -m facekit_torch.engine export -c config.json -o engines/
        [-b 1,8] [--no-crops] [--device cuda|cpu]
        [--identify-mesh data=2,gallery=2 [--gallery-rows 1048576]]
"""

from __future__ import annotations

import itertools
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

import facekit_torch.ops  # noqa: F401  (registers the ops before a load)
from facekit_torch.ops.similarity import DIM
from facekit_torch.parallel import (ShardedRows, canonical, make_mesh,
                                    search_positions)
from facekit_torch.pipeline.recognize import (_mesh_data_axis, _own_frames,
                                              data_devices, embed_program,
                                              identify_program,
                                              recognize_program)
from facekit_torch.utils.device import resolve_device

_MAGIC = "facekit-torch-engine-v1"
_JAX_MAGIC = "facekit-engine-v1"      # facekit's own artifacts
_PROGRAMS = ("recognize", "embed")
#: facekit's export options that describe XLA, refused by design
_BY_DESIGN = ("--platforms", "--topology")
_GALLERY_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                   "float32": torch.float32}


def engine_states(pipeline) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """The (detector, embedder) state dicts the programs take as inputs:
    every parameter and buffer of each network, as it serves."""
    det = (pipeline.det_net.state_dict() if pipeline.det_net is not None
           else {})
    return det, pipeline.rec_net.state_dict()


def state_signature(state: Dict[str, torch.Tensor]) -> List[List[Any]]:
    """[name, shape, dtype] of every entry, in order."""
    return [[k, list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in state.items()]


def _quant_meta(pipeline) -> Dict[str, Any]:
    """Quantization state for the metadata (``facekit/engine.py:52-66``),
    from the embedder's form: a calibrated int8 embedder ("static", or
    "residual" with its s8 block outputs) holds an ``ascale`` per site
    that a dynamic one lacks, a residual one an ``oscale`` per block too
    (their state signatures differ as well)."""
    cfg = pipeline.config
    quantized = bool(cfg.rec_quantize)
    form = pipeline.rec_net.int8
    return {"rec_quantize": quantized,
            "rec_calibrated": quantized and form in ("static", "residual"),
            "rec_int8_residual": quantized and form == "residual",
            "det_quantize": bool(cfg.det_quantize)}


class _Program(nn.Module):
    """A function as the module ``torch.export`` traces. It holds no
    parameter or buffer, so the artifact holds no weights."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _bind(module: nn.Module, state: Dict[str, torch.Tensor]):
    """``module`` run on ``state`` in place of its own tensors; strict, so
    no tensor of the module is captured into the graph."""
    return lambda *args: torch.func.functional_call(module, state, args,
                                                    strict=True)


def _export(fn, args) -> torch.export.ExportedProgram:
    """``fn`` traced at the static shapes of ``args``. The program keeps
    no example inputs (they hold the weights), and drops the
    ``_assert_tensor_metadata`` checks export puts after each dtype cast:
    they compute nothing, and each costs the host one more dispatch per
    call on a path that the host bounds (PERF.md section 5)."""
    with torch.no_grad():
        program = torch.export.export(_Program(fn), args, strict=False)
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    program.graph_module.recompile()
    program.example_inputs = None
    return program


def export_recognize_engine(pipeline, batch_size: int,
                            return_crops: bool = False):
    """Export the detect -> align -> embed program at a fixed batch, on
    the pipeline's device. Returns (ExportedProgram, metadata). The
    pipeline's statics (shapes, thresholds, networks, alignment, the
    anchors) are frozen in; ``return_crops`` adds the aligned crops as a
    fifth output, which the WS /inference reply needs (the CLI default)."""
    cfg = pipeline.config
    if pipeline.det_net is None:
        raise ValueError("export_recognize_engine needs a pipeline with a "
                         "detector (det_params)")
    det_state, rec_state = engine_states(pipeline)

    def fn(det_state, rec_state, frames):
        res = recognize_program(pipeline, _bind(pipeline.det_net, det_state),
                                _bind(pipeline.rec_net, rec_state), frames,
                                return_crops)
        out = (res.boxes, res.scores, res.valid, res.embeddings)
        return out + ((res.crops,) if return_crops else ())

    fh, fw = cfg.frame_hw
    frames = torch.zeros((batch_size, fh, fw, 3), dtype=torch.uint8,
                         device=pipeline.device)
    program = _export(fn, (det_state, rec_state, frames))
    meta = {
        "magic": _MAGIC,
        "program": "recognize",
        "batch_size": batch_size,
        "frame_hw": list(cfg.frame_hw),
        "max_faces": cfg.det_maxFacesPerScene,
        "det_network": cfg.det_network,
        "rec_network": cfg.rec_network,
        "compute_dtype": cfg.compute_dtype,
        "return_crops": bool(return_crops),
        "device": pipeline.device.type,
        "det_hw": list(cfg.det_hw),
        "det_threshold_bbox": cfg.det_threshold_bbox,
        "det_threshold_nms": cfg.det_threshold_nms,
        "det_nms_top_k": cfg.det_nmsTopK,
        "det_nms_exact": bool(cfg.det_nmsExact),
        "align": bool(pipeline.align),
        "with_landmarks": bool(pipeline.use_landmarks),
        **_quant_meta(pipeline),
        "det_state": state_signature(det_state),
        "rec_state": state_signature(rec_state),
    }
    return program, meta


def export_embed_engine(pipeline, batch_size: int):
    """Export the crop -> embedding program (the /recognize path)."""
    cfg = pipeline.config
    _, rec_state = engine_states(pipeline)

    def fn(rec_state, crops):
        return embed_program(_bind(pipeline.rec_net, rec_state), crops)

    rh, rw = cfg.rec_hw
    crops = torch.zeros((batch_size, rh, rw, 3), dtype=torch.uint8,
                        device=pipeline.device)
    program = _export(fn, (rec_state, crops))
    meta = {
        "magic": _MAGIC,
        "program": "embed",
        "batch_size": batch_size,
        "rec_hw": list(cfg.rec_hw),
        "rec_network": cfg.rec_network,
        "compute_dtype": cfg.compute_dtype,
        "device": pipeline.device.type,
        **_quant_meta(pipeline),
        "rec_state": state_signature(rec_state),
    }
    return program, meta


def _data_devices(mesh, batch: int) -> List[torch.device]:
    """The device of each data position a batch of ``batch`` frames splits
    over, in ``identify_program``'s order."""
    return data_devices(mesh, "data", batch, canonical(mesh.home))


def _search_positions(mesh, queries: int) -> List[Tuple[int, torch.device]]:
    """(shard, device) of each search of the match over ``queries``
    queries, in ``sharded_cosine_topk``'s order."""
    return [(s, dev) for _, s, dev in search_positions(
        mesh, "gallery", _mesh_data_axis(mesh, "data", queries))]


def identify_states(pipeline, mesh, batch: int):
    """(det_states, rec_states) an identify engine of batch ``batch``
    takes: the state dicts of the networks each data position runs (the
    served ones on the home device, the pipeline's replicas elsewhere),
    one per position, in position order."""
    if mesh is None:
        det, rec = engine_states(pipeline)
        return (dict(det),), (dict(rec),)
    nets = [pipeline._replica(dev) for dev in _data_devices(mesh, batch)]
    return (tuple(dict(n[0].state_dict()) for n in nets),
            tuple(dict(n[1].state_dict()) for n in nets))


def _check_identify_mesh(mesh, batch_size: int, gallery_rows: int) -> None:
    """facekit's refusals (``facekit/engine.py:225-233``), and a mesh
    without a gallery axis."""
    if "gallery" not in mesh.shape:
        raise ValueError(f"identify engine: mesh {mesh.shape} has no "
                         "'gallery' axis")
    d, g = mesh.shape.get("data", 1), mesh.shape["gallery"]
    if batch_size % d:
        raise ValueError(f"batch_size {batch_size} must divide over "
                         f"the data axis ({d})")
    if gallery_rows % g:
        raise ValueError(f"gallery_rows {gallery_rows} must divide "
                         f"over the gallery axis ({g})")


def export_identify_engine(pipeline, batch_size: int, gallery_rows: int,
                           mesh=None, return_crops: bool = False):
    """Export the whole identification transaction, detect -> align ->
    embed -> gallery match (``pipeline.identify_program``), at batch
    ``batch_size`` against a gallery of ``gallery_rows`` rows, on the
    pipeline's device or over ``mesh`` (frames over ``"data"``, rows
    over ``"gallery"``; the pipeline's device must be the mesh's home).
    Returns (ExportedProgram, metadata): facekit's fields
    (``facekit/engine.py:272-302``) but ``platforms`` and
    ``use_pallas``, and the port's: ``device``, the state signatures,
    the mesh's positions and its devices. ``return_crops`` adds the
    aligned crops as a seventh output, which the server's WS reply
    needs."""
    cfg = pipeline.config
    if pipeline.det_net is None:
        raise ValueError("export_identify_engine needs a pipeline with a "
                         "detector (det_params)")
    home = canonical(pipeline.device)
    if mesh is not None:
        _check_identify_mesh(mesh, batch_size, gallery_rows)
        if canonical(mesh.home) != home:
            raise ValueError(f"identify engine: the pipeline serves on "
                             f"{home} but the mesh's home is {mesh.home}")
    # the served gallery's rows (GalleryStore's dtype)
    dtype_name = cfg.gallery_dtype
    dtype = _GALLERY_DTYPES[dtype_name]
    int8 = dtype == torch.int8
    width = DIM if home.type == "cuda" else cfg.rec_outputDim
    k = cfg.gallery_topk
    det_states, rec_states = identify_states(pipeline, mesh, batch_size)
    # distinct example tensors at every position: positions that share a
    # device get one tensor each at the call, which export must not see
    # as one input
    det_states, rec_states = (
        tuple({n: t.clone() for n, t in st.items()} for st in states)
        for states in (det_states, rec_states))
    if mesh is None:
        positions = [(0, home)]
        nets = [(pipeline.det_net, pipeline.rec_net)]
    else:
        positions = _search_positions(
            mesh, batch_size * cfg.det_maxFacesPerScene)
        nets = [pipeline._replica(dev)[:2]
                for dev in _data_devices(mesh, batch_size)]
    n_local = gallery_rows // len({s for s, _ in positions})

    def blocks_like(shape, dt):
        # empty: the trace reads only their shapes (on the CPU the pages
        # of a large capacity are never touched)
        return tuple(torch.empty(shape, dtype=dt, device=dev)
                     for _, dev in positions)
    blocks = blocks_like((n_local, width), dtype)
    scales = blocks_like((n_local,), torch.float32) if int8 else None

    def rows(parts):
        if mesh is None:
            return parts[0]
        per = [{} for _ in range(mesh.shape["gallery"])]
        for (s, dev), t in zip(positions, parts):
            per[s][dev] = t
        return ShardedRows(mesh, "gallery", per)

    def fn(det_states, rec_states, blocks, count, frames, *rest):
        live = count.item()
        torch._check(live >= 0)
        torch._check(live <= gallery_rows)
        res, sims, idx = identify_program(
            pipeline, lambda j, dev: (_bind(nets[j][0], det_states[j]),
                                      _bind(nets[j][1], rec_states[j])),
            rows(blocks), live, frames, return_crops, k,
            rows(rest[0]) if rest else None, mesh)
        out = (res.boxes, res.scores, res.valid, res.embeddings, sims, idx)
        return out + ((res.crops,) if return_crops else ())

    fh, fw = cfg.frame_hw
    frames = torch.zeros((batch_size, fh, fw, 3), dtype=torch.uint8,
                         device=home)
    count = torch.tensor(gallery_rows, dtype=torch.int64)
    program = _export(fn, (det_states, rec_states, blocks, count, frames)
                      + ((scales,) if int8 else ()))
    devices = ([home] if mesh is None
               else [canonical(d) for d in mesh.devices.flat])
    meta = {
        "magic": _MAGIC,
        "program": "identify",
        "batch_size": batch_size,
        "gallery_rows": gallery_rows,
        "gallery_width": width,
        "embed_dim": cfg.rec_outputDim,
        "gallery_dtype": dtype_name,
        "gallery_topk": k,
        "return_crops": bool(return_crops),
        "frame_hw": list(cfg.frame_hw),
        "max_faces": cfg.det_maxFacesPerScene,
        "det_network": cfg.det_network,
        "rec_network": cfg.rec_network,
        "compute_dtype": cfg.compute_dtype,
        "mesh_shape": None if mesh is None else mesh.shape,
        "det_hw": list(cfg.det_hw),
        "det_threshold_bbox": cfg.det_threshold_bbox,
        "det_threshold_nms": cfg.det_threshold_nms,
        "det_nms_top_k": cfg.det_nmsTopK,
        "det_nms_exact": bool(cfg.det_nmsExact),
        "align": bool(pipeline.align),
        "with_landmarks": bool(pipeline.use_landmarks),
        **_quant_meta(pipeline),
        "device": home.type,
        "positions": len(devices),
        "mesh_devices": [str(d) for d in devices],
        "det_state": state_signature(det_states[0]),
        "rec_state": state_signature(rec_states[0]),
    }
    return program, meta


def save_engine(path: str, program: torch.export.ExportedProgram,
                meta: Dict[str, Any]) -> None:
    with open(path, "wb") as f:      # a file object: any suffix
        torch.export.save(program, f)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def read_meta(path: str) -> Dict[str, Any]:
    """An engine's sidecar; refuses a file that is not the port's."""
    if not os.path.exists(path + ".json"):
        raise ValueError(f"{path}: missing {path}.json sidecar "
                         "(not a facekit_torch engine?)")
    with open(path + ".json") as f:
        meta = json.load(f)
    magic = meta.get("magic")
    if magic == _JAX_MAGIC:
        raise ValueError(f"{path}: a facekit (JAX) engine, not a "
                         "facekit_torch one; export it with `python -m "
                         "facekit_torch.engine export`")
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a facekit_torch engine "
                         f"(magic {magic!r})")
    return meta


def load_engine(path: str, device=None):
    """Load an engine; returns (callable, metadata). The callable takes the
    arguments of ``meta["program"]`` (see the module docstring). With
    ``device``, an engine exported on another device type refuses before
    it is read."""
    meta = read_meta(path)
    if device is not None:
        want = torch.device(device).type
        if meta.get("device") != want:
            raise ValueError(
                f"{path}: engine was exported with device="
                f"{meta.get('device')!r} but this process serves on "
                f"{want!r}; re-export with `python -m facekit_torch.engine "
                f"export --device {want}`")
    with open(path, "rb") as f:
        program = torch.export.load(f)
    return program.module(), meta


def _check_meta(path: str, meta: Dict[str, Any], field: str,
                expect: Any) -> None:
    got = meta.get(field)
    if got != expect:
        raise ValueError(
            f"{path}: engine was built with {field}={got!r} but the serving "
            f"config needs {expect!r}; re-export with `python -m "
            f"facekit_torch.engine export` from this config")


def _check_state(path: str, meta: Dict[str, Any], field: str,
                 state: Dict[str, torch.Tensor]) -> None:
    """Refuse a pipeline whose state differs from the exported one, naming
    the first entry that differs."""
    for i, (g, w) in enumerate(itertools.zip_longest(
            meta.get(field) or [], state_signature(state))):
        if g != w:
            raise ValueError(
                f"{path}: {field} differs from the serving pipeline's at "
                f"entry {i}: engine {g}, pipeline {w}; re-export with "
                "`python -m facekit_torch.engine export` from this config "
                "and these weights")


def _check_pipeline_statics(path: str, meta: Dict[str, Any], cfg,
                            pipeline, quant: Dict[str, Any],
                            kind: str = "recognize") -> None:
    """The frozen statics of a recognize or identify artifact
    (``facekit/engine.py:489-515``)."""
    _check_meta(path, meta, "rec_network", cfg.rec_network)
    _check_meta(path, meta, "compute_dtype", cfg.compute_dtype)
    _check_meta(path, meta, "rec_quantize", quant["rec_quantize"])
    _check_meta(path, meta, "rec_calibrated", quant["rec_calibrated"])
    _check_meta(path, meta, "rec_int8_residual", quant["rec_int8_residual"])
    _check_meta(path, meta, "det_quantize", quant["det_quantize"])
    _check_meta(path, meta, "frame_hw", list(cfg.frame_hw))
    _check_meta(path, meta, "max_faces", cfg.det_maxFacesPerScene)
    _check_meta(path, meta, "det_network", cfg.det_network)
    _check_meta(path, meta, "det_hw", list(cfg.det_hw))
    _check_meta(path, meta, "det_threshold_bbox", cfg.det_threshold_bbox)
    _check_meta(path, meta, "det_threshold_nms", cfg.det_threshold_nms)
    _check_meta(path, meta, "det_nms_top_k", cfg.det_nmsTopK)
    _check_meta(path, meta, "det_nms_exact", bool(cfg.det_nmsExact))
    _check_meta(path, meta, "align", bool(pipeline.align))
    _check_meta(path, meta, "with_landmarks", bool(pipeline.use_landmarks))
    if not meta.get("return_crops"):
        raise ValueError(
            f"{path}: {kind} engine was exported without the crops "
            "output (--no-crops); the server's WS /inference reply needs "
            "the aligned crop; re-export without --no-crops")


def load_serving_engines(engines_dir: str, config, pipeline, batches
                         ) -> Dict[str, Dict[int, Any]]:
    """Load and check the engines in ``engines_dir`` that serve the batch
    ladder ``batches`` (``facekit/engine.py:518-577`` and
    ``facekit/server/app.py:317-332``). Every ``recognize*.fke`` /
    ``embed*.fke`` sidecar is checked against the serving config and
    pipeline (device, geometry, networks, thresholds, quantization state,
    state signature), and a bucket without its pair refuses, before any
    program is read: a mismatched directory refuses at startup, fast.
    Returns ``{"recognize": {batch: callable}, "embed": {batch:
    callable}}`` for the buckets of ``batches``."""
    quant = _quant_meta(pipeline)
    cfg = config
    det_state, rec_state = engine_states(pipeline)
    found: Dict[str, Dict[int, str]] = {p: {} for p in _PROGRAMS}
    for fname in sorted(os.listdir(engines_dir)):
        if not fname.endswith(".fke"):
            continue
        path = os.path.join(engines_dir, fname)
        meta = read_meta(path)
        program = meta.get("program")
        if program == "identify":
            continue      # a mesh server's (load_identify_engines)
        if program not in _PROGRAMS:
            raise ValueError(f"{path}: unknown engine program {program!r}")
        _check_meta(path, meta, "device", pipeline.device.type)
        if program == "recognize":
            _check_pipeline_statics(path, meta, cfg, pipeline, quant)
            _check_state(path, meta, "det_state", det_state)
        else:
            _check_meta(path, meta, "rec_network", cfg.rec_network)
            _check_meta(path, meta, "compute_dtype", cfg.compute_dtype)
            _check_meta(path, meta, "rec_quantize", quant["rec_quantize"])
            _check_meta(path, meta, "rec_calibrated",
                        quant["rec_calibrated"])
            _check_meta(path, meta, "rec_int8_residual",
                        quant["rec_int8_residual"])
            _check_meta(path, meta, "rec_hw", list(cfg.rec_hw))
        _check_state(path, meta, "rec_state", rec_state)
        b = int(meta["batch_size"])
        if b in found[program]:
            raise ValueError(f"{path}: duplicate {program} engine for batch "
                             f"{b} in {engines_dir}")
        found[program][b] = path
    batches = sorted(set(batches))
    missing = [b for b in batches
               if b not in found["recognize"] or b not in found["embed"]]
    if missing:
        have = sorted(set(found["recognize"]) & set(found["embed"]))
        raise ValueError(
            f"{engines_dir}: no engine pair for batch bucket(s) {missing} "
            f"(pairs found: {have}); export the full ladder with `python -m "
            f"facekit_torch.engine export -b {','.join(map(str, batches))}`")
    return {program: {b: load_engine(paths[b])[0] for b in batches}
            for program, paths in found.items()}


def device_map(path: str, exported: Sequence[str],
               serving: Sequence[str]) -> Dict[str, str]:
    """Each device of the export mesh -> the device at the same position
    of the serving mesh. Refuses a map that is not a function: an engine
    exported with one device at several positions cannot tell which of
    them a copy in its graph was for."""
    out: Dict[str, str] = {}
    for e, d in zip(exported, serving):
        if out.setdefault(e, d) != d:
            raise ValueError(
                f"{path}: the engine was exported with {e} at positions "
                f"the serving mesh holds on {out[e]} and on {d}; the "
                "copies in its graph cannot be placed. Re-export it on "
                "the serving mesh (python -m facekit_torch.engine export "
                "--identify-mesh ... on this machine)")
    return out


class IdentifyEngine:
    """A loaded identify engine, ready to dispatch (facekit's
    ``IdentifyEngine``, ``facekit/engine.py:335-422``).

    ``mesh=None`` builds a mesh of the frozen shape from the local
    devices (``make_mesh``; the CPU at every position for an engine
    exported on the CPU); a mesh of another shape is refused with the
    re-export hint. The devices recorded in the program's graph (its
    copies between positions, the replicas' constants) are mapped
    position by position onto the serving mesh's (``device_map``,
    ``torch.export.passes.move_to_device_pass``). Each call checks the
    batch, the frozen capacity and, for an int8 gallery, the scales.
    ``meta`` and ``program`` (an ``ExportedProgram``, as
    ``export_identify_engine`` returns it) stand in for the files'
    contents when given."""

    def __init__(self, path: str, mesh=None, meta=None, program=None):
        meta = read_meta(path) if meta is None else meta
        if meta.get("program") != "identify":
            raise ValueError(f"{path}: not an identify engine "
                             f"(program={meta.get('program')!r})")
        frozen = meta.get("mesh_shape")
        if frozen:
            if mesh is None:
                n = math.prod(frozen.values())
                mesh = make_mesh(dict(frozen), devices=(
                    ["cpu"] * n if meta.get("device") == "cpu" else None))
            got = mesh.shape
            if got != dict(frozen):
                raise ValueError(
                    f"{path}: engine is sharded for mesh {frozen} but the "
                    f"serving mesh is {got}; re-export with "
                    f"--identify-mesh "
                    f"{','.join(f'{k}={v}' for k, v in got.items())}")
            devices = [str(canonical(d)) for d in mesh.devices.flat]
        elif mesh is not None:
            raise ValueError(
                f"{path}: engine was exported without a mesh but the "
                f"serving mesh is {mesh.shape}; re-export with "
                f"--identify-mesh "
                f"{','.join(f'{k}={v}' for k, v in mesh.shape.items())}")
        else:
            devices = [str(canonical(meta.get("device", "cuda")))]
        if torch.device(devices[0]).type != meta.get("device"):
            raise ValueError(
                f"{path}: engine was exported with device="
                f"{meta.get('device')!r} but serves on {devices[0]}; "
                "re-export with `python -m facekit_torch.engine export "
                f"--device {torch.device(devices[0]).type}`")
        moves = device_map(path, meta["mesh_devices"], devices)
        self.path = path
        self.meta = meta
        self.mesh = mesh
        self.home = torch.device(devices[0])
        self.batch_size = int(meta["batch_size"])
        self.gallery_rows = int(meta["gallery_rows"])
        self.return_crops = bool(meta.get("return_crops"))
        self.int8_gallery = meta.get("gallery_dtype") == "int8"
        if mesh is None:
            self._positions = [(0, self.home)]
        else:
            self._positions = _search_positions(
                mesh, self.batch_size * int(meta["max_faces"]))
        if program is None:
            with open(path, "rb") as f:
                program = torch.export.load(f)
        if any(e != d for e, d in moves.items()):
            from torch.export.passes import move_to_device_pass
            program = move_to_device_pass(program, moves)
        self.program = program
        self._fn = program.module()

    def states(self, pipeline):
        """The (det_states, rec_states) this engine takes, from the
        serving pipeline (``identify_states``)."""
        return identify_states(pipeline, self.mesh, self.batch_size)

    def _blocks(self, rows, what: str):
        """One block per search position: ``rows`` itself without a mesh,
        else the copy of each position's block on its device."""
        if self.mesh is None:
            if isinstance(rows, ShardedRows):
                raise ValueError(f"{self.path}: a sharded {what} for an "
                                 "engine exported without a mesh")
            return (rows,)
        if not isinstance(rows, ShardedRows) or rows.axis != "gallery" \
                or len(rows.blocks) != self.mesh.shape["gallery"]:
            raise ValueError(f"{self.path}: the {what} must be row-sharded "
                             "over the mesh's 'gallery' axis (a "
                             "mesh-backed GalleryStore snapshot)")
        return tuple(rows.block(s, dev) for s, dev in self._positions)

    def __call__(self, det_states, rec_states, gallery, count: int, frames,
                 gallery_scale=None):
        """Dispatch one padded batch: (boxes, scores, valid, embeddings,
        sims, idx[, crops]) as the eager ``recognize_and_match`` returns
        them. ``gallery`` (and an int8 gallery's ``gallery_scale``) as a
        mesh-backed ``GalleryStore`` snapshot holds them; ``frames`` a
        host or device (B, H, W, 3) u8 batch, placed on the home device
        here."""
        if frames.shape[0] != self.batch_size:
            raise ValueError(
                f"{self.path}: engine frozen at batch {self.batch_size}, "
                f"got {frames.shape[0]}")
        if gallery.shape[0] != self.gallery_rows:
            raise ValueError(
                f"{self.path}: engine frozen at gallery capacity "
                f"{self.gallery_rows}, got {gallery.shape[0]}; the "
                f"gallery grew past the artifact; re-export the identify "
                f"engines with --gallery-rows >= {gallery.shape[0]}")
        if self.int8_gallery and gallery_scale is None:
            raise ValueError(f"{self.path}: int8 identify engine needs "
                             "the per-row gallery_scale")
        args = (tuple(det_states), tuple(rec_states),
                self._blocks(gallery, "gallery"),
                torch.tensor(int(count), dtype=torch.int64),
                _own_frames(frames, self.home))
        if self.int8_gallery:
            args += (self._blocks(gallery_scale, "gallery scale"),)
        with torch.inference_mode():
            return self._fn(*args)


def load_identify_engines(engines_dir: str, config, pipeline, mesh,
                          batches: Optional[Sequence[int]] = None
                          ) -> Dict[int, IdentifyEngine]:
    """Load and check every ``identify*.fke`` in ``engines_dir`` for a
    server on ``mesh`` (``facekit/engine.py:425-472``): each sidecar's
    frozen statics (device, geometry, networks, thresholds,
    quantization, ``gallery_topk``, ``gallery_dtype``, state signatures)
    against the serving config and pipeline before its program is read;
    a duplicate batch and artifacts that disagree on the frozen capacity
    refuse, and so does a bucket of ``batches`` without its engine
    (``facekit/server/app.py:295-306``). The recognize / embed pairs are
    skipped. Returns ``{batch: IdentifyEngine}``, for the buckets of
    ``batches`` when given."""
    quant = _quant_meta(pipeline)
    det_state, rec_state = engine_states(pipeline)
    found: Dict[int, Tuple[str, Dict[str, Any]]] = {}
    for fname in sorted(os.listdir(engines_dir)):
        if not fname.endswith(".fke"):
            continue
        path = os.path.join(engines_dir, fname)
        meta = read_meta(path)
        if meta.get("program") != "identify":
            continue      # single-device pairs, not a mesh server's
        _check_meta(path, meta, "device", pipeline.device.type)
        _check_pipeline_statics(path, meta, config, pipeline, quant,
                                "identify")
        _check_meta(path, meta, "gallery_topk", config.gallery_topk)
        _check_meta(path, meta, "gallery_dtype", config.gallery_dtype)
        _check_state(path, meta, "det_state", det_state)
        _check_state(path, meta, "rec_state", rec_state)
        b = int(meta["batch_size"])
        if b in found:
            raise ValueError(f"{path}: duplicate identify engine for "
                             f"batch {b} in {engines_dir}")
        if found and meta["gallery_rows"] != next(
                iter(found.values()))[1]["gallery_rows"]:
            raise ValueError(
                f"{path}: identify engines in {engines_dir} disagree on "
                f"the frozen gallery capacity; re-export the full ladder "
                f"in one `python -m facekit_torch.engine export` run")
        found[b] = (path, meta)
    if batches is not None:
        batches = sorted(set(batches))
        missing = [b for b in batches if b not in found]
        if missing:
            raise ValueError(
                f"{engines_dir}: no identify engine for batch bucket(s) "
                f"{missing} (found: {sorted(found)}); export the ladder "
                f"with `python -m facekit_torch.engine export -b "
                f"{','.join(map(str, batches))} --identify-mesh "
                f"{','.join(f'{k}={v}' for k, v in mesh.shape.items())}`")
        found = {b: found[b] for b in batches}
    return {b: IdentifyEngine(path, mesh, meta)
            for b, (path, meta) in sorted(found.items())}


def export_engines(pipeline, out_dir: str, batches, return_crops: bool = True
                   ) -> List[Dict[str, Any]]:
    """One recognize / embed pair per batch into ``out_dir`` (the bare
    names for a single batch, ``.b<B>`` otherwise). Returns one record per
    file: its name, batch, bytes and seconds to export and save."""
    os.makedirs(out_dir, exist_ok=True)
    batches = sorted({int(b) for b in batches})
    records = []
    for b in batches:
        sfx = "" if len(batches) == 1 else f".b{b}"
        for name, export in (
                ("recognize", lambda: export_recognize_engine(
                    pipeline, b, return_crops=return_crops)),
                ("embed", lambda: export_embed_engine(pipeline, b))):
            t0 = time.perf_counter()
            path = os.path.join(out_dir, f"{name}{sfx}.fke")
            save_engine(path, *export())
            records.append({"file": os.path.basename(path), "batch": b,
                            "bytes": os.path.getsize(path),
                            "seconds": time.perf_counter() - t0})
    return records


def export_identify_engines(pipeline, out_dir: str, batches,
                            gallery_rows: int, mesh,
                            return_crops: bool = True
                            ) -> List[Dict[str, Any]]:
    """One identify engine per batch into ``out_dir``
    (``identify[.b<B>].fke``, named as ``export_engines`` names the
    pairs), each over ``mesh`` at ``gallery_rows``. Returns one record per
    file, as ``export_engines`` does."""
    os.makedirs(out_dir, exist_ok=True)
    batches = sorted({int(b) for b in batches})
    records = []
    for b in batches:
        sfx = "" if len(batches) == 1 else f".b{b}"
        t0 = time.perf_counter()
        path = os.path.join(out_dir, f"identify{sfx}.fke")
        save_engine(path, *export_identify_engine(
            pipeline, b, gallery_rows, mesh=mesh,
            return_crops=return_crops))
        records.append({"file": os.path.basename(path), "batch": b,
                        "bytes": os.path.getsize(path),
                        "seconds": time.perf_counter() - t0})
    return records


def parse_mesh_shape(spec: str) -> Dict[str, int]:
    """``"data=2,gallery=2"`` -> ``{"data": 2, "gallery": 2}``, with
    ``"gallery"`` 1 when absent (as the server's ``mesh_shape``)."""
    try:
        shape = {k.strip(): int(v) for k, v in
                 (kv.split("=") for kv in spec.split(","))}
    except ValueError:
        raise ValueError(f"--identify-mesh {spec!r}: expected "
                         "axis=size pairs, e.g. data=2,gallery=2") from None
    shape.setdefault("gallery", 1)
    return shape


def export_pipeline(config, device):
    """The pipeline a server of ``config`` serves with, on ``device``: the
    weights ``server.app.model_params`` gives it and the int8 calibration
    the server applies (an engine must embed with the scales the server
    serves with). Refuses a configured calibration folder it cannot use
    rather than export an uncalibrated artifact."""
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.server.app import (calibrate_from_config,
                                          host_pixels, model_params)
    rec_params, det_params = model_params(config)
    pipe = FacePipeline(config, rec_params, det_params, device=device)
    calibrated = calibrate_from_config(pipe, config, host_pixels(config))
    if config.extras.get("rec_calibrationDir") and config.rec_quantize \
            and not calibrated:
        raise SystemExit(
            "engine export: rec_calibrationDir is configured but unusable "
            f"({config.extras.get('rec_calibrationDir')}); refusing to "
            "export an uncalibrated artifact for a calibrated config")
    return pipe


def main(argv=None) -> None:
    import argparse

    from facekit_torch.config import load_config

    ap = argparse.ArgumentParser(
        "facekit_torch.engine", description="export serving engines")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export")
    ex.add_argument("-c", "--config", default=None)
    ex.add_argument("-o", "--out-dir", default="engines")
    ex.add_argument("-b", "--batch-size", default=None,
                    help="batch size, or a comma list (e.g. '1,8,64'): one "
                         "recognize/embed pair per batch. Default: the "
                         "config's server_batchBuckets (else "
                         "server_batchSize, else 8), the ladder the server "
                         "asks for at --engines")
    ex.add_argument("--no-crops", action="store_true",
                    help="recognize engines omit the crops output (not "
                         "loadable by the server, whose WS reply needs it)")
    ex.add_argument("--device", default="cuda",
                    help="device to export on and serve from (default "
                         "cuda; cpu to run on the CPU)")
    ex.add_argument("--identify-mesh", default=None,
                    help="also export one identify engine per batch, the "
                         "whole detect+align+embed+match transaction over "
                         "a mesh of the local devices, e.g. "
                         "'data=2,gallery=2' (the CPU at every position "
                         "with --device cpu); without -b the batches are "
                         "the server's ladder on that mesh")
    ex.add_argument("--gallery-rows", type=int, default=1 << 20,
                    help="gallery capacity frozen into the identify "
                         "engines (default 1048576)")
    for flag in _BY_DESIGN:
        ex.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in _BY_DESIGN
             if getattr(args, f[2:]) is not None]
    if given:
        ex.error(f"{', '.join(given)}: refused by design: facekit's "
                 "options name XLA backends and TPU slices for jax.export; "
                 "a torch engine is exported on the device it serves from "
                 "(--device, and --identify-mesh over the local devices)")
    mesh = None
    if args.identify_mesh:
        shape = parse_mesh_shape(args.identify_mesh)
        mesh = make_mesh(shape, devices=(
            ["cpu"] * math.prod(shape.values())
            if resolve_device(args.device).type == "cpu" else None))

    cfg = load_config(args.config) if args.config else load_config({})
    pipe = export_pipeline(cfg, resolve_device(args.device) if mesh is None
                           else mesh.home)
    if args.batch_size is None:
        raw = (cfg.extras.get("server_batchBuckets")
               or [cfg.extras.get("server_batchSize", 8)])
        batches = [int(b) for b in raw]
    else:
        batches = [int(b) for b in str(args.batch_size).split(",")]
    records = export_engines(pipe, args.out_dir, batches,
                             return_crops=not args.no_crops)
    if mesh is not None:
        if args.batch_size is None:
            # the server's ladder on this mesh: rounded up to multiples
            # of the data axis (FaceServer)
            d = mesh.shape.get("data", 1)
            batches = [-(-b // d) * d for b in batches]
        records += export_identify_engines(
            pipe, args.out_dir, batches, args.gallery_rows, mesh,
            return_crops=not args.no_crops)
    for rec in records:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
