"""Serialized serving programs ("engines") of the port.

Port of ``facekit/engine.py`` on one device. The reference boots from
prebuilt TensorRT engines (``src/arcface.cpp:45-69``,
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

Both trace ``pipeline.recognize_program`` / ``embed_program``, the
functions the eager pipeline runs. The four kernels and the face
selection are ``torch.library`` ops (``facekit_torch::ir_block``,
``conv_s8``, ``cosine_topk``, ``cosine_topk_int8``, ``select_faces``), so
a loaded program on CUDA launches the same kernels as the eager path.
facekit's identify engines (the sharded transaction) belong to the
parallel slice (ROADMAP.md Queue 1).

CLI:  python -m facekit_torch.engine export -c config.json -o engines/
        [-b 1,8] [--no-crops] [--device cuda|cpu]
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

import facekit_torch.ops  # noqa: F401  (registers the ops before a load)
from facekit_torch.pipeline.recognize import embed_program, recognize_program
from facekit_torch.utils.device import resolve_device

_MAGIC = "facekit-torch-engine-v1"
_JAX_MAGIC = "facekit-engine-v1"      # facekit's own artifacts
_PROGRAMS = ("recognize", "embed")
#: facekit's export options that need the parallel slice
_NOT_PORTED = ("--platforms", "--identify-mesh", "--topology",
               "--gallery-rows")


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
                            pipeline, quant: Dict[str, Any]) -> None:
    """The frozen statics of a recognize artifact
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
            f"{path}: recognize engine was exported without the crops "
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


def main(argv=None) -> None:
    import argparse

    from facekit_torch.config import load_config
    from facekit_torch.pipeline import FacePipeline
    from facekit_torch.server.app import (calibrate_from_config,
                                          host_pixels, model_params)

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
    for flag in _NOT_PORTED:
        ex.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in _NOT_PORTED
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        ex.error(f"{', '.join(given)}: identify engines and multi-device "
                 "export belong to the parallel slice, not ported yet "
                 "(ROADMAP.md Queue 1, parallel/)")

    cfg = load_config(args.config) if args.config else load_config({})
    rec_params, det_params = model_params(cfg)
    pipe = FacePipeline(cfg, rec_params, det_params,
                        device=resolve_device(args.device))
    # the calibration the server applies for this config: an engine must
    # embed with the scales the server serves with
    calibrated = calibrate_from_config(pipe, cfg, host_pixels(cfg))
    if cfg.extras.get("rec_calibrationDir") and cfg.rec_quantize \
            and not calibrated:
        raise SystemExit(
            "engine export: rec_calibrationDir is configured but unusable "
            f"({cfg.extras.get('rec_calibrationDir')}); refusing to export "
            "an uncalibrated artifact for a calibrated config")
    if args.batch_size is None:
        raw = (cfg.extras.get("server_batchBuckets")
               or [cfg.extras.get("server_batchSize", 8)])
        batches = [int(b) for b in raw]
    else:
        batches = [int(b) for b in str(args.batch_size).split(",")]
    for rec in export_engines(pipe, args.out_dir, batches,
                              return_crops=not args.no_crops):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
