"""Typed configuration, schema-compatible with the reference config JSON.

The port's own copy of ``facekit.config``: the same fields, defaults and
loading rules, so one config file drives either package. Keys that
describe XLA or TPUs (``use_pallas_search``) are parsed
and change nothing; the server refuses ``profiler_port``, which needs a
live profiler server torch does not have.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

# Reference engine paths have no meaning here; these keys are accepted and
# kept in extras (weights come from `det_weights` / `rec_weights` files).
_IGNORED_REFERENCE_KEYS = {
    "det_engine", "rec_engine",
    "det_inputName", "det_outputNames", "rec_inputName", "rec_outputName",
}


@dataclasses.dataclass(frozen=True)
class FaceKitConfig:
    """All knobs for the serving stack. Field names mirror app/config.json."""

    # --- persistence -----------------------------------------------------
    database_path: str = "facekit.db"

    # --- incoming frame geometry (reference input_frameWidth/Height) ------
    input_frameWidth: int = 640
    input_frameHeight: int = 480

    # --- detector ---------------------------------------------------------
    det_inputShape: Tuple[int, int, int] = (3, 288, 320)  # C, H, W
    det_maxBatchSize: int = 1
    det_threshold_nms: float = 0.4
    det_threshold_bbox: float = 0.6
    det_maxFacesPerScene: int = 4
    det_nmsTopK: int = 128
    det_nmsExact: bool = True
    det_weights: Optional[str] = None        # msgpack pytree; None -> random init
    det_network: str = "mobilenet0.25"       # mobilenet0.25 | slim | rfb
    det_withLandmarks: bool = True           # landmark head + 5-pt alignment

    # --- recognizer --------------------------------------------------------
    rec_inputShape: Tuple[int, int, int] = (3, 112, 112)
    rec_outputDim: int = 512
    rec_maxBatchSize: int = 1
    rec_knownPersonThreshold: float = 0.65
    rec_weights: Optional[str] = None
    rec_network: str = "ir_50"               # ir_50|ir_101|ir_152|ir_se_50|...
    rec_quantize: bool = False               # int8 embedder (models/arcface.py)
    det_quantize: bool = False               # int8 detector (quantize_detector)

    # --- batch-enrollment ("gen") mode (reference src/app.cpp:69-99) -------
    gen: bool = False
    gen_imgSource: str = "/data"
    gen_imgIsCropped: bool = True
    api_imgIsCropped: bool = True

    # --- facekit extensions -------------------------------------------------
    compute_dtype: str = "bfloat16"          # model compute dtype
    gallery_dtype: str = "bfloat16"          # gallery residency dtype
    gallery_bucket_sizes: Tuple[int, ...] = (1024, 8192, 65536, 1 << 20)
    gallery_topk: int = 1
    server_port: int = 18080
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 1, "gallery": 8}
    # Read for schema parity with facekit. The port has one search path:
    # on the card the hand-written CUDA kernel always serves CUDA tensors.
    use_pallas_search: bool = True

    # Unknown/ignored keys from the source JSON, preserved for round-trips.
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ---- derived geometry --------------------------------------------------
    @property
    def det_hw(self) -> Tuple[int, int]:
        return (self.det_inputShape[1], self.det_inputShape[2])

    @property
    def rec_hw(self) -> Tuple[int, int]:
        return (self.rec_inputShape[1], self.rec_inputShape[2])

    @property
    def frame_hw(self) -> Tuple[int, int]:
        return (self.input_frameHeight, self.input_frameWidth)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        extras = d.pop("extras")
        d.update(extras)
        for k in ("det_inputShape", "rec_inputShape", "gallery_bucket_sizes"):
            d[k] = list(d[k])
        return json.dumps(d, indent=2)


def load_config(path_or_dict) -> FaceKitConfig:
    """Load a config from a JSON file path or a dict (reference schema OK)."""
    if isinstance(path_or_dict, (str,)):
        with open(path_or_dict) as f:
            raw = json.load(f)
    else:
        raw = dict(path_or_dict)

    fields = {f.name: f for f in dataclasses.fields(FaceKitConfig)}
    kwargs: Dict[str, Any] = {}
    extras: Dict[str, Any] = {}
    for key, value in raw.items():
        if key in _IGNORED_REFERENCE_KEYS:
            extras[key] = value
            continue
        if key == "extras" and isinstance(value, dict):
            # an explicit extras block (the constructor's spelling) merges
            # with flat unknown keys instead of nesting under extras.extras
            extras.update(value)
            continue
        if key in fields and key != "extras":
            if key in ("det_inputShape", "rec_inputShape", "gallery_bucket_sizes"):
                value = tuple(value)
            kwargs[key] = value
        else:
            extras[key] = value
    kwargs["extras"] = extras
    return FaceKitConfig(**kwargs)
