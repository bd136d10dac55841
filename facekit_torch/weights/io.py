"""Param files: flax's msgpack layout, written and read without flax.

The port's own copy of ``facekit/weights/io.py``. facekit saves a param
pytree with ``flax.serialization.to_bytes``: nested maps (a list becomes a
map keyed ``"0"``, ``"1"``, ...), every array an msgpack ext of code 1
whose payload is itself msgpack of ``(shape, dtype name, C-order bytes)``,
a numpy scalar the same under code 3. ``save_params`` writes exactly those
bytes for a tree of numpy arrays, so either package loads the other's
files; ``load_params`` reads them back as nested dicts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import msgpack
import numpy as np

_EXT_NDARRAY = 1         # flax's msgpack ext codes
_EXT_NPSCALAR = 3
#: flax splits an array leaf above this many bytes into chunks; neither
#: the writer nor the reader here does
MAX_LEAF_BYTES = 2 ** 30


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot save a {arr.dtype} array")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"array leaf of {arr.nbytes} bytes: leaves above "
                         f"{MAX_LEAF_BYTES} bytes are not supported")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _state(node) -> Any:
    """flax's ``to_state_dict``: lists and tuples as maps keyed by
    position, map keys as strings."""
    if isinstance(node, Mapping):
        return {str(k): _state(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return {str(i): _state(v) for i, v in enumerate(node)}
    return node


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot save a leaf of type {type(x).__name__}")


def save_params(params: Any, path: str) -> None:
    """Write a param tree (nested dicts and lists of numpy arrays) as
    ``facekit.weights.save_params`` writes it."""
    data = msgpack.packb(_state(params), default=_ext_pack,
                         strict_types=True)
    with open(path, "wb") as f:
        f.write(data)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the bits to float32 (exact)
        bits = np.frombuffer(buf, "<u2").astype("<u4") << 16
        return bits.view("<f4").reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name.decode())).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def load_params(path: str) -> Dict[str, Any]:
    """Read a param file that ``save_params`` (either package's) wrote.

    Returns the nested dicts as stored: a list comes back as a dict with
    keys ``"0"``, ``"1"``, ...; ``from_jax`` accepts either form.
    """
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False,
                               strict_map_key=False)
    if _has_chunked(tree):
        raise ValueError(f"{path}: chunked (>1 GiB) array leaves are not "
                         "supported")
    return tree


def _has_chunked(node) -> bool:
    if isinstance(node, dict):
        return ("__msgpack_chunked_array__" in node
                or any(_has_chunked(v) for v in node.values()))
    return False
