"""Device-resident embedding gallery with capacity bucketing.

Port of ``facekit/gallery/store.py``. The gallery is a device tensor whose
capacity comes from a fixed bucket ladder, with a live count masking the
padding rows, and a float32 host mirror:

  * ``load`` (the ``/reload`` path) swaps in a freshly built tensor;
  * ``add`` within the current capacity writes row ``count`` in place,
    without a rebuild: every snapshot holder masks that row (it is padding
    to them), so rows below any snapshot's count never change; crossing a
    bucket boundary rebuilds at the next capacity;
  * the device tensor is always a *copy* of the host mirror:
    ``torch.from_numpy`` aliases its buffer, and ``add`` writes the mirror
    in place (``facekit/gallery/store.py:154-172`` copies for the same
    reason);
  * ``dtype="int8"`` keeps int8 rows with per-row f32 scales on the device
    (``quantize_rows_int8`` of the f32 mirror on every rebuild; one row and
    its scale on ``add``) and searches them with ``cosine_topk_int8``
    (``facekit/gallery/store.py:89-92``, ``:161-165``, ``:219-225``);
  * on the card the device rows are ``similarity.DIM`` (512) wide whatever
    ``embed_dim`` is, zeros past it, since the search kernels are built for
    that width; ``embed_dim`` stays the width ``load``, ``add``, the host
    mirror and the queries have. Zero columns change no score, no row
    maximum and so no int8 scale. On the CPU the rows are ``embed_dim``
    wide. Wider than 512 is refused;
  * with ``mesh`` the device rows are row-sharded over ``mesh_axis``
    (``parallel.shard_gallery``: block s on every device at coordinate s,
    the int8 scales sharded with them) and searched with
    ``parallel.sharded_cosine_topk`` (``facekit/gallery/store.py:76-160,
    249-283``); every bucket must be a multiple of the shard count, which
    is checked at construction, and ``add`` writes the row into each copy
    of its block only. The host mirror and ``load`` stay as they are.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from facekit_torch.ops.similarity import (DIM, cosine_topk,
                                          cosine_topk_int8, pad_width,
                                          quantize_rows_int8)
from facekit_torch.parallel import ShardedRows, shard_gallery, \
    sharded_cosine_topk
from facekit_torch.utils.device import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _bucket_capacity(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the ladder: round up to the next multiple of the largest bucket
    top = buckets[-1]
    return ((n + top - 1) // top) * top


class GallerySnapshot(NamedTuple):
    """Consistent view: the tensor (a ``ShardedRows`` on a mesh), its live
    count, the matching names and, for an int8 gallery, its per-row scales
    (None otherwise)."""
    arr: torch.Tensor
    count: int
    names: List[str]
    scales: Optional[torch.Tensor] = None


class GalleryStore:
    """Names + device-resident L2-normalized embedding matrix + search."""

    def __init__(self, embed_dim: int = 512,
                 buckets: Sequence[int] = (1024, 8192, 65536, 1 << 20),
                 dtype: str = "bfloat16", device=None, mesh=None,
                 mesh_axis: str = "gallery"):
        """``device`` defaults to ``"cuda"``; with ``mesh`` (a
        ``parallel.Mesh``) the rows shard over ``mesh_axis`` and the
        store's own device is the mesh's home."""
        if dtype not in _DTYPES:
            raise ValueError(f"gallery_dtype {dtype!r}: one of "
                             f"{sorted(_DTYPES)}")
        if embed_dim > DIM:
            raise ValueError(f"embed_dim {embed_dim}: the gallery searches "
                             f"take widths up to {DIM}")
        self.embed_dim = embed_dim
        self.buckets = tuple(buckets)
        self.dtype = _DTYPES[dtype]
        self.quantized = dtype == "int8"
        self._scales: Optional[torch.Tensor] = None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            if mesh_axis not in mesh.shape:
                raise ValueError(f"mesh {mesh.shape} has no axis "
                                 f"{mesh_axis!r}")
            shards = mesh.shape[mesh_axis]
            bad = [b for b in self.buckets if b % shards]
            if bad:
                raise ValueError(
                    f"gallery_bucket_sizes {bad} are not multiples of the "
                    f"{shards} shards of mesh axis {mesh_axis!r}")
            device = mesh.home
        self.device = resolve_device(device)
        # width of the device rows (see the module docstring)
        self._width = DIM if self.device.type == "cuda" else embed_dim
        self._lock = threading.Lock()
        self._names: List[str] = []
        # host mirror, preallocated at device capacity (amortized appends)
        self._host_buf = np.zeros((0, embed_dim), np.float32)
        self._device_arr: torch.Tensor = None
        self._rebuild()

    # -- state ---------------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._names)

    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def capacity(self) -> int:
        return self._device_arr.shape[0]

    def capacity_for(self, n: int) -> int:
        """The capacity a gallery of ``n`` rows takes on this ladder."""
        return _bucket_capacity(max(n, 1), self.buckets)

    def _rebuild(self) -> None:
        n = len(self._names)
        cap = _bucket_capacity(max(n, 1), self.buckets)
        if self._host_buf.shape[0] != cap:
            buf = np.zeros((cap, self.embed_dim), np.float32)
            buf[:n] = self._host_buf[:n]
            self._host_buf = buf
        rows = pad_width(torch.from_numpy(self._host_buf).to(
            self.device, copy=True), self._width)
        if self.quantized:
            arr, scales = quantize_rows_int8(rows)
            self._scales = self._place(scales)
        else:
            arr = rows.to(self.dtype)
        self._device_arr = self._place(arr)

    def _place(self, x: torch.Tensor):
        """``x`` itself, or on a mesh ``x`` row-sharded (copied)."""
        if self.mesh is None:
            return x
        return shard_gallery(x, self.mesh, self.mesh_axis)

    # -- mutation (mirrors addEmbedding/resetEmbeddings/initMatMul) ----------

    def load(self, names: Sequence[str], embeddings: np.ndarray) -> None:
        """Atomically replace the gallery (the /reload path)."""
        embeddings = np.asarray(embeddings, np.float32).reshape(-1, self.embed_dim)
        if len(names) != embeddings.shape[0]:
            raise ValueError(f"{len(names)} names for {embeddings.shape[0]} "
                             "embeddings")
        with self._lock:
            self._names = list(names)
            n = embeddings.shape[0]
            cap = _bucket_capacity(max(n, 1), self.buckets)
            self._host_buf = np.zeros((cap, self.embed_dim), np.float32)
            self._host_buf[:n] = embeddings
            self._rebuild()

    def add(self, name: str, embedding: np.ndarray) -> None:
        """Append one row (reference addEmbedding, src/arcface.cpp:150-160)."""
        emb = np.asarray(embedding, np.float32).reshape(self.embed_dim)
        with self._lock:
            i = len(self._names)
            # copy-on-write: snapshot() hands out self._names uncopied, so
            # a mutation builds a new list instead of appending in place
            self._names = self._names + [name]
            if i >= self.capacity:
                # bucket growth: host buffer + device tensor rebuild
                buf = np.zeros((_bucket_capacity(i + 1, self.buckets),
                                self.embed_dim), np.float32)
                buf[:i] = self._host_buf[:i]
                buf[i] = emb
                self._host_buf = buf
                self._rebuild()
                return
            self._host_buf[i] = emb
            # in place: row i is padding to every outstanding snapshot
            row = pad_width(torch.tensor(emb, device=self.device)[None],
                            self._width)[0]
            if self.quantized:
                q, scale = quantize_rows_int8(row[None])
                _write(self._device_arr, i, q[0])
                _write(self._scales, i, scale[0])
            else:
                _write(self._device_arr, i, row.to(self.dtype))

    def reset(self) -> None:
        """Clear (reference resetEmbeddings, src/arcface.cpp:233-236)."""
        with self._lock:
            self._names = []
            self._host_buf = np.zeros((0, self.embed_dim), np.float32)
            self._rebuild()

    # -- search ---------------------------------------------------------------

    def snapshot(self) -> GallerySnapshot:
        """Atomic (tensor, count, names, scales) view. The names list is
        shared, not copied (every mutation rebinds it): treat it as
        immutable."""
        with self._lock:
            return GallerySnapshot(self._device_arr, len(self._names),
                                   self._names, self._scales)

    def search(self, queries, k: int = 1
               ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """(B, D) queries -> (scores (B, k), indices (B, k), names).

        ``names`` is the snapshot matching the indices, so a concurrent
        reload cannot skew the id mapping. Queries are cast to the gallery
        dtype before a float search (``facekit/pipeline/recognize.py:222``)
        and go to the int8 search in f32.
        """
        arr, count, names, scales = self.snapshot()
        if count == 0:
            raise ValueError(
                "Feature matching: No faces in database")  # reference msg
        q = torch.as_tensor(queries).to(self.device)
        q = (q.float() if self.quantized else q.to(self.dtype)).contiguous()
        kk = min(k, count)
        if self.mesh is not None:
            vals, idx = sharded_cosine_topk(arr, q, count, kk, mesh=self.mesh,
                                            axis=self.mesh_axis, scales=scales)
        elif self.quantized:
            vals, idx = cosine_topk_int8(arr, scales, q, count, kk)
        else:
            vals, idx = cosine_topk(arr, q, count, kk)
        return vals.cpu().numpy(), idx.cpu().numpy(), names


def _write(arr, i: int, value: torch.Tensor) -> None:
    """Row (or scale) i of a device tensor or of a ``ShardedRows``."""
    if isinstance(arr, ShardedRows):
        arr.write(i, value)
    else:
        arr[i] = value
