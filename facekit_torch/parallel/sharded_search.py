"""Gallery search sharded row-wise over the device mesh.

Port of ``facekit/parallel/sharded_search.py``. The (N, D) gallery is cut
into S = ``mesh.shape[axis]`` blocks of N / S rows (``shard_gallery``);
block s lives on the device of every mesh position at coordinate s of
``axis``, one copy per distinct device (``ShardedRows``). A search runs
the single-device search on each block, ``cosine_topk`` or
``cosine_topk_int8`` (kernel #1 or #2 on CUDA, the plain version on the
CPU), with the block's own live count, and merges the (B, k) partials on
one device: only S * B * k scores and indices cross devices, never a
gallery row or a similarity.

The merge is facekit's ``lax.top_k`` over its ``all_gather``: the
partials laid out shard-major per query, (B, S * k), and a stable
descending sort, so among equal scores the lower shard (then the lower
position in it) comes first. That is the unsharded search's order: a
lower shard holds lower rows, and a block with fewer live rows than k
returns its padding rows at -1e30 in ascending order, offset by its
base, which sort after every live row of every block.

``query_axis`` splits the queries over that mesh axis as well: data row
r searches its B / R queries against the blocks at its own positions and
merges only its own partials (``:96-104``). Results come back on the
mesh's home device, concatenated in query order. No collective and no
``synchronize``: every copy is a ``.to(device)`` issued on the current
streams, which orders it after the work that made its source.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from facekit_torch.ops.similarity import cosine_topk, cosine_topk_int8
from facekit_torch.parallel.mesh import Mesh, canonical


class ShardedRows:
    """(N, ...) rows cut into ``len(blocks)`` blocks of N / S rows over
    mesh axis ``axis``; ``blocks[s]`` maps each device at coordinate s to
    its copy of block s."""

    def __init__(self, mesh: Mesh, axis: str,
                 blocks: List[Dict[torch.device, torch.Tensor]]):
        self.mesh = mesh
        self.axis = axis
        self.blocks = blocks
        first = next(iter(blocks[0].values()))
        self.n_local = first.shape[0]
        self.shape = (self.n_local * len(blocks),) + tuple(first.shape[1:])
        self.dtype = first.dtype

    def block(self, s: int, device) -> torch.Tensor:
        """Block s's copy on ``device``."""
        return self.blocks[s][canonical(device)]

    def write(self, i: int, value: torch.Tensor) -> None:
        """Row i = ``value`` (from any device), on every copy of its block
        and nowhere else."""
        s, j = divmod(i, self.n_local)
        for t in self.blocks[s].values():
            t[j].copy_(value)


def shard_gallery(gallery: torch.Tensor, mesh: Mesh,
                  axis: str = "gallery") -> ShardedRows:
    """A (N, D) gallery row-sharded over ``axis``, replicated over the
    other axes. N must be a multiple of the shard count (the store's
    bucket ladder keeps it one). Every block is a new tensor, never a view
    of ``gallery`` (which may alias a host buffer its owner writes)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    shards = mesh.shape[axis]
    n = gallery.shape[0]
    if n % shards:
        raise ValueError(f"{n} rows do not split into {shards} shards of "
                         f"mesh axis {axis!r}")
    n_local = n // shards
    blocks = []
    for s in range(shards):
        rows = gallery[s * n_local:(s + 1) * n_local]
        blocks.append({dev: rows.to(dev, copy=True).contiguous()
                       for dev in mesh.devices_along(axis, s)})
    return ShardedRows(mesh, axis, blocks)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "gallery"
               ) -> ShardedRows:
    """A 1-D per-row vector (the int8 scales) sharded with the rows."""
    return shard_gallery(x, mesh, axis)


def search_positions(mesh: Mesh, axis: str = "gallery",
                     query_axis: Optional[str] = None
                     ) -> List[Tuple[int, int, torch.device]]:
    """(query row r, shard s, device) of every search
    ``sharded_cosine_topk`` launches, in its order: query row major, then
    shard. An exported program's gallery blocks line up with it."""
    rows = 1 if query_axis is None else mesh.shape[query_axis]
    return [(r, s, canonical(mesh.device_at(
        **({} if query_axis is None else {query_axis: r}), **{axis: s})))
        for r in range(rows) for s in range(mesh.shape[axis])]


def sharded_cosine_topk(gallery: ShardedRows, queries: torch.Tensor,
                        count: int, k: int = 1, *, mesh: Mesh,
                        axis: str = "gallery",
                        query_axis: Optional[str] = None,
                        scales: Optional[ShardedRows] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded gallery: (B, k) f32 scores and
    int32 indices on ``mesh.home``, the unsharded search's answer.

    ``count`` is the global live-row count: an int, or in a traced
    program (``engine.export_identify_engine``) a SymInt that stays a
    runtime value, each shard's live rows computed from it in the
    graph. ``queries`` are in the
    gallery's dtype (f32 for an int8 gallery, which passes its ``scales``
    sharded with the rows). With ``query_axis`` the batch splits over
    that axis (B a multiple of its size). k may not exceed a block's rows,
    the bound facekit's ``top_k`` has per shard and the kernels per
    launch."""
    shards = mesh.shape[axis]
    if not isinstance(gallery, ShardedRows):
        raise TypeError("sharded_cosine_topk: the gallery must be sharded "
                        "(shard_gallery) on a mesh")
    if gallery.axis != axis or len(gallery.blocks) != shards:
        raise ValueError(f"gallery sharded {len(gallery.blocks)} ways over "
                         f"{gallery.axis!r}; mesh axis {axis!r} has {shards}")
    n_local = gallery.n_local
    if not 1 <= k <= n_local:
        raise ValueError(f"sharded_cosine_topk: k={k} outside [1, "
                         f"{n_local}], the rows of one shard")
    rows = 1 if query_axis is None else mesh.shape[query_axis]
    b = queries.shape[0]
    if b % rows:
        raise ValueError(f"{b} queries do not split over the {rows} "
                         f"positions of mesh axis {query_axis!r}")
    b_local = b // rows
    # (data row, shard, device) of every search; the query copies go out
    # first, then every launch, then the partials to the merging devices:
    # a copy between two devices orders both devices' streams, so a copy
    # issued between two launches would run the shards one after another
    where = search_positions(mesh, axis, query_axis)
    qs = [queries[r * b_local:(r + 1) * b_local].to(dev)
          for r, _, dev in where]
    parts = []
    for (r, s, dev), q in zip(where, qs):
        # sym_min / sym_max: inside a traced program ``count`` is a
        # SymInt, which Python's min and max would freeze to its value
        local = torch.sym_min(torch.sym_max(count - s * n_local, 0), n_local)
        if scales is None:
            v, i = cosine_topk(gallery.block(s, dev), q, local, k)
        else:
            v, i = cosine_topk_int8(gallery.block(s, dev),
                                    scales.block(s, dev), q, local, k)
        parts.append((v, i + s * n_local))
    home = canonical(mesh.home)
    out_v, out_i = [], []
    for r in range(rows):
        merge = where[r * shards][2]
        row = parts[r * shards:(r + 1) * shards]
        vs = torch.stack([v.to(merge) for v, _ in row], 1).reshape(
            b_local, shards * k)
        is_ = torch.stack([i.to(merge) for _, i in row], 1).reshape(
            b_local, shards * k)
        vv, pos = torch.sort(vs, dim=1, descending=True, stable=True)
        out_v.append(vv[:, :k].to(home))
        out_i.append(torch.gather(is_, 1, pos[:, :k]).to(home))
    return torch.cat(out_v).contiguous(), torch.cat(out_i).contiguous()
