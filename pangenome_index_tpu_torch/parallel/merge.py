"""The tag merge over the data shards of a mesh.

Counterpart of pangenome_index_tpu/parallel/merge.py. The rows (each BWT
row's component, dense labels 0..C-1, -1 for endmarker rows) are
range-sharded over the `data` ranks; the per-component tag streams are
replicated. Each rank counts its rows of each component, one all_gather of
the counts gives every component's rows on earlier shards (the exclusive
prefix over ranks: base), and ops/merge.py:merge_rows_shard places and
gathers: a row's tag is stream[offsets[c] + base[c] + its rank within c on
the shard]. On a mesh of one data shard base is 0 and this is merge_rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.merge import merge_rows_shard
from .sharding import Mesh


def make_device_merge(mesh: Mesh, n_components: int):
    """Returns merge(comp_local [n_local] int32, stream_flat [t] int64,
    stream_offsets [C + 1] int64) -> this shard's tags [n_local] int64, the
    rows of every data rank being consecutive ranges in rank order."""
    def step(comp_local, stream_flat, stream_offsets):
        me = mesh.axis_index("data")

        def base_of(counts):
            every = mesh.all_gather(counts.contiguous(), "data")   # [shards, C]
            return every[:me].sum(dim=0)

        return merge_rows_shard(comp_local, stream_flat, stream_offsets, base_of)

    return step


def merge_inputs(comp_per_row: np.ndarray, comp_streams: dict[int, np.ndarray]):
    """The merge's host arrays: rows relabelled densely by sorted component
    id (-1 where a row's component has no stream), the streams concatenated
    in that order, their offsets [C + 1]."""
    comps = np.asarray(sorted(comp_streams), np.int64)
    cpr = np.asarray(comp_per_row, np.int64)
    at = np.searchsorted(comps, cpr)
    found = (at < len(comps)) & (comps[np.minimum(at, max(len(comps) - 1, 0))] == cpr) \
        if len(comps) else np.zeros(len(cpr), bool)
    dense = np.where(found, at, -1).astype(np.int32)
    flat = (np.concatenate([comp_streams[c] for c in comps]).astype(np.int64)
            if len(comps) else np.zeros(0, np.int64))
    offsets = np.zeros(len(comps) + 1, np.int64)
    np.cumsum([len(comp_streams[c]) for c in comps], out=offsets[1:])
    return dense, flat, offsets


def merge_rows_on_mesh(mesh: Mesh, comp: np.ndarray, stream: np.ndarray,
                       offsets: np.ndarray) -> np.ndarray:
    """Every row's tag (host int64) on every rank: the rows (dense labels)
    padded with -1 to a multiple of the data shards, this rank's range
    merged (make_device_merge) on the mesh's device, the ranges gathered
    over the data group."""
    shards = mesh.shape["data"]
    n = len(comp)
    comp = np.concatenate((comp.astype(np.int32), np.full((-n) % shards, -1, np.int32)))
    rows = len(comp) // shards
    me = mesh.axis_index("data")
    dev = mesh.device
    step = make_device_merge(mesh, len(offsets) - 1)
    local = step(torch.from_numpy(comp[me * rows : (me + 1) * rows]).to(dev),
                 torch.from_numpy(stream).to(dev), torch.from_numpy(offsets).to(dev))
    return mesh.all_gather(local, "data").reshape(-1).cpu().numpy()[:n]


def merge_tags_device(mesh: Mesh, comp_per_row: np.ndarray,
                      comp_streams: dict[int, np.ndarray]) -> np.ndarray:
    """The merge of every row on the mesh (merge_inputs, then
    merge_rows_on_mesh): tag per row (host) on every rank."""
    return merge_rows_on_mesh(mesh, *merge_inputs(comp_per_row, comp_streams))


def merge_virtual_shards(comp: torch.Tensor, stream: torch.Tensor, offsets: torch.Tensor,
                         n_shards: int) -> torch.Tensor:
    """The cross-card merge of comp's rows in n_shards consecutive ranges, all
    on comp's device in one process: shard i's base is the sum of the counts
    of shards 0..i-1, which were merged before it (in place of the
    all_gather). Returns every row's tag, as merge_rows gives it."""
    n = comp.numel()
    rows = -(-n // n_shards)
    running = torch.zeros(offsets.numel() - 1, dtype=torch.int64, device=comp.device)
    parts = []
    for i in range(n_shards):
        def base_of(counts):
            nonlocal running
            base, running = running, running + counts
            return base

        parts.append(merge_rows_shard(comp[i * rows : (i + 1) * rows].contiguous(), stream,
                                      offsets, base_of))
    return torch.cat(parts)
