"""The (data, model) mesh over torch.distributed, the index tables padded
and placed on it, and the model-sharded rank6.

Counterpart of pangenome_index_tpu/parallel/sharding.py. JAX's
Mesh(devices.reshape(n_data, n_model), ("data", "model")) becomes one process
a card: global rank r = d * n_model + m, JAX's device order. A `model` group
holds the ranks of one d (the shards of one copy of the index), a `data`
group the ranks of one m (the same shard over the read slices). The backend
follows the device: nccl for CUDA tensors, gloo for CPU tensors; every group
has a timeout, so that a rank that leaves a loop early fails the run
instead of hanging it.

  * `data`  - reads are sharded; each rank runs the MEM state machine on its
    slice, and a total is summed over the data group.
  * `model` - the checkpoint rows (or the runs) are range-sharded; rank6
    becomes: the shard that owns the position answers, the others give
    zeros, and one all_reduce over the model group sums them
    (ops/shard_rank.py, the kernels of csrc/shard.cu; inside the MEM
    engine, its step computes them, ops/mems.py:mem_step_fused).

pad_rindex_tables pads the run table to the number of shards with sentinel
runs (run_start = n + 1, never a predecessor of a position <= n) and the
checkpoint rows with copies of the last; shard_tables places a rank's slice.
The same shards can also all live on one card in one process
(virtual_shards): ShardedRank then sums their partials on the card launch
by launch, and the MEM engine's step finds each position's owner among
them.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.rindex import RIndex
from ..ops.shard_rank import CkptShard, RunShard, run_shard
from ..ops.tables import (CKPT_BLOCK, RIndexTables, rindex_to_device, slice_run_index,
                          with_locate_tables, with_rank_planes)



def group_timeout() -> datetime.timedelta:
    """How long a collective waits for the other ranks: PANIDX_DIST_TIMEOUT
    seconds, 600 by default."""
    return datetime.timedelta(seconds=int(os.environ.get("PANIDX_DIST_TIMEOUT", "600")))


def backend_for(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """This process's place in a (data, model) mesh of processes: its global
    rank r = d * n_model + m, its device, and the groups of its `data` row
    (ranks of its m) and `model` row (ranks of its d). Without a process
    group (a 1x1 mesh in one process) the collectives are the identity."""

    def __init__(self, n_data: int, n_model: int, rank: int, device,
                 groups: dict | None = None):
        self.n_data, self.n_model, self.rank = n_data, n_model, rank
        self.device = torch.device(device)
        self.groups = groups or {}

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def axis_index(self, axis: str) -> int:
        return self.rank // self.n_model if axis == "data" else self.rank % self.n_model

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum t over `axis`, in place."""
        group = self.groups.get(axis)
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """[axis size, *t.shape]: t of every rank of `axis`, in axis order."""
        group = self.groups.get(axis)
        if group is None:
            return t[None]
        out = [torch.empty_like(t) for _ in range(self.axis_size(axis))]
        dist.all_gather(out, t.contiguous(), group=group)
        return torch.stack(out)


def pick_device(device, local_rank: int | None = None) -> torch.device:
    """The torch device for `device`; a card without an index is the card of
    `local_rank` (the current card if None), made current. Raises
    RuntimeError for a card where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device here")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device() if local_rank is None
                               else local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n_data: int, n_model: int, device="cuda") -> Mesh:
    """The (n_data, n_model) mesh over the initialised process group (one
    process a device), with its data and model groups; without a group, the
    1x1 mesh of this process. The device is a card unless the caller asks
    for the CPU, and must be the group's (nccl for a card, gloo for the
    CPU). Raises ValueError where the group has fewer processes than the
    mesh has places (or more: each takes one)."""
    n = n_data * n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both sizes must be >= 1")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"need {n} devices, have 1")
        return Mesh(1, 1, 0, pick_device(device))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if world > n:
        raise ValueError(f"a {n_data}x{n_model} mesh over {world} processes: the "
                         f"process group must have {n}")
    device = pick_device(device)
    if backend_for(device) != dist.get_backend():
        raise ValueError(f"a {dist.get_backend()} process group cannot serve {device} "
                         f"tensors (it needs {backend_for(device)})")
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)], timeout=group_timeout())
        if rank // n_model == d:
            groups["model"] = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)], timeout=group_timeout())
        if rank % n_model == m:
            groups["data"] = g
    return Mesh(n_data, n_model, rank, device, groups)


def pad_rindex_tables(idx: RIndex, n_shards: int, checkpoint: bool = False,
                      ckpt_block: int = CKPT_BLOCK, super_shift: int | None = None,
                      mem_only: bool = False, device="cuda",
                      dtype: torch.dtype | None = None) -> RIndexTables:
    """Tables with the run dimension padded to a multiple of n_shards by
    sentinel runs (start n + 1, the full cumulative counts), the JAX
    function's arrays element for element: bucketed runs, or with
    checkpoint=True the checkpoint rows, padded to a multiple of n_shards
    rows with copies of the last row (unreachable for positions <= n);
    rows of ckpt_block positions, 64 or 128, as in the JAX function.
    mem_only (with checkpoint): the per-run and locate tables as one-row
    stubs, run_sym and run_start tiled to n_shards rows. The port's derived
    tables (bit planes of 64 positions whatever the block, superblock
    bases, the locate tables) follow the padded arrays. The tables are
    built on `device`: a card unless the caller asks for the CPU
    (RuntimeError where there is no card), as the JAX function places them
    on its default device."""
    if mem_only and not checkpoint:
        raise ValueError("mem_only requires checkpoint mode")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"pad_rindex_tables on {device}: no CUDA device here")
    r = idx.n_runs
    pad = 0 if mem_only else (-r) % n_shards
    if pad:
        full_cum = idx.cum[-1].copy()
        full_cum[idx.run_sym[-1]] += idx.run_len[-1]
        idx = RIndex(
            run_sym=np.concatenate((idx.run_sym, np.zeros(pad, np.int8))),
            run_start=np.concatenate((idx.run_start, np.full(pad, idx.n + 1, np.int64))),
            run_len=np.concatenate((idx.run_len, np.zeros(pad, np.int64))),
            cum=np.concatenate((idx.cum, np.tile(full_cum, (pad, 1)))),
            C=idx.C, n=idx.n, n_seq=idx.n_seq, max_len=idx.max_len,
            samples=np.concatenate((idx.samples, np.zeros(pad, np.int64))),
            last_sorted=np.concatenate(
                (idx.last_sorted, np.full(pad, np.iinfo(np.int64).max // 4, np.int64))),
            last_to_run=np.concatenate((idx.last_to_run, np.zeros(pad, np.int64))))
    t = rindex_to_device(idx, device, checkpoint=checkpoint, bucketed=True,
                         ckpt_block=ckpt_block, super_shift=super_shift,
                         mem_only=mem_only, dtype=dtype)
    if mem_only:  # the stubs divide over the model shards
        t.run_sym = t.run_sym.repeat(n_shards)
        t.run_start = t.run_start.repeat(n_shards)
        with_locate_tables(t)
    if checkpoint:
        rpad = (-t.ckpt.shape[0]) % n_shards
        if rpad:
            t.ckpt = torch.cat((t.ckpt, t.ckpt[-1:].repeat(rpad, 1)))
            with_rank_planes(t)
    return t


class ShardedRank:
    """rank6 over model shards: the shards this process holds (one under a
    mesh, all of them for virtual shards on one card), whose partials are
    summed on the device launch by launch and then, under a mesh, by one
    all_reduce over the model group. partial(pos) is that sum; calling the
    provider adds the superblock base of two-level rows after it, as the JAX
    distributed_ckpt_rank6 adds it after its psum. The MEM engine
    (ops/mems.py:find_mems_lockstep) takes the shards, C and n (the
    index's), the superblock bases and `reduce`, computes the partials
    inside its step and sums them by reduce."""

    def __init__(self, shards: list, C: torch.Tensor, n: int, mesh: Mesh | None = None,
                 super_base: torch.Tensor | None = None):
        self.shards, self.C, self.n, self.mesh = shards, C, n, mesh
        self.super_base = super_base
        self.super_shift = 0 if super_base is None else super_base.shape[1] - 6

    @property
    def pos_dtype(self) -> torch.dtype:
        return self.C.dtype

    def reduce(self, partials: torch.Tensor) -> torch.Tensor:
        """The partials summed in place over the model group (no-op where
        this process holds every shard)."""
        if self.mesh is not None:
            self.mesh.all_reduce(partials, "model")
        return partials

    def partial(self, pos: torch.Tensor) -> torch.Tensor:
        out = self.shards[0].rank6(pos)
        for sh in self.shards[1:]:
            sh.rank6(pos, out)
        return self.reduce(out)

    def __call__(self, pos: torch.Tensor) -> torch.Tensor:
        r = self.partial(pos)
        if self.super_base is None:
            return r
        sb = (pos.long() >> self.super_shift).clamp(0, self.super_base.shape[0] - 1)
        return (self.super_base[sb, :6] + r).to(r.dtype)


def _run_heads(t: RIndexTables, n_shards: int) -> list[tuple[int, int]]:
    """(first head, last head) of each run shard of the padded tables t,
    in one read from their device."""
    runs = t.run_start.shape[0] // n_shards
    at = torch.tensor([j for m in range(n_shards) for j in (m * runs, (m + 1) * runs - 1)],
                      device=t.device)
    h = t.run_start[at].tolist()
    return list(zip(h[0::2], h[1::2]))


def _shard_of(t: RIndexTables, m: int, n_shards: int, device, heads=None):
    """Shard m of n_shards of the padded tables t, on `device` (`upper` of a
    run shard from t's heads; shard_tables exchanges it instead). A run
    shard takes its slices of the records and heads, and the tables' run
    index sliced to the buckets of its heads with run ids rebased to its
    runs (tables.slice_run_index); `heads`: _run_heads(t, n_shards)."""
    if t.ckpt is not None:
        rows = t.ckpt_planes.shape[0] // n_shards
        return CkptShard(t.ckpt_planes[m * rows : (m + 1) * rows].to(device), m * rows)
    runs = t.run_start.shape[0] // n_shards
    sl = slice(m * runs, (m + 1) * runs)
    heads = heads or _run_heads(t, n_shards)
    lo, last = heads[m]
    upper = heads[m + 1][0] if m < n_shards - 1 else torch.iinfo(t.pos_dtype).max
    first = lo >> t.run_shift
    index = slice_run_index(t.run_index, first, last >> t.run_shift, m * runs)
    return RunShard(t.run_rec[sl].to(device), t.run_start[sl].to(device), index.to(device),
                    first, t.run_shift, lo, upper)


def _replicated(t: RIndexTables, device):
    C = t.C.to(device)
    sup = None if t.ckpt_super is None else t.ckpt_super.to(device)
    return C, sup


def shard_tables(t: RIndexTables, mesh: Mesh):
    """Place this rank's tables (from pad_rindex_tables(idx, n_model, ...),
    which every rank builds whole): with n_model = 1 the whole tables on
    the mesh's device, served by the one-card kernels; else a ShardedRank
    of this rank's model slice of the checkpoint rows (or of the runs) and
    the replicated C and superblock bases, reduced over the model group.
    A run shard's upper bound, the next shard's first head, is gathered
    once here over the model group. The rank keeps its own slices (copies,
    not views that would hold the whole tables)."""
    dev = mesh.device
    S = mesh.shape["model"]
    if S == 1:
        return _to(t, dev)
    m = mesh.axis_index("model")
    shard = _shard_of(t, m, S, dev)
    for f, v in vars(shard).items():
        if isinstance(v, torch.Tensor):
            setattr(shard, f, v.clone())
    if isinstance(shard, RunShard):
        heads = mesh.all_gather(shard.run_start[:1].clone(), "model")[:, 0]
        shard.upper = int(heads[m + 1]) if m < S - 1 else torch.iinfo(t.pos_dtype).max
    C, sup = _replicated(t, dev)
    return ShardedRank([shard], C, t.n, mesh, sup)


def virtual_shards(t: RIndexTables, n_shards: int, device) -> ShardedRank:
    """All n_shards model shards of the padded tables t on one device, in one
    process: the provider that the mesh's ranks hold one shard each of, with
    the model group's all_reduce replaced by every shard on the card (the
    launches of every shard into one sum, or in the MEM engine's step the
    owning shard of each position)."""
    C, sup = _replicated(t, device)
    heads = None if t.ckpt is not None else _run_heads(t, n_shards)
    return ShardedRank([_shard_of(t, m, n_shards, device, heads) for m in range(n_shards)],
                       C, t.n, None, sup)


def _to(t: RIndexTables, device) -> RIndexTables:
    """t with every tensor on `device`."""
    if t.device == torch.device(device):
        return t
    fields = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
              for k, v in vars(t).items()}
    return RIndexTables(**fields)


def distributed_ckpt_rank6(local_planes: torch.Tensor, pos: torch.Tensor, mesh: Mesh,
                           super_base: torch.Tensor | None = None) -> torch.Tensor:
    """Checkpoint rank6 with the rows range-sharded over the model group:
    this rank's bit-plane rows local_planes (its model index times their
    count is its first row), pos [B] the same on every rank of the group.
    The owner's partial (kernel 3a), summed by one all_reduce; the
    superblock base of two-level rows (super_base: ckpt_super, replicated)
    added after it."""
    rows = local_planes.shape[0]
    C = torch.zeros(7, dtype=pos.dtype, device=pos.device)
    shard = CkptShard(local_planes, mesh.axis_index("model") * rows)
    return ShardedRank([shard], C, 0, mesh, super_base)(pos)


def distributed_rank6(local_run_start: torch.Tensor, local_run_sym: torch.Tensor,
                      local_cum: torch.Tensor, pos: torch.Tensor, mesh: Mesh,
                      upper: int) -> torch.Tensor:
    """rank6 with the run table range-sharded over the model group: this
    rank's runs and `upper` (the next shard's first head, gathered when the
    runs were placed; the dtype's maximum on the last shard), made a
    RunShard (ops/shard_rank.py:run_shard: its records and run index). The
    owner's partial (kernel 3b), summed by one all_reduce."""
    C = torch.zeros(7, dtype=pos.dtype, device=pos.device)
    shard = run_shard(local_run_start, local_run_sym, local_cum, upper)
    return ShardedRank([shard], C, 0, mesh)(pos)
