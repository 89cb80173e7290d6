"""A model shard's rank6 partials (csrc/shard.cu): the kernels under the
model-sharded rank of parallel/sharding.py.

Counterparts of the per-shard bodies of pangenome_index_tpu/parallel/
sharding.py:distributed_ckpt_rank6 and distributed_rank6, before their psum
over 'model': exactly one shard owns each position and gives its rank6, the
others 0, so the sum over the shards is the whole index's rank6.

  shard_ckpt_rank6  the shard's bit-plane checkpoint rows (global rows
                    row0 .. row0 + rows_local - 1): the owner of pos is the
                    shard that holds row pos >> 6. Two-level rows give
                    counts relative to the superblock (the base is added
                    after the sum).
  shard_run_rank6   the shard's runs (RunShard: their records and heads,
                    and the shard's slice of the run index): the owner of
                    pos is the shard with lo <= pos < upper (its first head
                    and the next shard's, the dtype's maximum on the last
                    shard); its partial is pos's bucket entry, then its
                    run's record (ops/rank.py:run_of_index, records_rank6).

`out`, when given, is added to (the shards of one card summed in place);
else a new tensor is returned. Positions, partials and tables share the
position dtype (int32 or int64). Each wrapper launches its kernel for CUDA
tensors (counted in `launches`) and runs its plain version for CPU tensors.

CkptShard and RunShard hold one shard (run_shard makes a RunShard of a
slice of the run table, its slice of the run index derived on its device);
shard_table packs the shards a
process holds for the lockstep MEM step (ops/mems.py:mem_step_fused), whose
kernel computes the same partials for the positions it makes, and
shards_rank6_plain is that computation's plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from .rank import plane_rows_rank6, records_rank6, run_of_index
from .tables import derive_run_index, derive_run_records, run_index_shift


def _finish(r, owns, pos, out):
    r = torch.where(owns[:, None], r.to(pos.dtype), torch.zeros((), dtype=pos.dtype,
                                                                 device=pos.device))
    if out is None:
        return r
    out += r
    return out


def shard_ckpt_rank6_plain(planes: torch.Tensor, row0: int, pos: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 6] partials of pos's dtype, by planes_rank6's reading of the
    owned rows."""
    rows_local = planes.shape[0]
    local = (pos.long() >> 6) - row0
    owns = (local >= 0) & (local < rows_local)
    r = plane_rows_rank6(planes[local.clamp(0, rows_local - 1)], pos)
    return _finish(r, owns, pos, out)


def shard_run_rank6_plain(shard: "RunShard", pos: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 6] partials as the kernel reads the shard: ownership lo <= pos <
    upper, then the run through the shard's index slice and its record."""
    p = pos.long()
    owns = (p >= shard.lo) & (p < shard.upper)
    j = run_of_index(shard.index, shard.first_bucket, shard.shift, shard.run_start, pos)
    return _finish(records_rank6(shard.rec, j, pos), owns, pos, out)


def _out(pos, out):
    if out is None:
        return torch.empty((pos.shape[0], 6), dtype=pos.dtype, device=pos.device), 0
    if tuple(out.shape) != (pos.shape[0], 6):
        raise ValueError(f"out: expected [{pos.shape[0]}, 6], got {tuple(out.shape)}")
    return out, 1


def _dtype_sfx(pos):
    if pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"positions are int32 or int64, not {pos.dtype}")
    return "_64" if pos.dtype == torch.int64 else ""


def shard_ckpt_rank6(planes: torch.Tensor, row0: int, pos: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """planes [rows_local, 16] int32 (tables.derive_rank_planes of the
    shard's rows), pos [B] -> [B, 6] partials (added to `out` if given). On
    the card one launch, one thread a position; on the CPU the plain
    version."""
    if pos.device.type == "cpu":
        return shard_ckpt_rank6_plain(planes, row0, pos, out)
    dev = pos.device
    if planes.dim() != 2 or planes.shape[1] != 16 or not planes.shape[0]:
        raise ValueError("planes: expected [rows_local > 0, 16]")
    sfx = _dtype_sfx(pos)
    res, acc = _out(pos, out)
    _build.launch(f"pgt_shard_ckpt_rank6{sfx}", _build.check("planes", planes, torch.int32, dev),
                  planes.shape[0], int(row0), _build.check("pos", pos, pos.dtype, dev),
                  pos.shape[0], _build.check("out", res, pos.dtype, dev), acc,
                  _build.stream(dev))
    shard_ckpt_rank6.launches += 1
    return res


shard_ckpt_rank6.launches = 0


def shard_run_rank6(shard: "RunShard", pos: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The shard's partials at pos [B] -> [B, 6] (added to `out` if given),
    the shard's tables and pos of one dtype. On the card one launch, one
    thread a position (ownership, then the entry and the record); on the
    CPU the plain version."""
    if pos.device.type == "cpu":
        return shard_run_rank6_plain(shard, pos, out)
    dev = pos.device
    sfx = _dtype_sfx(pos)
    args = run_shard_args(shard, pos.dtype, dev)
    res, acc = _out(pos, out)
    _build.launch(f"pgt_shard_run_rank6{sfx}", *args,
                  _build.check("pos", pos, pos.dtype, dev), pos.shape[0],
                  _build.check("out", res, pos.dtype, dev), acc, _build.stream(dev))
    shard_run_rank6.launches += 1
    return res


shard_run_rank6.launches = 0


@dataclass
class CkptShard:
    """A model shard's checkpoint rows in their bit-plane form: global rows
    row0 .. row0 + planes.shape[0] - 1."""

    planes: torch.Tensor
    row0: int

    def rank6(self, pos, out=None):
        return shard_ckpt_rank6(self.planes, self.row0, pos, out)

    def rank6_plain(self, pos):
        return shard_ckpt_rank6_plain(self.planes, self.row0, pos)


@dataclass
class RunShard:
    """A model shard's runs: runs [j0, j0 + R) of the padded tables as their
    records rec [R, 8] (start, sym, cum0..cum5) and heads run_start [R],
    and the shard's slice of the run index (index [nb, 4] int32 over
    buckets of 2^shift positions from first_bucket on, run ids local:
    ops/tables.py:slice_run_index of the tables' index, or derive_run_index
    over the slice alone). It owns the positions [lo, upper): lo its first
    head, upper the next shard's (the position type's maximum on the last
    shard). parallel/sharding.py places one; run_shard makes one of a
    slice alone."""

    rec: torch.Tensor
    run_start: torch.Tensor
    index: torch.Tensor
    first_bucket: int
    shift: int
    lo: int
    upper: int

    @property
    def run_sym(self) -> torch.Tensor:
        return self.rec[:, 1].to(torch.int8)

    @property
    def cum(self) -> torch.Tensor:
        return self.rec[:, 2:]

    def rank6(self, pos, out=None):
        return shard_run_rank6(self, pos, out)

    def rank6_plain(self, pos):
        return shard_run_rank6_plain(self, pos)


def run_shard(run_start: torch.Tensor, run_sym: torch.Tensor, cum: torch.Tensor,
              upper: int) -> RunShard:
    """The RunShard of a slice of the run table (run_start [R > 0] sorted,
    run_sym [R], cum [R, 6]), on its device: its records, and the run index
    over its own heads at the slice's shift (run_index_shift of its heads'
    span and count), its buckets from its first head's to its last head's,
    j0 = -1 where no head of the slice is <= a bucket's base (positions the
    shard owns lie at or past its first head). Reads the slice's first and
    last heads from the device."""
    r = run_start.shape[0]
    if not r or run_sym.shape != (r,) or tuple(cum.shape) != (r, 6):
        raise ValueError("run_start [r > 0], run_sym [r] and cum [r, 6]")
    lo, last = int(run_start[0]), int(run_start[-1])
    shift = run_index_shift(last - lo + 1, r)
    first = lo >> shift
    index = derive_run_index(run_start, shift, first, (last >> shift) - first + 1, j_min=-1)
    return RunShard(derive_run_records(run_start, run_sym, cum), run_start, index, first,
                    shift, lo, min(int(upper), torch.iinfo(run_start.dtype).max))


def run_shard_args(sh: RunShard, dtype: torch.dtype, device) -> tuple:
    """The C arguments of a run shard (rec, index, buckets, first bucket,
    shift, run_start, runs, lo, upper); raises ValueError for tables of
    another dtype or device, or of other shapes."""
    r = sh.run_start.shape[0]
    if not r or tuple(sh.rec.shape) != (r, 8) or sh.index.dim() != 2 \
            or sh.index.shape[1] != 4 or not sh.index.shape[0] or not 0 <= sh.shift <= 15:
        raise ValueError("a run shard: rec [r > 0, 8], run_start [r] and its run index "
                         "[nb > 0, 4] at a shift of 0..15")
    big = torch.iinfo(dtype).max
    return (_build.check("rec", sh.rec, dtype, device),
            _build.check("index", sh.index, torch.int32, device), sh.index.shape[0],
            int(sh.first_bucket), int(sh.shift),
            _build.check("run_start", sh.run_start, dtype, device), r,
            min(int(sh.lo), big), min(int(sh.upper), big))


def shards_rank6_plain(shards: list, pos: torch.Tensor) -> torch.Tensor:
    """[B, 6]: the sum of the shards' plain partials at pos (the rank6 where
    they are every shard of the index)."""
    out = shards[0].rank6_plain(pos)
    for sh in shards[1:]:
        out = out + sh.rank6_plain(pos)
    return out


#: shard kinds of the step's table (csrc/shard.cuh) and its largest size
SHARDS_CKPT, SHARDS_RUNS = 1, 2
MAX_SHARDS = 16


def shard_table(shards: list, dtype: torch.dtype, device) -> tuple:
    """(kind, count, host array) of the shards for the step's kernel: per
    shard (csrc/shard.cuh:Shard, nine int64) its tables' pointers (planes;
    or records, run index and heads), its first global row (checkpoint) or
    head (runs: lo), rows or runs, upper, and the run index's first bucket,
    buckets and shift (runs); in ascending first row or head. Reads nothing
    from the device, so it may run while a CUDA graph captures. Raises
    ValueError for shards of mixed kinds, of another dtype or device, or
    more than MAX_SHARDS."""
    if not shards or len(shards) > MAX_SHARDS:
        raise ValueError(f"the step takes 1 to {MAX_SHARDS} shards, not {len(shards)}")
    if all(isinstance(sh, CkptShard) for sh in shards):
        rows = []
        for sh in sorted(shards, key=lambda sh: sh.row0):
            if sh.planes.dim() != 2 or sh.planes.shape[1] != 16 or not sh.planes.shape[0]:
                raise ValueError("planes: expected [rows_local > 0, 16]")
            rows.append((_build.check("planes", sh.planes, torch.int32, device), 0, 0,
                         int(sh.row0), sh.planes.shape[0], 0, 0, 0, 0))
        kind = SHARDS_CKPT
    elif all(isinstance(sh, RunShard) for sh in shards):
        rows = []
        for sh in sorted(shards, key=lambda sh: sh.lo):
            rec, index, nb, first, shift, heads, r, lo, upper = run_shard_args(sh, dtype,
                                                                               device)
            rows.append((rec, index, heads, lo, r, upper, first, nb, shift))
        kind = SHARDS_RUNS
    else:
        raise ValueError("the shards are all checkpoint rows or all runs")
    flat = [v for e in rows for v in e]
    return kind, len(rows), (ctypes.c_int64 * len(flat))(*flat)
