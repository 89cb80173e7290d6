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
  shard_run_rank6   the shard's runs (run_start, run_sym, cum): the owner
                    of pos is the shard whose predecessor run of pos exists
                    and whose `upper` (the next shard's first head, the
                    dtype's maximum on the last shard) lies above pos.

`out`, when given, is added to (the shards of one card summed in place);
else a new tensor is returned. Positions, partials and tables share the
position dtype (int32 or int64). Each wrapper launches its kernel for CUDA
tensors (counted in `launches`) and runs its plain version for CPU tensors.

CkptShard and RunShard hold one shard; shard_table packs the shards a
process holds for the lockstep MEM step (ops/mems.py:mem_step_fused), whose
kernel computes the same partials for the positions it makes, and
shards_rank6_plain is that computation's plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _build
from .rank import plane_rows_rank6


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


def shard_run_rank6_plain(run_start: torch.Tensor, run_sym: torch.Tensor,
                          cum: torch.Tensor, upper: int, pos: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 6] partials by the definition: searchsorted over the shard's
    heads, ownership against `upper`, cum + onehot * (pos - run_start)."""
    j = torch.searchsorted(run_start, pos.to(run_start.dtype), right=True) - 1
    owns = (j >= 0) & (pos.long() < upper)
    jc = j.clamp(0, run_start.shape[0] - 1)
    onehot = torch.arange(6, device=pos.device)[None, :] == run_sym[jc].long()[:, None]
    r = cum[jc].long() + onehot.long() * (pos.long() - run_start[jc].long())[:, None]
    return _finish(r, owns, pos, out)


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


def shard_run_rank6(run_start: torch.Tensor, run_sym: torch.Tensor, cum: torch.Tensor,
                    upper: int, pos: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """run_start [r_local], run_sym [r_local] int8, cum [r_local, 6] (the
    shard's runs, pos's dtype), upper, pos [B] -> [B, 6] partials (added to
    `out` if given). On the card one launch, one thread a position (a
    binary search over the shard's heads); on the CPU the plain version."""
    if pos.device.type == "cpu":
        return shard_run_rank6_plain(run_start, run_sym, cum, upper, pos, out)
    dev = pos.device
    r = run_start.shape[0]
    if not r or run_sym.shape != (r,) or tuple(cum.shape) != (r, 6):
        raise ValueError("run_start [r > 0], run_sym [r] and cum [r, 6]")
    sfx = _dtype_sfx(pos)
    res, acc = _out(pos, out)
    upper = min(int(upper), torch.iinfo(pos.dtype).max)
    _build.launch(f"pgt_shard_run_rank6{sfx}",
                  _build.check("run_start", run_start, pos.dtype, dev),
                  _build.check("run_sym", run_sym, torch.int8, dev),
                  _build.check("cum", cum, pos.dtype, dev), r, upper,
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
    """A model shard's runs, and `upper`: the next shard's first head (the
    position type's maximum on the last shard), which bounds the positions
    this shard owns."""

    run_start: torch.Tensor
    run_sym: torch.Tensor
    cum: torch.Tensor
    upper: int

    def rank6(self, pos, out=None):
        return shard_run_rank6(self.run_start, self.run_sym, self.cum, self.upper, pos, out)

    def rank6_plain(self, pos):
        return shard_run_rank6_plain(self.run_start, self.run_sym, self.cum, self.upper, pos)


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
    shard its tables' pointers, its first global row (checkpoint) or head
    (runs: the `upper` of the shard before it, 0 for the first), rows or
    runs, and upper; in ascending first row or head. Reads nothing from
    the device, so it may run while a CUDA graph captures. Raises
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
                         int(sh.row0), sh.planes.shape[0], 0))
        kind = SHARDS_CKPT
    elif all(isinstance(sh, RunShard) for sh in shards):
        big = torch.iinfo(dtype).max
        rows, first = [], 0
        for sh in sorted(shards, key=lambda sh: sh.upper):
            r = sh.run_start.shape[0]
            if not r or sh.run_sym.shape != (r,) or tuple(sh.cum.shape) != (r, 6):
                raise ValueError("run_start [r > 0], run_sym [r] and cum [r, 6]")
            upper = min(int(sh.upper), big)
            rows.append((_build.check("run_start", sh.run_start, dtype, device),
                         _build.check("run_sym", sh.run_sym, torch.int8, device),
                         _build.check("cum", sh.cum, dtype, device), first, r, upper))
            first = upper
        kind = SHARDS_RUNS
    else:
        raise ValueError("the shards are all checkpoint rows or all runs")
    flat = [v for e in rows for v in e]
    return kind, len(rows), (ctypes.c_int64 * len(flat))(*flat)
