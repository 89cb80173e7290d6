"""K1: dense-mode rank6 and row gathers (csrc/dense_rank.cu).

Counterparts of pangenome_index_tpu/ops/pallas_rank.py: gather_rows_pallas
(rec[idx] by aligned 8-row DMA windows, so it needed B % 8 == 0) and
rank6_pallas (dense rank6 on top of it). The kernels take any batch size.
Row indices clamp into the table, as JAX gathers do. The row gather copies
int32 words: rows of 8 or 16 words a 16-byte vector a thread (int64
records are gathered as their int32 words, rec.view(torch.int32)), other
widths a word a thread. The rank kernel finds a position's run through the
tables' dense lines (tables.derive_dense_lines), not pos_to_run, at int32
or int64 positions, as rank6_pallas takes either; dense_run_of_plain is
the plain reader of those lines, and rank6_dense_plain, the plain version,
reads pos_to_run as the JAX function does.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its `launches` attribute; for CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

import torch

from .. import _build
from .tables import DENSE_LINE, RIndexTables


def gather_rows_plain(rec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rec [r, W], idx [B] -> rec[clamp(idx, 0, r - 1)] ([B, W])."""
    return rec[idx.long().clamp(0, rec.shape[0] - 1)]


def gather_rows(rec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rec [r, W] int32, idx [B] int32 -> [B, W] rows (clamped indices)."""
    if rec.device.type == "cpu":
        return gather_rows_plain(rec, idx)
    dev = rec.device
    if rec.dim() != 2 or not rec.shape[1]:
        raise ValueError("gather_rows: rec must be [rows, width]")
    if idx.shape[0] and not rec.shape[0]:
        raise ValueError("gather_rows: rows asked of an empty table")
    out = torch.empty((idx.shape[0], rec.shape[1]), dtype=torch.int32, device=dev)
    _build.launch("pgt_gather_rows",
                  _build.check("rec", rec, torch.int32, dev), rec.shape[0],
                  rec.shape[1], _build.check("idx", idx, torch.int32, dev),
                  idx.shape[0], out.data_ptr(), _build.stream(dev))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def rank6_dense_plain(rec: torch.Tensor, pos_to_run: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Dense rank6: rec[j, 2:8] + onehot(rec[j, 1]) * (pos - rec[j, 0]) with
    j = pos_to_run[pos] ([B] -> [B, 6])."""
    j = pos_to_run[pos.long().clamp(0, pos_to_run.shape[0] - 1)]
    row = rec[j.long().clamp(0, rec.shape[0] - 1)]
    onehot = torch.arange(6, device=rec.device)[None, :] == row[:, 1:2]
    return row[:, 2:8] + onehot.to(rec.dtype) * (pos.to(rec.dtype) - row[:, 0])[:, None]


def dense_run_of_plain(lines: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The run of each position through the dense lines [L, 4] int32: j0 +
    the heads of its line at or before it ([B] -> [B] int64), a position
    clamped into the lines' 64 L positions (csrc/rank.cuh:DenseRank)."""
    p = pos.long().clamp(0, DENSE_LINE * lines.shape[0] - 1)
    e = lines[p >> 6].long()
    mask = (e[:, 1] & 0xFFFFFFFF) | (e[:, 2] << 32)
    k = torch.arange(DENSE_LINE, device=lines.device)
    bits = (mask[:, None] >> k) & 1
    return e[:, 0] + (bits * (k[None, :] <= (p & 63)[:, None])).sum(dim=1)


def dense_args(t: RIndexTables) -> tuple:
    """The dense provider's C arguments (dense_lines, lines, rec, runs): int32
    lines, and records of the tables' position dtype (int32, or int64 past
    2^31 or where the caller asked for it)."""
    dev = t.device
    if t.rec is None or t.pos_dtype not in (torch.int32, torch.int64):
        raise ValueError("dense tables need records of int32 or int64 positions")
    if t.dense_lines is None or t.dense_lines.dim() != 2 or t.dense_lines.shape[1] != 4 \
            or not t.dense_lines.shape[0]:
        raise ValueError("dense tables need their lines [L, 4] "
                         "(ops/tables.py:with_dense_lines)")
    if t.rec.dim() != 2 or t.rec.shape[1] != 8 or not t.rec.shape[0]:
        raise ValueError("rec must be [runs, 8]")
    return (_build.check("dense_lines", t.dense_lines, torch.int32, dev),
            t.dense_lines.shape[0], _build.check("rec", t.rec, t.pos_dtype, dev),
            t.rec.shape[0])


def rank6_dense(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """Dense rank6 of positions in the tables' dtype, int32 or int64 ([B] ->
    [B, 6] of that dtype): one launch through the lines and records on the
    card, the plain version (pos_to_run, rec) on the CPU."""
    if pos.device.type == "cpu":
        return rank6_dense_plain(t.rec, t.pos_to_run, pos)
    args = dense_args(t)
    pd = t.pos_dtype
    out = torch.empty((pos.shape[0], 6), dtype=pd, device=t.device)
    _build.launch("pgt_rank6_dense64" if pd == torch.int64 else "pgt_rank6_dense", *args,
                  _build.check("pos", pos, pd, t.device), pos.shape[0],
                  out.data_ptr(), _build.stream(t.device))
    rank6_dense.launches += 1
    return out


rank6_dense.launches = 0
