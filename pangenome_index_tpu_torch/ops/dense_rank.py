"""K1: dense-mode rank6 and row gathers (csrc/dense_rank.cu).

Counterparts of pangenome_index_tpu/ops/pallas_rank.py: gather_rows_pallas
(rec[idx] by aligned 8-row DMA windows, so it needed B % 8 == 0) and
rank6_pallas (dense rank6 on top of it). The kernels take any batch size.
Row indices clamp into the table, as JAX gathers do.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its `launches` attribute; for CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

import torch

from .. import _build


def gather_rows_plain(rec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rec [r, W], idx [B] -> rec[clamp(idx, 0, r - 1)] ([B, W])."""
    return rec[idx.long().clamp(0, rec.shape[0] - 1)]


def gather_rows(rec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rec [r, W] int32, idx [B] int32 -> [B, W] rows (clamped indices)."""
    if rec.device.type == "cpu":
        return gather_rows_plain(rec, idx)
    dev = rec.device
    if rec.dim() != 2:
        raise ValueError("gather_rows: rec must be [rows, width]")
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


def rank6_dense(rec: torch.Tensor, pos_to_run: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Dense rank6 of int32 positions over int32 tables ([B] -> [B, 6])."""
    if rec.device.type == "cpu":
        return rank6_dense_plain(rec, pos_to_run, pos)
    dev = rec.device
    if rec.dim() != 2 or rec.shape[1] != 8:
        raise ValueError("rank6_dense: rec must be [runs, 8]")
    out = torch.empty((pos.shape[0], 6), dtype=torch.int32, device=dev)
    _build.launch("pgt_rank6_dense",
                  _build.check("pos_to_run", pos_to_run, torch.int32, dev),
                  pos_to_run.shape[0],
                  _build.check("rec", rec, torch.int32, dev), rec.shape[0],
                  _build.check("pos", pos, torch.int32, dev), pos.shape[0],
                  out.data_ptr(), _build.stream(dev))
    rank6_dense.launches += 1
    return out


rank6_dense.launches = 0
