"""K5: the gather-rate probe kernels (csrc/gather_probe.cu).

Counterparts of examples/gather_pipeline_probe.py: make_pallas_rowdma (the
last Pallas kernel of the repository: B/G DMA copies of G consecutive rows
of a [R, 16] int32 table, K in flight) and xla_gather_loop (ITERS dependent
gathers per lane, each next index hashed from the value read). On the card
the TPU's K copies in flight become `depth`, the number of independent row
loads a thread issues before it stores any.
"""

from __future__ import annotations

import torch

from .. import _build

#: int32 columns of the probe's table (one 64-byte row)
WIDTH = 16
#: dependent gathers per lane in xla_gather_loop
ITERS = 64
#: the row loads a thread may keep in flight (the kernel's template depths)
DEPTHS = (1, 4, 16)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _group_rows(idx: torch.Tensor, group: int) -> torch.Tensor:
    """Source row of every output row: idx[j*G] + g for row j*G + g."""
    head = idx.long()[::group]
    return (head[:, None] + torch.arange(group, device=idx.device)[None, :]).reshape(-1)


def _check_rows(T: torch.Tensor, idx: torch.Tensor, group: int) -> None:
    if T.dim() != 2 or T.shape[1] != WIDTH:
        raise ValueError(f"row_gather: the table must be [rows, {WIDTH}]")
    if idx.dim() != 1:
        raise ValueError("row_gather: the indices must be [B]")
    if group < 1 or idx.shape[0] % group:
        raise ValueError("row_gather: the batch must be a multiple of the group")


def row_gather_plain(T: torch.Tensor, idx: torch.Tensor, group: int = 1,
                     depth: int = 1) -> torch.Tensor:
    """T [R, 16], idx [B] -> rows [B, 16]: row j*G + g is
    T[clamp(idx[j*G] + g, 0, R - 1)]. depth changes nothing here."""
    _check_rows(T, idx, group)
    return T[_group_rows(idx, group).clamp(0, T.shape[0] - 1)]


def row_gather(T: torch.Tensor, idx: torch.Tensor, group: int = 1,
               depth: int = 1) -> torch.Tensor:
    """rows [B, 16] as row_gather_plain; on the card one launch with `depth`
    row loads in flight per thread (int32 table and indices)."""
    _check_rows(T, idx, group)
    if depth not in DEPTHS:
        raise ValueError(f"row_gather: depth must be one of {DEPTHS}")
    if T.device.type == "cpu":
        return row_gather_plain(T, idx, group, depth)
    dev = T.device
    out = torch.empty((idx.shape[0], WIDTH), dtype=torch.int32, device=dev)
    _build.launch("pgt_row_gather", _build.check("T", T, torch.int32, dev),
                  T.shape[0], _build.check("idx", idx, torch.int32, dev),
                  idx.shape[0], int(group), int(depth), out.data_ptr(),
                  _build.stream(dev))
    row_gather.launches += 1
    return out


row_gather.launches = 0


def gather_chain_plain(T: torch.Tensor, idx: torch.Tensor,
                       iters: int = ITERS) -> torch.Tensor:
    """acc [B] int32: `iters` dependent steps of v = T[j, 0]; acc += v;
    j = floor_mod((v ^ (j * 40503)) + i, R), all in int32 with wraparound."""
    R = T.shape[0]
    col = T[:, 0].long()
    j = idx.long()
    acc = torch.zeros_like(j)
    for i in range(iters):
        v = col[j.clamp(0, R - 1)]
        acc = acc + v
        mixed = _wrap32((v ^ _wrap32(j * 40503).long()) + i)
        j = torch.remainder(mixed.long(), R)
    return _wrap32(acc)


def gather_chain(T: torch.Tensor, idx: torch.Tensor,
                 iters: int = ITERS) -> torch.Tensor:
    """acc [B] int32 as gather_chain_plain; on the card one launch, one
    thread per lane."""
    if T.dim() != 2 or T.shape[1] != WIDTH or T.shape[0] >= 2**31:
        raise ValueError(f"gather_chain: the table must be [rows < 2^31, {WIDTH}]")
    if idx.dim() != 1:
        raise ValueError("gather_chain: the indices must be [B]")
    if T.device.type == "cpu":
        return gather_chain_plain(T, idx, iters)
    dev = T.device
    acc = torch.empty(idx.shape[0], dtype=torch.int32, device=dev)
    _build.launch("pgt_gather_chain", _build.check("T", T, torch.int32, dev),
                  T.shape[0], _build.check("idx", idx, torch.int32, dev),
                  idx.shape[0], int(iters), acc.data_ptr(), _build.stream(dev))
    gather_chain.launches += 1
    return acc


gather_chain.launches = 0
