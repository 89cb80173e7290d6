"""Checkpoint rank6, plain PyTorch.

The plain version of the checkpoint rank provider in csrc/rank.cuh
(CkptRank), which extend (K2) and find_mems (K3) instantiate; it mirrors
pangenome_index_tpu/ops/rank.py:_ckpt_rank6 and ckpt_row_rank6. Each
checkpoint row holds the occ counts before its bucket (cols 0..5) and the
bucket's 64 BWT codes as 4-bit nibbles (cols 6..13, LSB first, 0xF past n);
rank6(pos) is the row of pos >> 6 plus the count of each code among its first
pos & 63 nibbles. Row indices clamp into the table as JAX gathers do.
"""

from __future__ import annotations

import torch

from .tables import RIndexTables

_NIBBLE_SHIFTS = torch.arange(0, 32, 4, dtype=torch.int32)


def ckpt_rank6(t: RIndexTables, pos: torch.Tensor) -> torch.Tensor:
    """pos [B] -> [B, 6] occ counts, including the two-level ckpt_super add."""
    ckpt = t.ckpt
    row = ckpt[(pos.long() >> 6).clamp(0, ckpt.shape[0] - 1)]     # [B, 16]
    shifts = _NIBBLE_SHIFTS.to(ckpt.device)
    nib = (row[:, 6:14, None] >> shifts) & 0xF                    # [B, 8, 8]
    nib = nib.reshape(-1, 64)                                     # LSB first
    before = torch.arange(64, device=ckpt.device)[None, :] \
        < (pos.long() & 63)[:, None]
    codes = torch.arange(6, device=ckpt.device, dtype=nib.dtype)
    hits = (nib[:, None, :] == codes[None, :, None]) & before[:, None, :]
    r6 = row[:, :6].to(t.pos_dtype) + hits.sum(dim=2).to(t.pos_dtype)
    if t.ckpt_super is not None:
        ss = t.ckpt_super.shape[1] - 6
        sup = t.ckpt_super[(pos.long() >> ss).clamp(0, t.ckpt_super.shape[0] - 1)]
        r6 = sup[:, :6] + r6
    return r6
