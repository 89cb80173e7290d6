"""m-mer seed table on the device, and the per-read work proxy.

The table holds the FMD bi-interval (k, kp, s) of every ACGT m-mer, keyed by
its 2-bit pack with the leftmost base in the highest bits (the layout of
pangenome_index_tpu/ops/mertable.py). It is built level by level: level v
extends the interval of every length-v suffix by each of the four bases, one
launch of the extension kernel (K2) over 4^(v+1) lanes, the same schedule as
the explicit-expansion levels of build_mer_table_device. Failed extensions
stay (0, 0, 0), so the table equals the host build_mer_table.
"""

from __future__ import annotations

import torch

from ..host import read_mer_keys_fast  # noqa: F401
from .fmd import extend
from .tables import RIndexTables


def build_mer_table_device(t: RIndexTables, m: int) -> torch.Tensor:
    """[4^m, 3] (k, kp, s) table on the tables' device, int32 positions."""
    dev = t.device
    k = torch.zeros(1, dtype=t.pos_dtype, device=dev)
    kp = torch.zeros(1, dtype=t.pos_dtype, device=dev)
    s = torch.full((1,), t.n, dtype=t.pos_dtype, device=dev)
    for v in range(m):
        size = 4 ** (v + 1)
        # new key = b << 2v | old key: tile the old state 4x and prepend the
        # base read off the new key (codes 1, 2, 3, 5 for bases 0..3)
        b = torch.arange(size, dtype=torch.int32, device=dev) >> (2 * v)
        code = b + 1 + (b == 3).to(torch.int32)
        k, kp, s = extend(t, k.repeat(4), kp.repeat(4), s.repeat(4), code)
    return torch.stack((k, kp, s), dim=1)


def seed_difficulty(mer_table: torch.Tensor, keys: torch.Tensor,
                    valid: torch.Tensor, min_occ: int, lengths: torch.Tensor,
                    m: int) -> torch.Tensor:
    """Per-read work proxy for work-sorted batching: in-read windows whose
    m-mer interval fails min_occ, plus in-read windows with no valid m-mer
    (mertable.py:seed_difficulty with lengths given). [B]."""
    s = mer_table[keys.reshape(-1).long(), 2].reshape(keys.shape)
    bad = ((s < max(int(min_occ), 1)) & valid).sum(dim=1)
    in_read = (lengths.long() - (m - 1)).clamp(min=0)
    return bad + in_read - valid.sum(dim=1)
