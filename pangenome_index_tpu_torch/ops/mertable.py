"""m-mer seed table on the device, and the per-read work proxy.

The table holds the FMD bi-interval (k, kp, s) of every ACGT m-mer, keyed by
its 2-bit pack with the leftmost base in the highest bits (the layout of
pangenome_index_tpu/ops/mertable.py). It is built level by level: level v
extends the interval of every length-v suffix by each of the four bases, one
launch of the extension kernel (K2) over 4^(v+1) lanes, the same schedule as
the explicit-expansion levels of build_mer_table_device. Failed extensions
stay (0, 0, 0), so the table equals the host build_mer_table.

get_mer_table reads and writes the JAX package's npz cache of the table
(same content key, same 1 GB cap on cached tables); it has no step-down of
m and no host build when a device build fails, so a kernel failure raises.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..host import mer_table_key, read_mer_keys_fast  # noqa: F401
from .fmd import extend
from .tables import RIndexTables

#: tables past this size are rebuilt per process instead of cached: the
#: device-to-host fetch and the disk round trip cost more than the build
#: (pangenome_index_tpu/ops/mertable.py:285-292)
CACHE_MAX_BYTES = 1 << 30


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


def resolve_mer_len(arg: int, min_len: int, n: int, device) -> int:
    """Seed-table size m, as pangenome_index_tpu/cli.py:_resolve_mer_len:
    -1 = auto, the largest table that fits comfortably (14 on a CUDA
    device, 13 when n >= 2^31; 8 on the CPU, where the build runs the plain
    extension), at most about 128 n entries and min_len - 1. 0 = no seeds
    (also when m < 4 or min_len <= m)."""
    if arg != -1:
        return arg if (arg and min_len > arg) else 0
    if torch.device(device).type == "cuda":
        cap = 14 if n < 2**31 else 13
    else:
        cap = 8
    cap = min(cap, int(np.log2(max(128 * n, 4)) / 2))
    m = min(cap, min_len - 1)
    return m if m >= 4 else 0


def get_mer_table(idx, m: int, tables: RIndexTables, path=None) -> torch.Tensor:
    """[4^m, 3] seed table on the tables' device, in their position dtype:
    the npz cache at `path` when its content key matches (index, m), else
    built with K2 launches (build_mer_table_device) and written to `path`.
    path None, or a table past CACHE_MAX_BYTES, skips the cache."""
    key = mer_table_key(idx, m)
    item = 8 if idx.n >= 2**31 else 4
    if path is not None and (4 ** m) * 3 * item > CACHE_MAX_BYTES:
        path = None
    if path is not None and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) == key:
                table = np.ascontiguousarray(z["table"])
                return torch.from_numpy(table).to(tables.device, tables.pos_dtype)
        print(f"mer cache {path}: stale key, rebuilding", file=sys.stderr)
    table = build_mer_table_device(tables, m)
    if path is not None:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, table=table.cpu().numpy(), key=key)
        os.replace(tmp, path)
    return table
