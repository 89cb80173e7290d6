"""m-mer seed table on the device, and the per-read work proxy.

The table holds the FMD bi-interval (k, kp, s) of every ACGT m-mer, keyed by
its 2-bit pack with the leftmost base in the highest bits (the layout of
pangenome_index_tpu/ops/mertable.py). It is built level by level: level v
extends the interval of every length-v suffix by each of the four bases, one
launch of the extension kernel (K2) over 4^(v+1) lanes, the same schedule as
the explicit-expansion levels of build_mer_table_device. Failed extensions
stay (0, 0, 0), so the table equals the host build_mer_table.

get_mer_table reads and writes the JAX package's npz cache of the table
(same content key, same 1 GB cap on cached tables) and steps m down, as the
reference does, when the build would not fit the device's free memory; it
has no host build behind the device's, so below the last m it raises, and
a kernel failure raises.

The host side is the port's copy of the numpy parts of
pangenome_index_tpu/ops/mertable.py: build_mer_table (the exact reference
of the device build), mer_table_key (the cache's content key) and
read_mer_keys_fast (per-position keys of a read batch, native pass).
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import torch

from .. import native
from ..utils.alphabet import BASE_CODES, KP_WEIGHT
from .dense_rank import gather_rows
from .fmd import extend
from .tables import RIndexTables

#: tables past this size are rebuilt per process instead of cached: the
#: device-to-host fetch and the disk round trip cost more than the build
#: (pangenome_index_tpu/ops/mertable.py:285-292)
CACHE_MAX_BYTES = 1 << 30


def _batched_backward_extend(idx, k, kp, s, code: int):
    r_k = idx.rank6(k)
    r_ks = idx.rank6(k + s)
    delta = r_ks - r_k
    kp2 = kp + (KP_WEIGHT[code][None, :] * delta).sum(axis=1)
    s2 = delta[:, code]
    k2 = r_k[:, code] + idx.C[code]
    ok = s2 > 0
    return np.where(ok, k2, 0), np.where(ok, kp2, 0), np.where(ok, s2, 0)


def build_mer_table(idx, m: int) -> np.ndarray:
    """Host build: [4^m, 3] int64 array of (k, kp, s) for every m-mer, keyed
    by the 2-bit pack with the leftmost character in the highest bits."""
    k = np.zeros(1, dtype=np.int64)
    kp = np.zeros(1, dtype=np.int64)
    s = np.full(1, idx.n, dtype=np.int64)
    # right to left: level t holds the intervals of all length-t suffixes,
    # keyed by their 2-bit pack (leftmost char of the suffix in high bits)
    for t in range(m):
        size = 4**t
        nk = np.empty(4 * size, dtype=np.int64)
        nkp = np.empty(4 * size, dtype=np.int64)
        ns = np.empty(4 * size, dtype=np.int64)
        for b, code in enumerate(BASE_CODES):
            # prepending base b: new_key = b << (2t) | old_key
            ek, ekp, es = _batched_backward_extend(idx, k, kp, s, int(code))
            nk[b * size : (b + 1) * size] = ek
            nkp[b * size : (b + 1) * size] = ekp
            ns[b * size : (b + 1) * size] = es
        k, kp, s = nk, nkp, ns
    return np.stack((k, kp, s), axis=1)


def mer_table_key(idx, m: int) -> str:
    """Content key of the (index, m) pair the table is a pure function of."""
    h = hashlib.sha1()
    h.update(np.int64([m, idx.n, idx.n_runs]).tobytes())
    h.update(np.ascontiguousarray(idx.run_sym).tobytes())
    h.update(np.ascontiguousarray(idx.run_len).tobytes())
    return h.hexdigest()[:16]


def read_mer_keys_fast(codes: np.ndarray, lengths: np.ndarray, m: int):
    """Per-position rolling m-mer keys of a read batch, through the native
    pass: (keys [B, L+1] int32, or int64 when m > 15, valid [B, L+1] bool).
    Entry i describes the window codes[i-m+1 .. i]; valid requires the
    window to be ACGT-only and fully inside the read."""
    k, v, _ = native.read_windows_native(codes, lengths, m)
    return k, v


def build_mer_table_device(t: RIndexTables, m: int) -> torch.Tensor:
    """[4^m, 3] (k, kp, s) table on the tables' device, in their position
    dtype (int64 at n >= 2^31, where K2 runs its int64 instantiation)."""
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
    (mertable.py:seed_difficulty with lengths given). [B]. The table rows
    come through gather_rows: the row gather kernel on the card. Serving
    does not sort (a thread per read gains nothing from it); mems_probe.py
    measures that with this proxy."""
    s = gather_rows(mer_table, keys.reshape(-1))[:, 2].reshape(keys.shape)
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


def mer_table_bytes(m: int, item: int = 4) -> int:
    """Device bytes build_mer_table_device needs at m: at its last level the
    four-fold copies of the last state, the bases, the three outputs of K2
    and the stacked table, nine [4^m] arrays of `item` bytes."""
    return 9 * (4 ** m) * item


def device_budget(device) -> int | None:
    """Bytes the device has free for a build: the CUDA runtime's free memory
    and the allocator's cached blocks; None (no budget) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def get_mer_table(idx, m: int, tables: RIndexTables, path=None,
                  max_bytes: int | None = None):
    """(table [4^m_used, 3] on the tables' device in their position dtype,
    m_used), as pangenome_index_tpu/ops/mertable.py:get_mer_table: m is
    tried first, then m - 1, down to min_m = max(m - 2, 4).

    At each m: the npz cache at path(m) when its content key matches
    (index, m) and the table fits the budget; else the build with K2
    launches (build_mer_table_device), written to path(m), when its bytes
    (mer_table_bytes) fit; else a step down, named on stderr in the
    reference's words. The budget is max_bytes, by default what the device
    has free (device_budget; none on the CPU), and is decided before
    anything is allocated. `path`: a function of m, or a file name for m
    only, or None; a table past CACHE_MAX_BYTES skips the cache. Below
    min_m it raises MemoryError with the sizes: the port has no host build
    behind the device's."""
    path_fn = path if callable(path) else (lambda mt: path if mt == m else None)
    min_m = max(m - 2, 4)
    if max_bytes is None:
        max_bytes = device_budget(tables.device)
    item = tables.C.element_size()
    for m_try in range(m, min_m - 1, -1):
        key = mer_table_key(idx, m_try)
        table_bytes = (4 ** m_try) * 3 * item
        mpath = path_fn(m_try)
        if table_bytes > CACHE_MAX_BYTES:
            mpath = None
        fits = max_bytes is None or table_bytes <= max_bytes
        if mpath is not None and fits and os.path.exists(mpath):
            with np.load(mpath, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    table = np.ascontiguousarray(z["table"])
                    return (torch.from_numpy(table).to(tables.device, tables.pos_dtype),
                            m_try)
            print(f"mer cache {mpath}: stale key, rebuilding", file=sys.stderr)
        need = mer_table_bytes(m_try, item)
        if max_bytes is not None and need > max_bytes:
            print(f"mer table: device build failed at m={m_try} (MemoryError: "
                  f"the build needs {need} bytes, the budget is {max_bytes}); "
                  f"stepping down", file=sys.stderr)
            continue
        table = build_mer_table_device(tables, m_try)
        if mpath is not None:
            tmp = f"{mpath}.tmp{os.getpid()}"
            with open(tmp, "wb") as fh:
                np.savez(fh, table=table.cpu().numpy(), key=key)
            os.replace(tmp, mpath)
        return table, m_try
    raise MemoryError(f"mer table: no m from {m} down to {min_m} fits the budget "
                      f"of {max_bytes} bytes (m={min_m} needs "
                      f"{mer_table_bytes(min_m, item)})")
