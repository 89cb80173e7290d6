"""m-mer seed table on the device, and the per-read work proxy.

The table holds the FMD bi-interval (k, kp, s) of every ACGT m-mer, keyed by
its 2-bit pack with the leftmost base in the highest bits (the layout of
pangenome_index_tpu/ops/mertable.py). It is built level by level from the
root (0, 0, n): level v + 1 holds the backward extension of every interval
of level v by each of the four bases, child b of key p at key b << 2v | p.
On the card each level is one launch of the kernel of csrc/mertable.cu
(mer_level: one thread per parent, one rank pair through the tables' rank
provider, the four children written in the table layout), the last launch
two levels deep except through int64 bucketed runs (last_depth), so that
the build of m levels is max(m - 1, 1) launches, or m through those,
and no torch pass between them; mer_level_plain is its plain version (the
same parent-per-lane schedule through ops/rank.py's rank6, in slabs of
parents), which tables on the CPU take. Failed extensions stay (0, 0, 0),
so the table equals the host build_mer_table.

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

from .. import _build, native
from ..utils.alphabet import BASE_CODES, KP_WEIGHT
from .dense_rank import gather_rows
from .fmd import check_kernel_tables, rank_args
from .rank import rank6
from .tables import DeferredTables, RIndexTables

#: tables past this size are rebuilt per process instead of cached: the
#: device-to-host fetch and the disk round trip cost more than the build
#: (pangenome_index_tpu/ops/mertable.py:285-292)
CACHE_MAX_BYTES = 1 << 30
#: parents a step of mer_level_plain takes: its rank temporaries (a [B, 6,
#: 64] mask of checkpoint rows) stay under a GB at m = 14
PLAIN_SLAB = 1 << 20


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


def mer_level_plain(t: RIndexTables, parents: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """parents [4^v, 3] (level v) -> level v + depth [4^(v + depth), 3], in
    the tables' position dtype: per parent one rank6 pair (ops/rank.py), in
    slabs of PLAIN_SLAB parents, and its four backward extensions, child b
    of parent p at row b * 4^v + p; a parent of size 0 gives (0, 0, 0)."""
    dev, pd, slab = parents.device, t.pos_dtype, PLAIN_SLAB
    C = t.C.long()
    weight = torch.from_numpy(KP_WEIGHT.astype(np.int64)).to(dev)
    for _ in range(depth):
        n = parents.shape[0]
        out = torch.empty((4 * n, 3), dtype=pd, device=dev)
        for a in range(0, n, slab):
            k, kp, s = parents[a : a + slab].long().unbind(1)
            r_k = rank6(t, k.to(pd)).long()
            delta = rank6(t, (k + s).to(pd)).long() - r_k
            for b, code in enumerate(BASE_CODES):
                ok = delta[:, code] > 0
                child = torch.stack((r_k[:, code] + C[code],
                                     kp + (delta * weight[code]).sum(dim=1),
                                     delta[:, code]), dim=1)
                out[b * n + a : b * n + a + k.shape[0]] = torch.where(ok[:, None], child, 0)
        parents = out
    return parents


def mer_level(t: RIndexTables, parents: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """mer_level_plain; on the card one launch of the level kernel
    (csrc/mertable.cu) through the tables' rank provider, the plain version
    for tables on the CPU. depth: 1, or 2 (the grandchildren, the level
    between them kept in registers)."""
    n = parents.shape[0]
    v = (n.bit_length() - 1) // 2
    if not (parents.dim() == 2 and parents.shape[1] == 3 and n == 4 ** v and v <= 15
            and depth in (1, 2)):
        raise ValueError(f"mer_level: parents must be [4^v, 3] with v <= 15 and depth "
                         f"1 or 2, not {tuple(parents.shape)} and {depth}")
    if parents.device.type == "cpu":
        return mer_level_plain(t, parents, depth)
    check_kernel_tables(t)
    dev, pd = t.device, t.pos_dtype
    kind, rargs = rank_args(t)
    out = torch.empty((n << (2 * depth), 3), dtype=pd, device=dev)
    _build.launch(f"pgt_mer_level_{kind}", *rargs, _build.check("C", t.C, pd, dev),
                  _build.check("parents", parents, pd, dev), n, v, depth,
                  out.data_ptr(), _build.stream(dev))
    mer_level.launches += 1
    return out


mer_level.launches = 0


def mer_root(t: RIndexTables) -> torch.Tensor:
    """Level 0: the interval (0, 0, n) of the empty string, [1, 3] on the
    tables' device (made there, so that a CUDA graph may hold the build)."""
    root = torch.zeros((1, 3), dtype=t.pos_dtype, device=t.device)
    root[:, 2].fill_(t.n)  # a fill kernel: no copy from the host
    return root


def last_depth(t: RIndexTables) -> int:
    """Levels the build's last launch makes: 2 (level m - 1 kept in
    registers), but 1 through int64 bucketed runs (the provider of
    ops/fmd.py's rank_args when the tables hold no rows or records), where
    a thread's four children's 64-byte run records make the fused launch
    slower than two one-deep launches (PERF.md)."""
    bucketed = t.ckpt is None and t.rank_table is None and t.rec is None
    return 1 if bucketed and t.pos_dtype == torch.int64 else 2


def build_mer_table_device(t: RIndexTables, m: int, level=mer_level) -> torch.Tensor:
    """[4^m, 3] (k, kp, s) table on the tables' device, in their position
    dtype (int64 at n >= 2^31): level by level from the root through
    `level` (mer_level: the kernel on the card, its plain version on the
    CPU), one level a launch and the last launch last_depth(t) levels
    deep."""
    table = mer_root(t)
    last = min(m, last_depth(t))
    for _ in range(m - last):
        table = level(t, table, 1)
    return level(t, table, last) if m else table


def build_mer_table_plain(t: RIndexTables, m: int) -> torch.Tensor:
    """build_mer_table_device through mer_level_plain, on any device."""
    return build_mer_table_device(t, m, level=mer_level_plain)


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


def mer_table_bytes(m: int, item: int = 4, depth: int = 2) -> int:
    """Device bytes build_mer_table_device needs at m: its peak is the last
    launch, `depth` levels deep (last_depth), which reads level m - depth
    and writes the [4^m, 3] table, in positions of `item` bytes."""
    return 3 * item * (4 ** m + 4 ** max(m - depth, 0))


def device_budget(device) -> int | None:
    """Bytes the device has free for a build: the CUDA runtime's free memory
    and the allocator's cached blocks; None (no budget) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def get_mer_table(idx, m: int, tables: RIndexTables | DeferredTables, path=None,
                  max_bytes: int | None = None):
    """(table [4^m_used, 3] on the tables' device in their position dtype,
    m_used), as pangenome_index_tpu/ops/mertable.py:get_mer_table: m is
    tried first, then m - 1, down to min_m = max(m - 2, 4).

    At each m: the npz cache at path(m) when its content key matches
    (index, m) and the table fits the budget; else the build of the level
    kernel (build_mer_table_device), written to path(m), when its bytes
    (mer_table_bytes) fit; else a step down, named on stderr in the
    reference's words. The budget is max_bytes, by default what the device
    has free (device_budget; none on the CPU), and is decided before
    anything is allocated. DeferredTables are built at the first miss (and
    the budget read again after them); a cache hit needs none. `path`: a
    function of m, or a file name for m only, or None; a table past CACHE_MAX_BYTES skips the cache. Below
    min_m it raises MemoryError with the sizes: the port has no host build
    behind the device's."""
    path_fn = path if callable(path) else (lambda mt: path if mt == m else None)
    min_m = max(m - 2, 4)
    budget_of_device = max_bytes is None
    if budget_of_device:
        max_bytes = device_budget(tables.device)
    item = tables.pos_dtype.itemsize
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
        if isinstance(tables, DeferredTables):  # a miss: the build needs them now
            tables = tables.get()
            if budget_of_device:
                max_bytes = device_budget(tables.device)
        depth = last_depth(tables)
        need = mer_table_bytes(m_try, item, depth)
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
                      f"{mer_table_bytes(min_m, item, depth)})")
