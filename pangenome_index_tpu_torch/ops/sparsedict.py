"""Sparse long-seed dictionary: bi-intervals of every length-s ACGT substring
that occurs in the index.

The build is a level-synchronous frontier: level t holds the bi-intervals
(key, k, kp, size) of every distinct length-t substring; one rank6 pair per
entry extends it by the four bases, and the children that occur at least
min_keep times are compacted branch-major, which keeps the keys sorted with
no sort. Keys are plain int64, so s = 31 is exact.

On the device (build_sparse_dict_device, the counterpart of
pangenome_index_tpu/ops/sparsedict.py:_level_step_device and
build_sparse_dict_device) a level is two wrappers over the kernels of
csrc/sparsedict.cu: sdict_expand (the children of every entry and the scan of
the kept counts) and sdict_scatter (the compaction), each with a plain
PyTorch version beside it that CPU tensors take. The total of a level is read
between the two (one small copy a level) and the next level allocated at its
exact size, so there is no capacity guess and no restart; a level that would
not fit the device's free memory raises MemoryError.

The host side is the port's copy of the numpy parts of the JAX module (same
values, same npz cache): build_sparse_dict, the exact reference of the device
build; the content-keyed cache; and the per-read window lookup through the
native pass. get_sparse_dict builds on the device when it is given tables and
on the host when it is not; it never falls back from one to the other. The
seed-resolving pass of the MEM engine reads the dictionary values and the
per-read dictionary row of every window on the device.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import torch

from .. import _build, native
from ..utils.alphabet import BASE_CODES, KP_WEIGHT
from .fmd import check_kernel_tables, rank_args
from .rank import rank6
from .tables import RIndexTables

#: longest supported window: 2 bits/base must fit an int64 key
MAX_S = 31

#: device-residency budget for the dictionary values table; serving falls
#: back to the dense tier when the dictionary exceeds it
#: (override: PANIDX_SDICT_MAX_BYTES)
DEVICE_BYTES_CAP = int(os.environ.get("PANIDX_SDICT_MAX_BYTES", 6 << 30))


def build_sparse_dict(idx, s: int, min_keep: int = 1):
    """Enumerate all length-s ACGT substrings with interval size >= min_keep.

    Returns (keys [D] int64 sorted ascending, vals [D, 3]) where keys pack
    2-bit bases with the leftmost character in the highest bits (matching
    read_mer_keys_fast) and vals rows are (k, kp, size) bi-intervals - int32
    when every value fits, else int64.

    Construction is right-to-left prepending, so concatenating the four
    branch blocks in base order keeps keys sorted at every level with no
    final sort."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s must be in [1, {MAX_S}]")
    keys = np.zeros(1, np.int64)
    k = np.zeros(1, np.int64)
    kp = np.zeros(1, np.int64)
    sz = np.full(1, idx.n, np.int64)
    thresh = max(int(min_keep), 1)
    for t in range(s):
        r_k = idx.rank6(k)
        r_ks = idx.rank6(k + sz)
        delta = r_ks - r_k  # [D_t, 6]
        parts = []
        for b, code in enumerate(BASE_CODES):
            code = int(code)
            s2 = delta[:, code]
            keep = s2 >= thresh
            k2 = (r_k[:, code] + idx.C[code])[keep]
            kp2 = (kp + (KP_WEIGHT[code][None, :] * delta).sum(axis=1))[keep]
            parts.append((keys[keep] | (np.int64(b) << (2 * t)),
                          k2, kp2, s2[keep]))
        keys = np.concatenate([p[0] for p in parts])
        k = np.concatenate([p[1] for p in parts])
        kp = np.concatenate([p[2] for p in parts])
        sz = np.concatenate([p[3] for p in parts])
    dt = np.int32 if idx.n < 2**31 else np.int64
    return keys, np.stack((k, kp, sz), axis=1).astype(dt)


#: entries a block of the level kernels (csrc/sparsedict.cu:kBlock): the
#: partition that sdict_expand counts kept children by and sdict_scatter
#: places them by
LEVEL_BLOCK = 256
_BASES = [int(c) for c in BASE_CODES]


def sdict_expand_plain(t: RIndexTables, vals: torch.Tensor, thresh: int):
    """One level's children, plain: vals [D, 3] (k, kp, size) -> (child_sz
    [4, D] with 0 where the child is dropped, child_kkp [4, D, 2] (k', kp',
    0 where dropped), offsets [4, blocks] the exclusive prefix sums of the
    kept children per branch and block of LEVEL_BLOCK entries, read
    branch-major as one row, total [1] their sum)."""
    D = vals.shape[0]
    dev = vals.device
    k, kp, sz = vals.unbind(dim=1)
    both = rank6(t, torch.cat((k, k + sz)))  # one batch for both ends
    r_k = both[:D]
    delta = both[D:] - r_k
    kpw = torch.as_tensor(KP_WEIGHT[_BASES], dtype=vals.dtype, device=dev)
    cs = delta[:, _BASES].T
    keep = cs >= thresh
    ck = (r_k[:, _BASES] + t.C[_BASES]).T
    ckp = kp[None, :] + (delta[None, :, :] * kpw[:, None, :]).sum(dim=2)
    zero = torch.zeros((), dtype=vals.dtype, device=dev)
    child_sz = torch.where(keep, cs, zero).to(vals.dtype).contiguous()
    child_kkp = torch.stack((torch.where(keep, ck, zero),
                             torch.where(keep, ckp, zero)), dim=2).to(vals.dtype)
    blocks = -(-D // LEVEL_BLOCK)
    padded = torch.nn.functional.pad(keep, (0, blocks * LEVEL_BLOCK - D))
    counts = padded.view(4, blocks, LEVEL_BLOCK).sum(dim=2).reshape(-1)
    incl = torch.cumsum(counts, dim=0)
    return (child_sz, child_kkp.contiguous(),
            (incl - counts).to(vals.dtype).view(4, blocks),
            incl[-1:].to(vals.dtype))


def sdict_expand(t: RIndexTables, vals: torch.Tensor, thresh: int):
    """(child_sz, child_kkp, offsets, total) as sdict_expand_plain; on the
    card the expand kernel and the scan of its counts (int32 tables), the
    plain version on the CPU. D must be at least 1."""
    if vals.dim() != 2 or vals.shape[1] != 3 or vals.shape[0] < 1:
        raise ValueError("sdict_expand: vals must be [D, 3] with D >= 1")
    if vals.device.type == "cpu":
        return sdict_expand_plain(t, vals, thresh)
    check_kernel_tables(t)
    dev = t.device
    D = vals.shape[0]
    blocks = -(-D // LEVEL_BLOCK)
    kind, rargs = rank_args(t)
    child_sz = torch.empty((4, D), dtype=torch.int32, device=dev)
    child_kkp = torch.empty((4, D, 2), dtype=torch.int32, device=dev)
    counts = torch.empty((4, blocks), dtype=torch.int32, device=dev)
    offsets = torch.empty((4, blocks), dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    _build.launch(f"pgt_sdict_expand_{kind}", *rargs,
                  _build.check("C", t.C, torch.int32, dev),
                  _build.check("vals", vals, torch.int32, dev), D, int(thresh),
                  blocks, child_sz.data_ptr(), child_kkp.data_ptr(),
                  counts.data_ptr(), offsets.data_ptr(), total.data_ptr(),
                  _build.stream(dev))
    sdict_expand.launches += 1
    return child_sz, child_kkp, offsets, total


sdict_expand.launches = 0


def sdict_scatter_plain(keys: torch.Tensor, child_sz: torch.Tensor,
                        child_kkp: torch.Tensor, total: int, level: int):
    """The next level, plain: the kept children of sdict_expand, branch-major
    with the source order kept inside a branch -> (keys [total] int64 with
    the base at bits 2 level and 2 level + 1, vals [total, 3])."""
    dev = keys.device
    keep = (child_sz != 0).reshape(-1)
    dst = (torch.cumsum(keep, dim=0) - 1)[keep]
    base = torch.arange(4, dtype=torch.int64, device=dev)[:, None] << (2 * level)
    out_keys = torch.empty(total, dtype=torch.int64, device=dev)
    out_vals = torch.empty((total, 3), dtype=child_sz.dtype, device=dev)
    out_keys[dst] = (keys[None, :] | base).reshape(-1)[keep]
    out_vals[dst, 0] = child_kkp[..., 0].reshape(-1)[keep]
    out_vals[dst, 1] = child_kkp[..., 1].reshape(-1)[keep]
    out_vals[dst, 2] = child_sz.reshape(-1)[keep]
    return out_keys, out_vals


def sdict_scatter(keys: torch.Tensor, child_sz: torch.Tensor,
                  child_kkp: torch.Tensor, offsets: torch.Tensor, total: int,
                  level: int):
    """(keys, vals) of the next level as sdict_scatter_plain; on the card the
    scatter kernel, which places a child by `offsets` and its rank in its
    block. `total` is what sdict_expand reported, as a host integer."""
    D = keys.shape[0]
    if child_sz.shape != (4, D) or child_kkp.shape != (4, D, 2) or D < 1:
        raise ValueError("sdict_scatter: children must be [4, D] and [4, D, 2] "
                         "for keys [D], D >= 1")
    if not 0 <= level < MAX_S:
        raise ValueError(f"sdict_scatter: level must be in [0, {MAX_S})")
    if keys.device.type == "cpu":
        return sdict_scatter_plain(keys, child_sz, child_kkp, total, level)
    dev = keys.device
    blocks = -(-D // LEVEL_BLOCK)
    if offsets.shape != (4, blocks):
        raise ValueError("sdict_scatter: offsets must be [4, blocks]")
    out_keys = torch.empty(total, dtype=torch.int64, device=dev)
    out_vals = torch.empty((total, 3), dtype=torch.int32, device=dev)
    _build.launch("pgt_sdict_scatter",
                  _build.check("keys", keys, torch.int64, dev),
                  _build.check("child_sz", child_sz, torch.int32, dev),
                  _build.check("child_kkp", child_kkp, torch.int32, dev),
                  _build.check("offsets", offsets, torch.int32, dev), D, blocks,
                  level, out_keys.data_ptr(), out_vals.data_ptr(),
                  _build.stream(dev))
    sdict_scatter.launches += 1
    return out_keys, out_vals


sdict_scatter.launches = 0


def _check_budget(live: int, need: int, max_bytes, what: str) -> None:
    """Raise MemoryError when `need` more bytes beside the build's `live`
    ones pass `max_bytes` (None: no budget)."""
    if max_bytes is not None and live + need > max_bytes:
        raise MemoryError(f"sparse dict device build: {what} needs {need} bytes "
                          f"beside {live} live ones, the budget is {max_bytes}")


def build_sparse_dict_device(idx_or_n, tables: RIndexTables, s: int,
                             min_keep: int = 1, max_bytes: int | None = None):
    """`build_sparse_dict` with every frontier level on the tables' device:
    (keys [D] int64 sorted, vals [D, 3] in the tables' position dtype) as
    tensors there, element for element the host build's arrays.

    idx_or_n: the index the tables were made from, or its n. Each level is
    sdict_expand, one read of the level's total, sdict_scatter into tensors
    of exactly that size. A failed launch raises; a level whose tensors would
    not fit raises MemoryError with the sizes (max_bytes: a budget for the
    build's own tensors; default on a CUDA device what it has free when the
    build starts, the CUDA runtime's free memory and the allocator's cached
    blocks, and none on the CPU)."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s must be in [1, {MAX_S}]")
    n = int(getattr(idx_or_n, "n", idx_or_n))
    if n != tables.n:
        raise ValueError(f"tables of an index of {tables.n} rows, not {n}")
    dev = tables.device
    if max_bytes is None and dev.type == "cuda":
        max_bytes = (torch.cuda.mem_get_info(dev)[0]
                     + torch.cuda.memory_reserved(dev)
                     - torch.cuda.memory_allocated(dev))
    keys = torch.zeros(1, dtype=torch.int64, device=dev)
    vals = torch.tensor([[0, 0, n]], dtype=tables.pos_dtype, device=dev)
    thresh = max(int(min_keep), 1)
    item = vals.element_size()
    for level in range(s):
        D = keys.shape[0]
        if D == 0:  # nothing occurs at this length: the dictionary is empty
            break
        live = D * (8 + 3 * item)
        scratch = 12 * D * item + 8 * item * -(-D // LEVEL_BLOCK)
        _check_budget(live, scratch, max_bytes,
                      f"level {level}, the children of {D} entries,")
        child_sz, child_kkp, offsets, total = sdict_expand(tables, vals, thresh)
        total = int(total)  # the one read of a level
        _check_budget(live + scratch, total * (8 + 3 * item), max_bytes,
                      f"level {level + 1}, {total} entries,")
        if total:
            keys, vals = sdict_scatter(keys, child_sz, child_kkp, offsets,
                                       total, level)
        else:
            keys, vals = keys[:0], vals[:0]
    return keys, vals


def sparse_dict_key(idx, s: int, min_keep: int = 1) -> str:
    """Content key of (index, s, min_keep): the dictionary is a pure function
    of these (the scheme of mertable.mer_table_key)."""
    h = hashlib.sha1()
    h.update(np.int64([0x5D1C7, s, min_keep, idx.n, idx.n_runs]).tobytes())
    h.update(np.ascontiguousarray(idx.run_sym).tobytes())
    h.update(np.ascontiguousarray(idx.run_len).tobytes())
    return h.hexdigest()[:16]


def get_sparse_dict(idx, s: int, path=None, min_keep: int = 1, tables=None):
    """Cached build: (keys, vals), persisted at `path` keyed by content (the
    JAX package's npz cache file, byte-compatible).

    Without tables: the host build, numpy arrays. With tables: the frontier
    runs on their device (build_sparse_dict_device), keys come back as a
    numpy array for the native window pass and vals as a tensor on that
    device, where the MEM engine reads them, from the cache or from the
    build. There is no fallback: with tables a failed build raises."""
    key = sparse_dict_key(idx, s, min_keep)
    keys = vals = None
    if path is not None and os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    keys, vals = z["keys"], z["vals"]
                else:
                    print(f"sparse dict {path}: stale key, rebuilding",
                          file=sys.stderr)
        except Exception as exc:
            print(f"sparse dict {path}: unreadable ({exc}), rebuilding",
                  file=sys.stderr)
    if keys is not None:
        if tables is not None:
            vals = torch.from_numpy(np.ascontiguousarray(vals)).to(tables.device)
        return keys, vals
    if tables is not None:
        keys_d, vals = build_sparse_dict_device(idx, tables, s, min_keep)
        keys, vals_np = keys_d.cpu().numpy(), None
    else:
        keys, vals = build_sparse_dict(idx, s, min_keep)
        vals_np = vals
    if path is not None:
        try:
            if vals_np is None:
                vals_np = vals.cpu().numpy()
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as fh:
                np.savez(fh, keys=keys, vals=vals_np, key=key)
            os.replace(tmp, path)
        except Exception as exc:
            print(f"sparse dict {path}: not saved ({exc})", file=sys.stderr)
    return keys, vals


def read_windows_fast(codes: np.ndarray, lengths: np.ndarray, s: int,
                      dict_keys: np.ndarray):
    """(keys, valid, dict row idx) of every read window [B, L+1] in one
    native pass (rolling keys + radix-bucketed lookups); idx is -1 for
    absent or invalid windows."""
    keys, valid, idx = native.read_windows_native(codes, lengths, s,
                                                  dict_keys=dict_keys)
    if idx is None:  # empty dictionary (nothing occurs at this s): all miss
        idx = np.full(keys.shape, -1, np.int32)
    return keys, valid, idx


def sdict_to_device(vals, dict_rows: np.ndarray, device):
    """(vals [D, 3] as a numpy array or a tensor, dict_rows [B, L+1] with -1
    for absent windows) -> int32 tensors on `device`. An empty dictionary
    gives one all-zero row, which no window points at."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.ascontiguousarray(vals))
    if vals.shape[0] == 0:
        vals = torch.zeros((1, 3), dtype=torch.int32)
    if vals.dtype != torch.int32:
        raise ValueError("the port's dictionary tier takes int32 values (n < 2^31)")
    return (vals.to(device),
            torch.from_numpy(np.ascontiguousarray(dict_rows, np.int32)).to(device))
