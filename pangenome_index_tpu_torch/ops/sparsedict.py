"""Sparse long-seed dictionary: bi-intervals of every length-s ACGT substring
that occurs in the index.

The build is a level-synchronous frontier: level t holds the bi-intervals
(key, k, kp, size) of every distinct length-t substring; one rank6 pair per
entry extends it by the four bases, and the children that occur at least
min_keep times are compacted branch-major, which keeps the keys sorted with
no sort. Keys are plain int64, so s = 31 is exact.

On the device (build_sparse_dict_device, the counterpart of
pangenome_index_tpu/ops/sparsedict.py:_level_step_device and
build_sparse_dict_device) a level is one launch of the kernel of
csrc/sparsedict.cu through sdict_level (the children of every entry, the
block's place in each branch by a decoupled look-back, the kept children
written into four regions, one a branch), with a plain PyTorch version
beside it that CPU tensors take. The four totals of a level are read after
it (one small copy a level); a region has a row for every entry of the
level, an exact bound, so there is no capacity guess and no restart; the
last level is packed once. A level that would not fit the device's free
memory raises MemoryError.

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
from .mertable import device_budget
from .rank import rank6
from .tables import RIndexTables, resolve_tables

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


#: entries a block of the level kernel (csrc/sparsedict.cu:kBlock): the
#: partition by which sdict_level places kept children inside a branch
LEVEL_BLOCK = 256
_BASES = [int(c) for c in BASE_CODES]


def sdict_pack(keys: torch.Tensor, vals: torch.Tensor, counts) -> tuple:
    """The entries of a level in order: the first counts[r] rows of each
    region r of keys [R, cap] and vals [R, cap, 3], concatenated ->
    (keys [D], vals [D, 3])."""
    return (torch.cat([keys[r, :c] for r, c in enumerate(counts)]),
            torch.cat([vals[r, :c] for r, c in enumerate(counts)]))


def sdict_level_plain(t: RIndexTables, keys: torch.Tensor, vals: torch.Tensor,
                      counts, thresh: int, level: int):
    """One level, plain: the D = sum(counts) entries of the regions keys
    [R, cap] / vals [R, cap, 3] (sdict_pack) -> (keys [4, D] and vals
    [4, D, 3]: region b holds the kept children of branch b, with the base
    at bits 2 level and 2 level + 1 of the key, in source order, zeros after
    them; offsets [4, blocks]: per branch the kept children of the blocks of
    LEVEL_BLOCK entries before each block; totals [4]: the kept children of
    each branch)."""
    keys, vals = sdict_pack(keys, vals, counts)
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
    blocks = -(-D // LEVEL_BLOCK)
    padded = torch.nn.functional.pad(keep, (0, blocks * LEVEL_BLOCK - D))
    per_block = padded.view(4, blocks, LEVEL_BLOCK).sum(dim=2)
    incl = torch.cumsum(per_block, dim=1)
    out_keys = torch.zeros((4, D), dtype=torch.int64, device=dev)
    out_vals = torch.zeros((4, D, 3), dtype=vals.dtype, device=dev)
    for b in range(4):
        sel = keep[b]
        n_b = int(sel.sum())
        out_keys[b, :n_b] = keys[sel] | (b << (2 * level))
        out_vals[b, :n_b] = torch.stack((ck[b][sel], ckp[b][sel], cs[b][sel]),
                                        dim=1).to(vals.dtype)
    return (out_keys, out_vals, (incl - per_block).to(torch.int32),
            incl[:, -1].to(torch.int32))


def sdict_level(t: RIndexTables, keys: torch.Tensor, vals: torch.Tensor,
                counts, thresh: int, level: int):
    """(keys, vals, offsets, totals) of the next level as sdict_level_plain;
    on the card one launch of the level kernel, which writes a region only
    as far as its total, the plain version on the CPU. keys [R, cap] int64
    and vals [R, cap, 3] (the tables' position dtype) hold the level's
    entries, the first counts[r] of region r (R = 1 for the root, 4 after a
    level); D = sum(counts) must be at least 1."""
    R = keys.shape[0] if keys.dim() == 2 else 0
    if not (1 <= R <= 4 and vals.shape == (*keys.shape, 3) and len(counts) == R
            and all(0 <= c <= keys.shape[1] for c in counts) and sum(counts) >= 1):
        raise ValueError("sdict_level: keys must be [R, cap] and vals [R, cap, 3] "
                         "with R <= 4 and counts[r] <= cap entries in region r, "
                         "at least one in all")
    if not 0 <= level < MAX_S:
        raise ValueError(f"sdict_level: level must be in [0, {MAX_S})")
    if keys.device.type == "cpu":
        return sdict_level_plain(t, keys, vals, counts, thresh, level)
    check_kernel_tables(t)
    dev = t.device
    pd = t.pos_dtype
    D = int(sum(counts))
    blocks = -(-D // LEVEL_BLOCK)
    kind, rargs = rank_args(t)
    out_keys = torch.empty((4, D), dtype=torch.int64, device=dev)
    out_vals = torch.empty((4, D, 3), dtype=pd, device=dev)
    offsets = torch.empty((4, blocks), dtype=torch.int32, device=dev)
    totals = torch.empty(4, dtype=torch.int32, device=dev)
    state = torch.empty(4 * blocks + 1, dtype=torch.int64, device=dev)
    _build.launch(f"pgt_sdict_level_{kind}", *rargs,
                  _build.check("C", t.C, pd, dev),
                  _build.check("keys", keys, torch.int64, dev),
                  _build.check("vals", vals, pd, dev), R, keys.shape[1],
                  *(list(counts) + [0] * (4 - R)), int(thresh), level, blocks,
                  state.data_ptr(), out_keys.data_ptr(), out_vals.data_ptr(),
                  offsets.data_ptr(), totals.data_ptr(), _build.stream(dev))
    sdict_level.launches += 1
    return out_keys, out_vals, offsets, totals


sdict_level.launches = 0


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
    one sdict_level into four regions of D rows each (the children of a
    branch, at most one an entry), then one read of the four totals; the
    next level reads the regions as they are, and the last is packed once
    (sdict_pack). A failed launch raises; a level whose tensors would not
    fit raises MemoryError with the sizes (max_bytes: a budget for the
    build's own tensors; default mertable.device_budget, what the device
    has free when the build starts, and none on the CPU)."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s must be in [1, {MAX_S}]")
    n = int(getattr(idx_or_n, "n", idx_or_n))
    if n != tables.n:
        raise ValueError(f"tables of an index of {tables.n} rows, not {n}")
    dev = tables.device
    if max_bytes is None:
        max_bytes = device_budget(dev)
    keys = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    vals = torch.tensor([[[0, 0, n]]], dtype=tables.pos_dtype, device=dev)
    counts = [1]
    thresh = max(int(min_keep), 1)
    item = vals.element_size()
    for level in range(s):
        D = sum(counts)
        if D == 0:  # nothing occurs at this length: the dictionary is empty
            break
        live = keys.numel() * 8 + vals.numel() * item
        need = 4 * D * (8 + 3 * item) + 8 * (4 * -(-D // LEVEL_BLOCK) + 1)
        _check_budget(live, need, max_bytes,
                      f"level {level + 1}, the children of {D} entries,")
        keys, vals, _, totals = sdict_level(tables, keys, vals, counts, thresh,
                                            level)
        counts = totals.tolist()  # the one read of a level
    _check_budget(keys.numel() * 8 + vals.numel() * item,
                  sum(counts) * (8 + 3 * item), max_bytes,
                  f"the packed dictionary of {sum(counts)} entries")
    return sdict_pack(keys, vals, counts)


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
    build (DeferredTables are built only for the build). There is no
    fallback: with tables a failed build raises."""
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
        keys_d, vals = build_sparse_dict_device(idx, resolve_tables(tables), s, min_keep)
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


def sdict_vals_to_device(vals, device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """vals [D, 3] as a numpy array or a tensor -> a tensor of `dtype` (the
    rank tables' position dtype, which the seed pass takes) on `device`.
    An empty dictionary gives one all-zero row, which no window points at.
    Values that do not fit `dtype` are refused."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.ascontiguousarray(vals))
    if vals.shape[0] == 0:
        vals = torch.zeros((1, 3), dtype=dtype)
    if vals.dtype != dtype and vals.numel() and \
            int(vals.max()) > torch.iinfo(dtype).max:
        raise ValueError(f"dictionary values past {dtype}")
    return vals.to(device, dtype)


def sdict_to_device(vals, dict_rows: np.ndarray, device,
                    dtype: torch.dtype = torch.int32):
    """(vals [D, 3] as a numpy array or a tensor, dict_rows [B, L+1] with -1
    for absent windows) -> tensors on `device`: vals in `dtype`
    (sdict_vals_to_device), the rows int32."""
    return (sdict_vals_to_device(vals, device, dtype),
            torch.from_numpy(np.ascontiguousarray(dict_rows, np.int32)).to(device))
