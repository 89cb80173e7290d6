"""Sparse long-seed dictionary: bi-intervals of every length-s ACGT substring
that occurs in the index.

The host side is the port's copy of the numpy parts of
pangenome_index_tpu/ops/sparsedict.py (same values, same npz cache): the
level-synchronous frontier build (level t holds the bi-intervals of every
distinct length-t substring; one batched rank6 pair per level extends all of
them by the four bases), its content-keyed cache, and the per-read window
lookup through the native pass. Keys are plain int64, so s = 31 is exact.
The port uploads the dictionary values and the per-read dictionary row of
every window; the seed-resolving pass of the MEM engine reads them.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import torch

from .. import native
from ..utils.alphabet import BASE_CODES, KP_WEIGHT

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


def sparse_dict_key(idx, s: int, min_keep: int = 1) -> str:
    """Content key of (index, s, min_keep): the dictionary is a pure function
    of these (the scheme of mertable.mer_table_key)."""
    h = hashlib.sha1()
    h.update(np.int64([0x5D1C7, s, min_keep, idx.n, idx.n_runs]).tobytes())
    h.update(np.ascontiguousarray(idx.run_sym).tobytes())
    h.update(np.ascontiguousarray(idx.run_len).tobytes())
    return h.hexdigest()[:16]


def get_sparse_dict(idx, s: int, path=None, min_keep: int = 1):
    """Cached host build: (keys, vals), persisted at `path` keyed by content
    (the JAX package's npz cache file)."""
    key = sparse_dict_key(idx, s, min_keep)
    if path is not None and os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    return z["keys"], z["vals"]
            print(f"sparse dict {path}: stale key, rebuilding", file=sys.stderr)
        except Exception as exc:
            print(f"sparse dict {path}: unreadable ({exc}), rebuilding",
                  file=sys.stderr)
    keys, vals = build_sparse_dict(idx, s, min_keep)
    if path is not None:
        try:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as fh:
                np.savez(fh, keys=keys, vals=vals, key=key)
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


def sdict_to_device(vals: np.ndarray, dict_rows: np.ndarray, device):
    """(vals [D, 3], dict_rows [B, L+1] with -1 for absent windows) -> int32
    tensors on `device`. An empty dictionary uploads one all-zero row, which
    no window points at."""
    if len(vals) == 0:
        vals = np.zeros((1, 3), np.int32)
    if vals.dtype != np.int32:
        raise ValueError("the port's dictionary tier takes int32 values (n < 2^31)")
    return (torch.from_numpy(np.ascontiguousarray(vals)).to(device),
            torch.from_numpy(np.ascontiguousarray(dict_rows, np.int32)).to(device))
