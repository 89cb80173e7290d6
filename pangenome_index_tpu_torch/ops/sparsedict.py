"""Sparse long-seed dictionary, read side.

The dictionary (bi-intervals of every length-s ACGT substring that occurs in
the index) is built on the host by the JAX package's numpy build function, and each
read window is looked up on the host by the native window pass; both are
imported as they are. The port uploads the dictionary values and the per-read
dictionary row of every window.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import get_sparse_dict, read_windows_fast  # noqa: F401


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
