"""Run-length BWT as parallel arrays.

The port's copy of what utils/synth.py needs of
pangenome_index_tpu/formats/rlbwt.py: the RLBWT record and run-length
encoding of a BWT byte string (the .rl_bwt file reader and writer belong to
the index build, which the port does not carry).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RLBWT:
    """Run-length BWT: parallel arrays of (symbol byte, frequency)."""

    syms: np.ndarray  # uint8 [n_runs] symbol byte values
    freqs: np.ndarray  # int64 [n_runs] run lengths

    @property
    def n_runs(self) -> int:
        return len(self.syms)

    @property
    def size(self) -> int:
        return int(self.freqs.sum())


def rlbwt_from_text(text: bytes) -> RLBWT:
    """Run-length encode a BWT byte string: adjacent equal symbols form one
    run (endmarker runs are not split here; the r-index build splits them)."""
    arr = np.frombuffer(text, dtype=np.uint8)
    if arr.size == 0:
        return RLBWT(np.zeros(0, np.uint8), np.zeros(0, np.int64))
    boundaries = np.flatnonzero(np.diff(arr) != 0) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [arr.size]))
    return RLBWT(syms=arr[starts], freqs=(ends - starts).astype(np.int64))
