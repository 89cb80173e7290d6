"""Reader and writer of grlBWT's ``.rl_bwt`` run-length BWT container.

The port's copy of pangenome_index_tpu/formats/rlbwt.py, cut to what the
port calls: the RLBWT record, run-length encoding of a BWT byte string
(utils/synth.py, build-bwt), and the file's reader (build-rindex) and writer
(build-bwt), byte-equal to the JAX package's. The container:

    [u64 sym_bytes][u64 freq_bytes]                      # little-endian header
    then N records of (sym_bytes + freq_bytes) bytes:
    [sym: sym_bytes LE][freq: freq_bytes LE]

The writer sizes the symbol field for the largest symbol byte and the
frequency field for the total text length (a 45-byte text gives (1, 1), a
3012-byte one (1, 2)), as grlBWT does.
"""

from __future__ import annotations

import os
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


def _le_records(raw: np.ndarray, width: int) -> np.ndarray:
    """Decode little-endian fixed-width integers from a [n, width] byte view."""
    out = np.zeros(raw.shape[0], dtype=np.int64)
    for b in range(width):
        out |= raw[:, b].astype(np.int64) << (8 * b)
    return out


def read_rlbwt(path: str | os.PathLike) -> RLBWT:
    data = np.fromfile(path, dtype=np.uint8)
    if data.size < 16:
        raise ValueError(f"{path}: truncated .rl_bwt (no header)")
    header = data[:16].view(np.uint64)
    sym_bytes, freq_bytes = int(header[0]), int(header[1])
    rec = sym_bytes + freq_bytes
    body = data[16:]
    if body.size % rec != 0:
        raise ValueError(f"{path}: body size {body.size} not a multiple of "
                         f"record size {rec}")
    recs = body.reshape(body.size // rec, rec)
    syms = _le_records(recs[:, :sym_bytes], sym_bytes).astype(np.uint8)
    freqs = _le_records(recs[:, sym_bytes:], freq_bytes)
    return RLBWT(syms=syms, freqs=freqs)


def write_rlbwt(path: str | os.PathLike, rlbwt: RLBWT) -> None:
    """Write the container with grlBWT's field widths: the symbol field
    sized for the largest symbol byte, the frequency field for the total
    text length."""
    sym_bytes = max(1, (int(rlbwt.syms.max(initial=0)).bit_length() + 7) // 8)
    freq_bytes = max(1, (int(rlbwt.size).bit_length() + 7) // 8)
    body = np.zeros((rlbwt.n_runs, sym_bytes + freq_bytes), dtype=np.uint8)
    s = rlbwt.syms.astype(np.int64)
    f = rlbwt.freqs.astype(np.int64)
    for b in range(sym_bytes):
        body[:, b] = (s >> (8 * b)) & 0xFF
    for b in range(freq_bytes):
        body[:, sym_bytes + b] = (f >> (8 * b)) & 0xFF
    with open(path, "wb") as fh:
        fh.write(np.array([sym_bytes, freq_bytes], dtype=np.uint64).tobytes())
        fh.write(body.tobytes())


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
