"""Alphabet of the pangenome index.

The port's copy of pangenome_index_tpu/utils/alphabet.py (same names and
values). The alphabet order is fixed to {'\\n','A','C','G','N','T'}: the
dense symbol codes follow byte order, and FMD symmetry (backward/forward
extension) depends on code(complement(a)) being consistent with it. The full
six-code space is always used.

Code space: 0='\\n' (endmarker), 1='A', 2='C', 3='G', 4='N', 5='T'. Bytes
outside the alphabet map to code 0, so LF/extension with them gives the
empty interval.
"""

from __future__ import annotations

import numpy as np

NENDMARKER = ord("\n")

#: alphabet in code order (byte values)
NUC = np.array([NENDMARKER, ord("A"), ord("C"), ord("G"), ord("N"), ord("T")],
               dtype=np.uint8)

SIGMA = 6

#: byte value -> dense code (0..5); unknown bytes -> 0
BYTE_TO_CODE = np.zeros(256, dtype=np.int8)
for _code, _b in enumerate(NUC):
    BYTE_TO_CODE[_b] = _code

#: dense code -> byte value
CODE_TO_BYTE = NUC.copy()

#: complement in code space: '\n'<->'\n', A<->T, C<->G, N<->N
COMP_CODE = np.array([0, 5, 3, 2, 4, 1], dtype=np.int8)

#: KP_WEIGHT[c, d] = 1 iff comp(d) < comp(c) in code order: the FMD backward
#: extension advances the reverse-interval start by
#: sum_d KP_WEIGHT[c, d] * (occ(d, k+s) - occ(d, k))
KP_WEIGHT = (COMP_CODE[None, :] < COMP_CODE[:, None]).astype(np.int32)

#: ACGT bases in 2-bit key order (A=0, C=1, G=2, T=3) -> alphabet codes
BASE_CODES = np.array([1, 2, 3, 5], dtype=np.int64)
#: alphabet code -> 2-bit base (or -1)
CODE_TO_BASE = np.full(8, -1, dtype=np.int64)
for _b, _c in enumerate(BASE_CODES):
    CODE_TO_BASE[_c] = _b


def encode_bytes(data) -> np.ndarray:
    """Map bytes / uint8 array to dense codes (int8)."""
    arr = (np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray))
           else np.asarray(data, dtype=np.uint8))
    return BYTE_TO_CODE[arr]


def decode_codes(codes) -> bytes:
    """Map dense codes back to bytes."""
    return CODE_TO_BYTE[np.asarray(codes)].tobytes()
