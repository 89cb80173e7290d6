"""Host-side MEM finding (reference semantics, numpy).

The port's copy of pangenome_index_tpu/models/mems.py: the three-step MEM
algorithm of the reference (find_mems_function / find_all_mems):

  step 1: backward-extend P[x .. x+min_len-1]; bail at j+1 on dropout
  step 2: forward-extend to the maximal end e, remembering the last interval
          bint2 that still satisfied min_occ
  step 3: fresh backward extension from P[e] down to x+1 to find the next
          MEM start.

Step 3 begins at index e, which equals len(P) when the MEM reaches the end of
the read; the reference then reads the string's NUL sentinel, whose backward
extension selects the endmarker code (0). A code-0 sentinel reproduces that.

The command line uses it for reads past the top device capacity tier.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.alphabet import BYTE_TO_CODE
from .rindex import RIndex


@dataclass
class MEM:
    start: int       # x
    end: int         # e (exclusive)
    bwt_start: int   # forward interval start of the reported interval
    size: int        # interval size (occurrence count)


def _code_at(codes: np.ndarray, j: int) -> int:
    return int(codes[j]) if j < len(codes) else 0  # NUL sentinel -> code 0


def find_mems_function(idx: RIndex, codes: np.ndarray, min_len: int,
                       min_occ: int, x: int, out: list[MEM]) -> int:
    n = len(codes)
    if n - x < min_len:
        return n

    # step 1
    bint = (0, 0, idx.n)
    j = x + min_len - 1
    while True:
        bint = idx.backward_extend(bint, _code_at(codes, j))
        if bint[2] < min_occ or bint[2] <= 0:
            return j + 1
        if j == x or j == 0:
            break
        j -= 1

    # step 2
    bint2 = bint
    j = x + min_len
    while j < n:
        bint = idx.forward_extend(bint, _code_at(codes, j))
        if bint[2] < min_occ or bint[2] <= 0:
            break
        bint2 = bint
        j += 1

    e = j
    out.append(MEM(start=x, end=e, bwt_start=bint2[0], size=bint2[2]))

    # step 3
    back = (0, 0, idx.n)
    j = e
    while j > x:
        back = idx.backward_extend(back, _code_at(codes, j))
        if back[2] < min_occ or back[2] <= 0:
            return j + 1
        j -= 1
    return j + 1


def find_all_mems(idx: RIndex, pattern: bytes, min_len: int,
                  min_occ: int) -> list[MEM]:
    codes = BYTE_TO_CODE[np.frombuffer(pattern, dtype=np.uint8)].astype(np.int64)
    mems: list[MEM] = []
    x = 0
    n = len(codes)
    while x < n:
        x = find_mems_function(idx, codes, min_len, min_occ, x, mems)
    return mems
