"""ByteCode varint codec (7-bit groups, 0x80 continuation).

The port's copy of pangenome_index_tpu/formats/bytecode.py. Little-endian
7-bit groups; the final byte of each value has the high bit clear:

    while value > 0x7F: emit (value & 0x7F) | 0x80; value >>= 7
    emit value
"""

from __future__ import annotations

import numpy as np


def write_value(out: bytearray, value: int) -> None:
    value = int(value)
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def write_values(values) -> bytes:
    out = bytearray()
    for v in values:
        write_value(out, v)
    return bytes(out)


def read_value(data, loc: int) -> tuple[int, int]:
    """Read one value at byte offset `loc`; return (value, next_loc)."""
    byte = data[loc]
    loc += 1
    result = byte & 0x7F
    offset = 7
    while byte & 0x80:
        byte = data[loc]
        loc += 1
        result += (byte & 0x7F) << offset
        offset += 7
    return result, loc


def decode_stream(data) -> np.ndarray:
    """Vectorized decode of a whole stream of back-to-back varints."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    if arr.size == 0:
        return np.zeros(0, dtype=np.int64)
    is_final = (arr & 0x80) == 0
    # value id for each byte: number of finals strictly before it
    vid = np.concatenate(([0], np.cumsum(is_final)[:-1]))
    n_values = int(is_final.sum())
    if not is_final[-1]:
        raise ValueError("truncated ByteCode stream")
    # position of byte within its value
    starts = np.concatenate(([0], np.flatnonzero(is_final)[:-1] + 1))
    within = np.arange(arr.size) - starts[vid]
    out = np.zeros(n_values, dtype=np.int64)
    np.add.at(out, vid, (arr & 0x7F) << (7 * within))
    return out
