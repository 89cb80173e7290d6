"""simple-sds serialization primitives (jltsiren/simple-sds data model).

The port's copy of pangenome_index_tpu/formats/simple_sds.py (the reader).
The GBZ/GBWT/GBWTGraph stack serializes in the simple-sds format:
everything is 8-byte little-endian elements.

  RawVector     [u64 len_bits][u64 n_words][words]
  BitVector     RawVector + 3 Options (rank, select, select0 supports)
  IntVector     [u64 items][u64 width][RawVector]
  SparseVector  [u64 len][u64 ones][BitVector high][IntVector low]
  Vector<T>     [u64 items][data padded to 8 bytes]
  Option        [u64 n_elements][n_elements x u64]
  StringArray   [SparseVector starts][Vector<u8> alphabet][IntVector symbols]
  Dictionary    [StringArray strings][IntVector sorted_ids]
"""

from __future__ import annotations

import struct

import numpy as np


def _unpack_values(w: np.ndarray, bits: int, items: int, width: int) -> np.ndarray:
    """`items` little-endian bit fields of `width` bits from the words `w`."""
    if not items:
        return np.zeros(0, np.int64)
    b = np.unpackbits(w.view(np.uint8), bitorder="little")[:bits]
    idx = np.arange(items)[:, None] * width + np.arange(width)[None, :]
    return ((b[idx].astype(np.uint64) << np.arange(width, dtype=np.uint64)).sum(1)
            ).astype(np.int64)


class Reader:
    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.o = offset

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.o)[0]
        self.o += 8
        return v

    def words(self, n: int) -> np.ndarray:
        w = np.frombuffer(self.data, "<u8", n, self.o)
        self.o += 8 * n
        return w

    def bytes_padded(self, n: int) -> bytes:
        b = self.data[self.o : self.o + n]
        self.o += ((n + 7) // 8) * 8
        return b

    # ---- composite structures ----
    def raw_vector(self):
        bits = self.u64()
        n_words = self.u64()
        return bits, self.words(n_words)

    def skip_options(self, n: int = 1) -> None:
        for _ in range(n):
            k = self.u64()
            self.o += 8 * k

    def option_raw(self) -> bytes:
        k = self.u64()
        b = self.data[self.o : self.o + 8 * k]
        self.o += 8 * k
        return b

    def bit_vector(self) -> np.ndarray:
        bits, w = self.raw_vector()
        self.skip_options(3)
        return np.unpackbits(w.view(np.uint8), bitorder="little")[:bits]

    def int_vector(self) -> np.ndarray:
        items = self.u64()
        width = self.u64()
        bits, w = self.raw_vector()
        return _unpack_values(w, bits, items, width)

    def sparse_vector(self):
        """Returns (universe_len, positions of ones)."""
        ln = self.u64()
        ones = self.u64()
        high = self.bit_vector()
        items = self.u64()
        width = self.u64()
        bits, w = self.raw_vector()
        low = _unpack_values(w, bits, items, width)
        hp = np.flatnonzero(high).astype(np.int64)
        pos = ((hp - np.arange(len(hp))) << width) | low
        if len(pos) != ones:
            raise ValueError(f"sparse vector: {len(pos)} ones decoded, {ones} declared")
        return ln, pos

    def byte_vector(self) -> bytes:
        n = self.u64()
        return self.bytes_padded(n)

    def string_array(self) -> list[bytes]:
        _, starts = self.sparse_vector()
        alphabet = np.frombuffer(self.byte_vector(), np.uint8)
        syms = self.int_vector()
        text = alphabet[syms] if len(syms) else np.zeros(0, np.uint8)
        bounds = np.concatenate((starts, [len(text)])).astype(np.int64)
        return [text[bounds[i] : bounds[i + 1]].tobytes() for i in range(len(bounds) - 1)]

    def dictionary(self) -> list[bytes]:
        strings = self.string_array()
        self.int_vector()  # sorted_ids (recomputable)
        return strings
