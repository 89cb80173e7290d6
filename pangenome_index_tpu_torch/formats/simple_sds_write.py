"""simple-sds serialization writers (mirror of simple_sds.Reader).

The port's copy of pangenome_index_tpu/formats/simple_sds_write.py, with the
same bytes: what formats/gbz_write.py writes a GBZ container with, for the
synthetic graphs of the tests and chip_smoke.py.
"""

from __future__ import annotations

import io
import struct

import numpy as np


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def getvalue(self) -> bytes:
        return self.buf.getvalue()

    def u64(self, v: int) -> None:
        self.buf.write(struct.pack("<Q", v))

    def words(self, w: np.ndarray) -> None:
        self.buf.write(np.ascontiguousarray(w, "<u8").tobytes())

    def bytes_padded(self, b: bytes) -> None:
        self.buf.write(b)
        pad = (-len(b)) % 8
        self.buf.write(b"\x00" * pad)

    # ---- composite structures ----
    def raw_vector(self, bits: np.ndarray) -> None:
        bits = np.asarray(bits, np.uint8)
        n_words = (bits.size + 63) // 64
        padded = np.zeros(n_words * 64, np.uint8)
        padded[: bits.size] = bits
        self.u64(bits.size)
        self.u64(n_words)
        self.words(np.packbits(padded, bitorder="little").view("<u8"))

    def bit_vector(self, bits: np.ndarray) -> None:
        self.raw_vector(bits)
        for _ in range(3):  # absent rank/select/select0 supports
            self.u64(0)

    def int_vector(self, values: np.ndarray, width: int) -> None:
        values = np.asarray(values, np.uint64)
        self.u64(values.size)
        self.u64(width)
        if values.size and width:
            shifts = np.arange(width, dtype=np.uint64)
            bits = ((values[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8).reshape(-1)
        else:
            bits = np.zeros(0, np.uint8)
        self.raw_vector(bits)

    def sparse_vector(self, universe: int, positions: np.ndarray) -> None:
        positions = np.asarray(positions, np.int64)
        m = positions.size
        self.u64(universe)
        self.u64(m)
        # low-bits width: same rule simple-sds uses (floor(log2(universe/m)))
        if m == 0:
            width = 0
            high = np.zeros(1, np.uint8)
            low = np.zeros(0, np.int64)
        else:
            width = max(0, int(np.floor(np.log2(max(universe, 1) / m)))) if universe > m else 0
            low = positions & ((1 << width) - 1) if width else np.zeros(m, np.int64)
            hi = (positions >> width) + np.arange(m)
            high_len = m + (universe >> width) + 1  # simple-sds geometry
            high = np.zeros(max(high_len, int(hi[-1]) + 1), np.uint8)
            high[hi] = 1
        self.bit_vector(high)
        self.int_vector(low, width)

    def byte_vector(self, b: bytes) -> None:
        self.u64(len(b))
        self.bytes_padded(b)

    def string_array(self, strings: list[bytes]) -> None:
        lengths = [len(s) for s in strings]
        starts = np.zeros(len(strings), np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        total = int(sum(lengths))
        self.sparse_vector(max(total, 1), starts)
        concat = b"".join(strings)
        text = np.frombuffer(concat, np.uint8)
        alphabet = np.unique(text).tobytes()
        self.byte_vector(alphabet)
        syms = np.searchsorted(np.frombuffer(alphabet, np.uint8), text).astype(np.int64)
        width = max(1, (len(alphabet) - 1).bit_length()) if alphabet else 1
        self.int_vector(syms, width)

    def dictionary(self, strings: list[bytes]) -> None:
        self.string_array(strings)
        order = np.argsort(np.array(strings, dtype=object))
        self.int_vector(np.asarray(order, np.int64),
                        max(1, (max(len(strings) - 1, 0)).bit_length()))

    def option(self, payload: bytes | None) -> None:
        if not payload:
            self.u64(0)
            return
        assert len(payload) % 8 == 0
        self.u64(len(payload) // 8)
        self.buf.write(payload)
