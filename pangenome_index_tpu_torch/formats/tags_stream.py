"""Forward-only chunked readers of `.tags` run streams.

The port's copy of pangenome_index_tpu/formats/tags_stream.py, read by the
merge-tags command. The reference merge engine bounds its inputs with per-file 1M-run ring
buffers refilled from disk (FileReader::refill_tags, merge_tags.cpp:221-245).
This module is the array-program analog: `TagRunStream` yields (pos_enc,
lengths) chunks of ~chunk_runs runs with O(chunk) resident memory - all file
regions are consumed through seek+read cursors, never materialized whole.
`PositionCursor` adapts a run stream to the position-granular `take(k)`
interface the merge walk consumes (core/merge.py).

All three on-disk formats are supported (formats/tags.py documents them):
  * algorithm - sequential ByteCode varints: chunked decode with a
    carried partial-varint tail.
  * compressed sdsl - fixed-width int_vector values sliced by index;
    run lengths from the bwt_intervals sd_vector, whose set-bit positions
    are decoded incrementally (low bits sliced, high bits scanned forward
    word-by-word).
  * compressed bytecode (full or compact values) - sequential varints +
    the same incremental sd_vector lengths.
"""

from __future__ import annotations

import io
import os

import numpy as np

from . import bytecode, sdsl
from .tags import decode_full


def _read_at(fh, off: int, n: int) -> bytes:
    fh.seek(off)
    return fh.read(n)


class _IntVectorSlice:
    """Random-access value slices of an on-disk int_vector (no full load)."""

    def __init__(self, fh, off: int, fixed_width: int | None = None):
        self.fh = fh
        head = _read_at(fh, off, 9)
        self.nbits = int.from_bytes(head[:8], "little")
        if fixed_width is None:
            self.width = head[8]
            self.data_off = off + 9
        else:
            self.width = fixed_width
            self.data_off = off + 8
        self.nwords = (self.nbits + 63) // 64
        self.end = self.data_off + self.nwords * 8
        self.count = self.nbits // self.width if self.width else 0

    def read(self, i0: int, i1: int) -> np.ndarray:
        i1 = min(i1, self.count)
        if i1 <= i0:
            return np.zeros(0, np.int64)
        w0 = (i0 * self.width) >> 6
        w1 = min(((i1 * self.width) + 63) >> 6, self.nwords)
        raw = _read_at(self.fh, self.data_off + w0 * 8, (w1 - w0) * 8)
        words = np.frombuffer(raw, dtype="<u8")
        # shift the value index so value i0 starts at bit (i0*w - 64*w0)
        head_bits = i0 * self.width - (w0 << 6)
        head_vals = head_bits // self.width if self.width else 0
        skew = head_bits - head_vals * self.width
        if skew:
            # realign: values are not word-phase-aligned; extract via bitpos
            bitpos = (np.arange(i1 - i0, dtype=np.uint64) * np.uint64(self.width)
                      + np.uint64(head_bits))
            w = np.concatenate([words.astype("<u8"), np.zeros(1, "<u8")])
            lo = (bitpos >> np.uint64(6)).astype(np.int64)
            off = bitpos & np.uint64(63)
            val = w[lo] >> off
            hs = (np.uint64(64) - off) & np.uint64(63)
            val |= np.where(off == 0, np.uint64(0), w[lo + 1] << hs)
            if self.width < 64:
                val &= (np.uint64(1) << np.uint64(self.width)) - np.uint64(1)
            return val.astype(np.int64)
        vals = sdsl._words_to_values(words, self.width,
                                     head_vals + (i1 - i0))
        return vals[head_vals:]


def _skip_int_vector(fh, off: int, fixed_width: int | None = None) -> int:
    head = _read_at(fh, off, 9)
    nbits = int.from_bytes(head[:8], "little")
    nwords = (nbits + 63) // 64
    return off + (8 if fixed_width else 9) + nwords * 8


def _skip_bit_vector(fh, off: int) -> int:
    nbits = int.from_bytes(_read_at(fh, off, 8), "little")
    return off + 8 + ((nbits + 63) // 64) * 8


def _skip_select_mcl(fh, off: int) -> int:
    arg_cnt = int.from_bytes(_read_at(fh, off, 8), "little")
    off += 8
    if arg_cnt == 0:
        return off
    sb = (arg_cnt + sdsl.SUPER_BLOCK_SIZE - 1) // sdsl.SUPER_BLOCK_SIZE
    off = _skip_int_vector(fh, off)
    off = _skip_bit_vector(fh, off)
    for _ in range(sb):
        off = _skip_int_vector(fh, off)
    return off


class _SdPositionStream:
    """Incremental decode of an on-disk sd_vector's set-bit positions.

    low bits are sliced from the low int_vector; high bits are scanned
    forward word-by-word with a persistent cursor (forward-only, like every
    consumer in the merge). O(chunk) resident."""

    def __init__(self, fh, off: int):
        self.fh = fh
        head = _read_at(fh, off, 9)
        self.size = int.from_bytes(head[:8], "little")
        self.wl = head[8]
        self.low = _IntVectorSlice(fh, off + 9)
        self.num_ones = self.low.count if self.wl else None
        high_off = self.low.end
        self.high_bits_n = int.from_bytes(_read_at(fh, high_off, 8), "little")
        self.high_off = high_off + 8
        self.high_words = (self.high_bits_n + 63) // 64
        end = self.high_off + self.high_words * 8
        end = _skip_select_mcl(fh, end)
        self.end = _skip_select_mcl(fh, end)
        if self.wl == 0:
            # degenerate geometry: positions live wholly in the high bits
            self.num_ones = None  # derived by the scan
        self._word_cursor = 0     # next high word to scan
        self._ones_seen = 0
        self._pending: list[np.ndarray] = []  # decoded hi-values not yet taken

    def read(self, k: int) -> np.ndarray:
        """Next k set-bit positions (fewer at end of vector)."""
        have = sum(len(p) for p in self._pending)
        while have < k and self._word_cursor < self.high_words:
            span = min(max((k - have) // 16 + 64, 1024), 1 << 18)
            w0 = self._word_cursor
            w1 = min(w0 + span, self.high_words)
            raw = _read_at(self.fh, self.high_off + w0 * 8, (w1 - w0) * 8)
            bits = np.unpackbits(np.frombuffer(raw, np.uint8),
                                 bitorder="little")
            local = np.flatnonzero(bits)
            # clip bits past the declared bit count (zero-padded words)
            lim = self.high_bits_n - (w0 << 6)
            local = local[local < lim]
            glob = local.astype(np.int64) + (w0 << 6)
            hv = glob - (self._ones_seen + np.arange(len(glob), dtype=np.int64))
            self._pending.append(hv)
            self._ones_seen += len(glob)
            self._word_cursor = w1
            have += len(glob)
        if not have:
            return np.zeros(0, np.int64)
        buf = np.concatenate(self._pending) if len(self._pending) > 1 \
            else self._pending[0]
        take, rest = buf[:k], buf[k:]
        self._pending = [rest] if len(rest) else []
        i0 = self._ones_seen - len(buf)
        low = self.low.read(i0, i0 + len(take)) if self.wl else \
            np.zeros(len(take), np.int64)
        return (take << self.wl) | low


class _VarintStream:
    """Sequential chunked ByteCode varint decode with a carried tail."""

    def __init__(self, fh, off: int, nbytes: int, chunk_bytes: int = 1 << 22):
        self.fh = fh
        self.off = off
        self.end = off + nbytes
        self.chunk_bytes = chunk_bytes
        self.tail = b""

    def read_values(self, max_bytes: int | None = None) -> np.ndarray:
        n = min(max_bytes or self.chunk_bytes, self.end - self.off)
        if n <= 0 and not self.tail:
            return np.zeros(0, np.int64)
        raw = self.tail + _read_at(self.fh, self.off, n)
        self.off += n
        arr = np.frombuffer(raw, np.uint8)
        finals = np.flatnonzero((arr & 0x80) == 0)
        if len(finals) == 0:
            self.tail = raw
            return np.zeros(0, np.int64)
        cut = int(finals[-1]) + 1
        self.tail = raw[cut:]
        return bytecode.decode_stream(raw[:cut])


class TagRunStream:
    """Forward-only run chunks from a `.tags` file: O(chunk) memory."""

    def __init__(self, path, fmt: str = "auto", chunk_runs: int = 1 << 20):
        from .tags import _WRAP_FMTS, WRAP_MAGIC

        self.fh = open(path, "rb")
        self.chunk_runs = chunk_runs
        fsize = os.fstat(self.fh.fileno()).st_size
        base = 0
        head = _read_at(self.fh, 0, 16)
        if head[:8] == WRAP_MAGIC:  # self-describing wrapper: deterministic
            wfmt = _WRAP_FMTS[head[9]]
            if fmt not in ("auto", wfmt):
                raise ValueError(
                    f"wrapped .tags declares {wfmt!r}, caller says {fmt!r}")
            fmt, base = wfmt, 10
            head = _read_at(self.fh, base, 16)
            fsize -= base
        if fmt == "auto":
            fmt = self._sniff(head, fsize)
        self.fmt = fmt
        self._peeked: tuple[np.ndarray, np.ndarray] | None = None
        if fmt == "algorithm":
            nbits = int.from_bytes(_read_at(self.fh, base, 8), "little")
            self._vs = _VarintStream(self.fh, base + 8, nbits // 8)
            self._iv = None
            self._sd = None
        elif fmt == "sdsl":
            self._iv = _IntVectorSlice(self.fh, base)
            off = _skip_select_struct_sd(self.fh, self._iv.end)
            self._sd = _SdPositionStream(self.fh, off)
            self._vs = None
            self._idx = 0
            self._prev_start = None
        elif fmt in ("bytecode", "bytecode-compact"):
            nbytes = int.from_bytes(_read_at(self.fh, base, 8), "little")
            self._vs = _VarintStream(self.fh, base + 8, nbytes)
            off = _skip_select_struct_sd(self.fh, base + 8 + nbytes)
            self._sd = _SdPositionStream(self.fh, off)
            self._iv = None
            self._prev_start = None
        else:
            raise ValueError(f"unknown tags format {fmt!r}")

    @staticmethod
    def _sniff(head: bytes, fsize: int) -> str:
        if len(head) >= 8:
            nbits = int.from_bytes(head[:8], "little")
            if nbits % 8 == 0 and 8 + ((nbits // 8 + 7) // 8) * 8 == fsize:
                return "algorithm"
        if len(head) >= 9:
            nbits = int.from_bytes(head[:8], "little")
            width = head[8]
            nwords = (nbits + 63) // 64
            if width and nbits % width == 0 and 9 + nwords * 8 < fsize:
                return "sdsl"
        return "bytecode"

    def read_runs(self) -> tuple[np.ndarray, np.ndarray]:
        """Next chunk of (pos_enc, lengths); empty arrays at end of stream."""
        if self._peeked is not None:
            out, self._peeked = self._peeked, None
            return out
        k = self.chunk_runs
        if self.fmt == "algorithm":
            values = self._vs.read_values(max_bytes=k * 5)
            return decode_full(values)
        if self.fmt == "sdsl":
            vals = self._iv.read(self._idx, self._idx + k)
            self._idx += len(vals)
            lens = self._next_lengths(len(vals))
            return vals, lens
        values = self._vs.read_values(max_bytes=k * 5)
        lens = self._next_lengths(len(values))
        if self.fmt == "bytecode":
            pos, _ = decode_full(values)
            return pos, lens
        return values, lens

    def _next_lengths(self, k: int) -> np.ndarray:
        """Lengths of the next k runs from the interval-start sd_vector
        (length i = start[i+1] - start[i]; the final run closes at size-1,
        tag_arrays.cpp bwt_intervals geometry)."""
        if k == 0:
            return np.zeros(0, np.int64)
        if self._prev_start is None:
            starts = self._sd.read(k)
        else:
            starts = np.concatenate(([self._prev_start],
                                     self._sd.read(k - 1)))
        if len(starts) != k:
            raise ValueError("tags: fewer interval starts than run values")
        # one lookahead start closes the last run of this chunk
        nxt = self._sd.read(1)
        if len(nxt):
            self._prev_start = int(nxt[0])
            ends = np.concatenate((starts[1:], nxt))
        else:
            self._prev_start = None
            ends = np.concatenate((starts[1:], [self._sd.size - 1]))
        return (ends - starts).astype(np.int64)

    def peek_first_pos(self) -> int:
        if self._peeked is None:
            self._peeked = self.read_runs()
        if len(self._peeked[0]) == 0:
            raise ValueError("empty tag stream")
        return int(self._peeked[0][0])

    def close(self):
        self.fh.close()


def _skip_select_struct_sd(fh, off: int) -> int:
    """Skip one whole sd_vector (the every-10th-run samples sidecar that
    precedes bwt_intervals in both compressed formats)."""
    off2 = off + 9  # size u64 + wl byte
    off2 = _skip_int_vector(fh, off2)       # low
    off2 = _skip_bit_vector(fh, off2)       # high
    off2 = _skip_select_mcl(fh, off2)
    return _skip_select_mcl(fh, off2)


class PositionCursor:
    """Position-granular forward consumer over a TagRunStream: `take(k)`
    returns the next k per-position tags, pulling run chunks on demand and
    carrying a partially consumed run. The file-backed replacement for
    core/merge._StreamCursor, whose inputs are fully resident."""

    def __init__(self, stream: TagRunStream):
        self.stream = stream
        self.vals = np.zeros(0, np.int64)
        self.lens = np.zeros(0, np.int64)
        self.exhausted = False

    def _pull(self):
        v, l = self.stream.read_runs()
        if len(v) == 0:
            self.exhausted = True
            return
        self.vals = np.concatenate((self.vals, v))
        self.lens = np.concatenate((self.lens, l))

    @property
    def remaining(self) -> int:
        """Unconsumed positions (pulls one chunk if exhaustion is unknown)."""
        if not self.exhausted and self.lens.sum() == 0:
            self._pull()
        if self.exhausted:
            return int(self.lens.sum())
        return 1  # at least one buffered/unread chunk remains

    def take(self, k: int) -> np.ndarray:
        k = int(k)
        while self.lens.sum() < k and not self.exhausted:
            self._pull()
        cum = np.concatenate(([0], np.cumsum(self.lens)))
        if cum[-1] < k:
            raise ValueError(
                f"tag stream exhausted: need {k} positions, have {int(cum[-1])}")
        i1 = int(np.searchsorted(cum, k, side="left"))
        reps = np.minimum(cum[1 : i1 + 1], k) - cum[:i1]
        out = np.repeat(self.vals[:i1], reps)
        # carry the partially consumed run
        used_last = k - int(cum[i1 - 1]) if i1 else 0
        if i1 and used_last < self.lens[i1 - 1]:
            self.vals = self.vals[i1 - 1 :]
            self.lens = np.concatenate(
                ([self.lens[i1 - 1] - used_last], self.lens[i1:]))
        else:
            self.vals = self.vals[i1:]
            self.lens = self.lens[i1:]
        return out
