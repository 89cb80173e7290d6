"""Minimal SDSL-lite structure codecs (read + write).

The port's copy of pangenome_index_tpu/formats/sdsl.py, cut to what the .ri
and .tags codecs call; the on-disk layouts are byte-identical:

* int_vector<t_width>: [u64 size_in_bits][u8 width iff t_width==0]
  [ceil(size/64) x u64 data words, LSB-first bit packing]
* bit_vector = int_vector<1> (no width byte)
* sd_vector<>: [u64 size][u8 wl][int_vector<0> low][bit_vector high]
  [select_mcl<1> on high][select_mcl<0> on high]
* select_support_mcl<b>: [u64 arg_cnt] then, if arg_cnt>0:
  [int_vector<0> superblock][bit_vector mini_or_long]
  [per superblock: int_vector<0> miniblock or longsuperblock]
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from .. import native

# ---------------------------------------------------------------- bit packing

#: bit-field (un)packing goes through the native single-pass functions
#: (src/cpp/bitio.cpp) from this element count on; below it the ctypes call
#: costs more than the numpy temporaries
_NATIVE_MIN = 4096


def _words_to_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    """uint64 LE words -> bit array (LSB-first within each word)."""
    byts = words.astype("<u8").view(np.uint8)
    bits = np.unpackbits(byts, bitorder="little")
    return bits[:nbits]


def _bits_to_words(bits: np.ndarray) -> np.ndarray:
    nbits = bits.size
    nwords = (nbits + 63) // 64
    padded = np.zeros(nwords * 64, dtype=np.uint8)
    padded[:nbits] = bits
    return np.packbits(padded, bitorder="little").view("<u8")


def _words_to_values(words: np.ndarray, width: int, count: int) -> np.ndarray:
    """Extract `count` LSB-first `width`-bit values straight from the packed
    uint64 words, with no per-bit materialization."""
    if count == 0 or width == 0:
        return np.zeros(count, dtype=np.int64)
    if count >= _NATIVE_MIN:
        return native.unpack_bits_native(words, width, count)
    w = np.concatenate([words.astype("<u8"), np.zeros(1, "<u8")])
    bitpos = np.arange(count, dtype=np.uint64) * np.uint64(width)
    lo = (bitpos >> np.uint64(6)).astype(np.int64)
    off = bitpos & np.uint64(63)
    val = w[lo] >> off
    hi_shift = (np.uint64(64) - off) & np.uint64(63)  # 0 iff off == 0
    val |= np.where(off == 0, np.uint64(0), w[lo + 1] << hi_shift)
    if width < 64:
        val &= (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    return val.astype(np.int64)


def _values_to_words(values: np.ndarray, width: int) -> np.ndarray:
    """Pack LSB-first `width`-bit values into uint64 words (inverse of
    `_words_to_values`; each value straddles at most two words)."""
    n = len(values)
    nwords = (n * width + 63) // 64
    if n == 0 or width == 0:
        return np.zeros(nwords, dtype="<u8")
    if n >= _NATIVE_MIN:
        return native.pack_bits_native(np.asarray(values), width)
    v = np.asarray(values).astype(np.uint64)
    if width < 64:
        v &= (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    lo = (bitpos >> np.uint64(6)).astype(np.int64)
    off = bitpos & np.uint64(63)
    words = np.zeros(nwords + 1, dtype=np.uint64)
    np.bitwise_or.at(words, lo, v << off)
    hi_shift = (np.uint64(64) - off) & np.uint64(63)
    spill = np.where(off == 0, np.uint64(0), v >> hi_shift)
    np.bitwise_or.at(words, lo + 1, spill)
    return words[:nwords].astype("<u8")


def bits_length(x: int) -> int:
    """sdsl::bits::length(x): number of bits to represent x (>=1)."""
    return max(1, int(x).bit_length())


def bits_hi(x: int) -> int:
    """sdsl::bits::hi(x): index of highest set bit; hi(0) == 0."""
    return int(x).bit_length() - 1 if x > 0 else 0


# ---------------------------------------------------------------- int_vector

def read_u64(buf: io.BufferedIOBase) -> int:
    return int.from_bytes(buf.read(8), "little")


def write_u64(buf, x: int) -> None:
    buf.write(int(x).to_bytes(8, "little"))


def read_int_vector(buf, fixed_width: int | None = None) -> tuple[np.ndarray, int]:
    """Read an int_vector; returns (values, width)."""
    nbits = read_u64(buf)
    if fixed_width is None:
        width = buf.read(1)[0]
    else:
        width = fixed_width
    nwords = (nbits + 63) // 64
    words = np.frombuffer(buf.read(nwords * 8), dtype="<u8")
    count = nbits // width if width else 0
    return _words_to_values(words, width, count), width


def write_int_vector(buf, values, width: int, fixed_width: int | None = None) -> None:
    values = np.asarray(values)
    nbits = len(values) * width
    write_u64(buf, nbits)
    if fixed_width is None:
        buf.write(bytes([width]))
    buf.write(_values_to_words(values, width).tobytes())


def read_bit_vector(buf) -> np.ndarray:
    nbits = read_u64(buf)
    nwords = (nbits + 63) // 64
    words = np.frombuffer(buf.read(nwords * 8), dtype="<u8")
    return _words_to_bits(words, nbits)


def write_bit_vector(buf, bits: np.ndarray) -> None:
    bits = np.asarray(bits, dtype=np.uint8)
    write_u64(buf, bits.size)
    buf.write(_bits_to_words(bits).tobytes())


# ------------------------------------------------------- select_support_mcl

SUPER_BLOCK_SIZE = 4096


@dataclass
class SelectMcl:
    """A select_support_mcl payload, as it is serialized."""

    arg_cnt: int
    superblock: np.ndarray
    superblock_width: int
    mini_or_long: np.ndarray  # bit per superblock (may be empty)
    blocks: list[tuple[np.ndarray, int]]  # (values, width) per superblock


def read_select_mcl(buf) -> SelectMcl:
    arg_cnt = read_u64(buf)
    if arg_cnt == 0:
        return SelectMcl(0, np.zeros(0, np.int64), 1, np.zeros(0, np.uint8), [])
    sb = (arg_cnt + SUPER_BLOCK_SIZE - 1) // SUPER_BLOCK_SIZE
    superblock, sb_width = read_int_vector(buf)
    mini_or_long = read_bit_vector(buf)
    blocks = [read_int_vector(buf) for _ in range(sb)]
    return SelectMcl(arg_cnt, superblock, sb_width, mini_or_long, blocks)


def skip_select_mcl(buf) -> None:
    """Advance past a serialized select_support_mcl without decoding it (the
    structures are recomputable)."""
    arg_cnt = read_u64(buf)
    if arg_cnt == 0:
        return
    sb = (arg_cnt + SUPER_BLOCK_SIZE - 1) // SUPER_BLOCK_SIZE

    def skip_iv(width_byte: bool):
        nbits = read_u64(buf)
        if width_byte:
            buf.read(1)
        buf.seek(((nbits + 63) // 64) * 8, 1)

    skip_iv(True)          # superblock int_vector<0>
    skip_iv(False)         # mini_or_long bit_vector
    for _ in range(sb):
        skip_iv(True)      # per-superblock miniblock / longsuperblock


def write_select_mcl(buf, s: SelectMcl) -> None:
    write_u64(buf, s.arg_cnt)
    if s.arg_cnt == 0:
        return
    write_int_vector(buf, s.superblock, s.superblock_width)
    write_bit_vector(buf, s.mini_or_long)
    for vals, width in s.blocks:
        write_int_vector(buf, vals, width)


def build_select_mcl(high_bits: np.ndarray, pattern: int) -> SelectMcl:
    """Construct select_support_mcl<pattern> over `high_bits`, as sdsl-lite
    does: superblock = position of every 4096th argument; per superblock
    either a miniblock (position of every 64th argument, relative to the
    superblock start) or, when the block spans more than log^4(n) bits, a
    longsuperblock with all 4096 absolute positions. Partial trailing
    miniblock entries stay zero."""
    v_size = int(high_bits.size)
    positions = np.flatnonzero(high_bits == pattern).astype(np.int64)
    arg_cnt = int(positions.size)
    if arg_cnt == 0:
        return SelectMcl(0, np.zeros(0, np.int64), 1, np.zeros(0, np.uint8), [])
    sb = (arg_cnt + SUPER_BLOCK_SIZE - 1) // SUPER_BLOCK_SIZE
    capacity = ((v_size + 63) // 64) * 64
    logn = bits_hi(capacity)
    logn4 = (logn * logn) * (logn * logn)
    sb_width = bits_hi(v_size) + 1
    superblock = positions[::SUPER_BLOCK_SIZE].copy()

    blocks: list[tuple[np.ndarray, int]] = []
    is_long = np.zeros(sb, dtype=np.uint8)
    for i in range(sb):
        block_pos = positions[i * SUPER_BLOCK_SIZE : (i + 1) * SUPER_BLOCK_SIZE]
        first = int(block_pos[0])
        last = int(block_pos[-1])
        if last - first > logn4:
            is_long[i] = 1
            vals = np.zeros(SUPER_BLOCK_SIZE, dtype=np.int64)
            vals[: block_pos.size] = block_pos
            width = bits_hi(last) + 1
            blocks.append((vals, width))
        else:
            width = bits_hi(last - first) + 1
            mini = np.zeros(SUPER_BLOCK_SIZE // 64, dtype=np.int64)
            sampled = block_pos[::64] - first
            mini[: sampled.size] = sampled  # trailing entries stay zero
            blocks.append((mini, width))
    mini_or_long = is_long if is_long.any() else np.zeros(0, dtype=np.uint8)
    return SelectMcl(arg_cnt, superblock, sb_width, mini_or_long, blocks)


# ------------------------------------------------------------------ sd_vector

@dataclass
class SdVector:
    """Elias-Fano sparse bit vector (positions of ones over [0, size))."""

    size: int
    positions: np.ndarray  # int64, strictly increasing
    wl: int | None = None  # low-bits width; sdsl's construction rule if None

    @property
    def num_ones(self) -> int:
        return len(self.positions)

    def _wl(self) -> int:
        """Low-bits width, by the rule sdsl constructs an sd_vector with."""
        if self.wl is not None:
            return self.wl
        logm = bits_hi(self.num_ones) + 1
        logn = bits_hi(self.size) + 1
        if logm == logn:
            logm -= 1
        return logn - logm

    def high_bits(self) -> np.ndarray:
        wl = self._wl()
        m = self.num_ones
        high_size = m + (max(self.size - 1, 0) >> wl) + 1
        bits = np.zeros(high_size, dtype=np.uint8)
        if m:
            hi = (self.positions >> wl) + np.arange(m, dtype=np.int64)
            bits[hi] = 1
        return bits


def read_sd_vector(buf) -> SdVector:
    size = read_u64(buf)
    wl = buf.read(1)[0]
    low, _ = read_int_vector(buf)
    nbits = read_u64(buf)
    nwords = (nbits + 63) // 64
    high_words = np.frombuffer(buf.read(nwords * 8), dtype="<u8")
    skip_select_mcl(buf)  # high_1_select (recomputable)
    skip_select_mcl(buf)  # high_0_select
    m = len(low)
    if m:
        if m >= _NATIVE_MIN:
            # capacity m+1 so an over-populated (corrupt) high bit-vector is
            # detected instead of silently truncated to m ones
            ones_idx = native.set_bits_native(high_words, nbits, m + 1)
        else:
            ones_idx = np.flatnonzero(_words_to_bits(high_words, nbits) == 1)
        if len(ones_idx) != m:
            raise ValueError(
                f"sd_vector: high bit-vector has {len(ones_idx)}"
                f"{'+' if len(ones_idx) > m else ''} ones, expected {m}")
        hi_vals = ones_idx - np.arange(m)
        positions = (hi_vals.astype(np.int64) << wl) | low
    else:
        positions = np.zeros(0, dtype=np.int64)
    return SdVector(size=size, positions=positions, wl=wl)


def write_sd_vector(buf, sd: SdVector) -> None:
    wl = sd._wl()
    write_u64(buf, sd.size)
    buf.write(bytes([wl]))
    mask = (1 << wl) - 1 if wl else 0
    low = (sd.positions & mask) if wl else np.zeros(sd.num_ones, dtype=np.int64)
    write_int_vector(buf, low, wl)
    high = sd.high_bits()
    write_bit_vector(buf, high)
    write_select_mcl(buf, build_select_mcl(high, 1))
    write_select_mcl(buf, build_select_mcl(high, 0))
