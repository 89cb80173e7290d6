"""``.ri`` r-index file codec: load and write, legacy and encoded.

The port's copy of pangenome_index_tpu/formats/ri.py (with file_sections,
the sizes print-stats reports); the bytes are identical (the legacy writer
is vectorised over blocks).

Common prefix:
  Header{u32 tag=0x6B3741D8, u32 version=1, u64 max_length, u64 flags}
  samples       int_vector<0>  width = bits(pack(n_seq-1, max_len-1))
  last          sd_vector over n_seq*max_len, ones = run tails (packed pos)
  last_to_run   int_vector<0>  width = bits(total_runs-1)
  sym_map       int_vector<8>  256 entries, byte -> dense present-symbol code
  C             int_vector<64> exclusive prefix counts (present symbols only)
  blocks_start_pos  sd_vector over bwt_size, ones = block head BWT offsets
  sequence_size u64

Legacy (flags=0): u64 n_blocks, then per block
  {int_vector<64> cum_ranks, u64 n_runs, per run u64 symbol_byte, u64 length}

Encoded (flags&1): u64 encoded_block_size(=10), u8 has_N,
  blocks_encoded_start_bits int_vector<0> (byte offset of each block),
  u64 stream_size, raw stream. Per block: C.size() ByteCode varint cum ranks
  (sym_map order) then runs as [u8 (code<<5)|min(len-1,31)] with lengths >=32
  spilled to ByteCode(len-32).

Blocks group 10 logical runs (endmarker occurrences are separate runs). If
total_runs is a multiple of 10 the reference serializes one trailing empty
block whose cum-rank vector is the default 8-entry zero vector.
"""

from __future__ import annotations

import io
import mmap

import numpy as np

from ..models.rindex import RIndex
from ..utils.alphabet import BYTE_TO_CODE, CODE_TO_BYTE, SIGMA
from . import bytecode, sdsl

TAG = 0x6B3741D8
VERSION = 1
FLAG_ENCODED = 0x1
BLOCK_SIZE = 10


def _present_codes(idx: RIndex) -> np.ndarray:
    totals = np.diff(idx.C)
    return np.flatnonzero(totals > 0)


def _write_common(buf, idx: RIndex, flags: int) -> None:
    r = idx.n_runs
    buf.write(TAG.to_bytes(4, "little"))
    buf.write(VERSION.to_bytes(4, "little"))
    buf.write(int(idx.max_len).to_bytes(8, "little"))
    buf.write(int(flags).to_bytes(8, "little"))
    samples_width = sdsl.bits_length(idx.n_seq * idx.max_len - 1)
    sdsl.write_int_vector(buf, idx.samples, samples_width)
    sdsl.write_sd_vector(buf, sdsl.SdVector(size=idx.n_seq * idx.max_len,
                                            positions=idx.last_sorted))
    sdsl.write_int_vector(buf, idx.last_to_run, sdsl.bits_length(r - 1))
    # sym_map: dense codes over *present* symbols in byte order
    present = _present_codes(idx)
    sym_map = np.zeros(256, dtype=np.int64)
    for dense, code in enumerate(present):
        sym_map[CODE_TO_BYTE[code]] = dense
    sdsl.write_int_vector(buf, sym_map, 8, fixed_width=8)
    C_present = idx.C[present]  # exclusive prefix over present symbols
    sdsl.write_int_vector(buf, C_present, 64, fixed_width=64)
    block_heads = idx.run_start[::BLOCK_SIZE]
    sdsl.write_sd_vector(buf, sdsl.SdVector(size=idx.n, positions=block_heads))
    sdsl.write_u64(buf, idx.n)


def serialize_encoded(idx: RIndex) -> bytes:
    buf = io.BytesIO()
    _write_common(buf, idx, FLAG_ENCODED)
    sdsl.write_u64(buf, BLOCK_SIZE)
    has_n = bool((np.diff(idx.C))[4] > 0)
    buf.write(bytes([1 if has_n else 0]))

    present = _present_codes(idx)
    r = idx.n_runs
    n_ser_blocks = r // BLOCK_SIZE + 1  # note: trailing empty block if r%10==0
    stream = bytearray()
    offsets = []
    for b in range(n_ser_blocks):
        offsets.append(len(stream))
        lo = b * BLOCK_SIZE
        hi = min(lo + BLOCK_SIZE, r)
        if lo >= r:
            # trailing empty block: default 8-entry zero cum vector
            for _ in range(8):
                bytecode.write_value(stream, 0)
            continue
        for code in present:
            bytecode.write_value(stream, int(idx.cum[lo, code]))
        for j in range(lo, hi):
            code = int(idx.run_sym[j])
            length = int(idx.run_len[j])
            prefix = min(length - 1, 31)
            stream.append(((code & 0x7) << 5) | (prefix & 0x1F))
            if prefix == 31:
                bytecode.write_value(stream, length - 32)
    start_width = sdsl.bits_length(offsets[-1] if offsets else 0)
    sdsl.write_int_vector(buf, np.array(offsets, dtype=np.int64), start_width)
    sdsl.write_u64(buf, len(stream))
    buf.write(bytes(stream))
    return buf.getvalue()


def serialize_legacy(idx: RIndex) -> bytes:
    """The legacy format: every block as little-endian words, written for
    all full blocks at once, then the last block (partial, or the trailing
    empty one when the runs fill their blocks)."""
    buf = io.BytesIO()
    _write_common(buf, idx, 0)
    present = _present_codes(idx)
    ncp = len(present)
    r = idx.n_runs
    sdsl.write_u64(buf, r // BLOCK_SIZE + 1)
    # per run its symbol byte and length, interleaved
    runs = np.stack((CODE_TO_BYTE[idx.run_sym].astype(np.uint64),
                     idx.run_len.astype(np.uint64)), axis=1).reshape(-1)
    full = r // BLOCK_SIZE
    if full:
        # a full block: int_vector<64> of its cum ranks (bit count, words),
        # its run count, its runs
        blocks = np.empty((full, 2 + ncp + 2 * BLOCK_SIZE), np.uint64)
        blocks[:, 0] = ncp * 64
        blocks[:, 1 : 1 + ncp] = idx.cum[::BLOCK_SIZE][:full][:, present]
        blocks[:, 1 + ncp] = BLOCK_SIZE
        blocks[:, 2 + ncp :] = runs[: 2 * full * BLOCK_SIZE].reshape(full, -1)
        buf.write(blocks.astype("<u8").tobytes())
    lo = full * BLOCK_SIZE
    if lo < r:
        last = [ncp * 64, *idx.cum[lo, present], r - lo, *runs[2 * lo :]]
    else:  # the default 8-entry zero cum vector and no runs
        last = [8 * 64] + [0] * 8 + [0]
    buf.write(np.array(last, dtype="<u8").tobytes())
    return buf.getvalue()


def _finish_from_runs(run_sym, run_len, samples, last_positions, last_to_run,
                      n, n_seq, max_len) -> RIndex:
    run_sym = np.asarray(run_sym, dtype=np.int8)
    run_len = np.asarray(run_len, dtype=np.int64)
    r = run_sym.size
    run_start = np.zeros(r, dtype=np.int64)
    np.cumsum(run_len[:-1], out=run_start[1:])
    totals = np.zeros(SIGMA, dtype=np.int64)
    np.add.at(totals, run_sym.astype(np.int64), run_len)
    C = np.zeros(SIGMA + 1, dtype=np.int64)
    np.cumsum(totals, out=C[1:])
    cum = np.zeros((r, SIGMA), dtype=np.int64)
    contrib = np.zeros((r, SIGMA), dtype=np.int64)
    contrib[np.arange(r), run_sym.astype(np.int64)] = run_len
    np.cumsum(contrib[:-1], axis=0, out=cum[1:])
    return RIndex(
        run_sym=run_sym, run_start=run_start, run_len=run_len, cum=cum, C=C,
        n=n, n_seq=n_seq, max_len=max_len,
        samples=np.asarray(samples, dtype=np.int64),
        last_sorted=np.asarray(last_positions, dtype=np.int64),
        last_to_run=np.asarray(last_to_run, dtype=np.int64),
    )


def _decode_encoded_runs(stream: bytes, start_bits: np.ndarray,
                         enc_block_size: int, ncp: int,
                         r_total: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized decode of the encoded block stream -> (run_sym, run_len).

    Lockstep over all blocks (numpy, no per-run Python loop): the ncp
    cumulative-rank varints at each block head are back-to-back, so skipping
    all of them is one lookup into the stream's final-byte index (the ncp-th
    varint ends at the (rank+ncp-1)-th byte with the 0x80 continuation bit
    clear); then `enc_block_size` lockstep header reads with a subset
    sub-loop for the rare >=32-length varint spills."""
    sb = np.frombuffer(stream, dtype=np.uint8)
    n_blocks_total = len(start_bits)
    nb = min(n_blocks_total, (r_total + enc_block_size - 1) // enc_block_size)
    if nb == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.int64)
    starts = np.asarray(start_bits[:nb], dtype=np.int64)
    ends = np.empty(nb, np.int64)
    ends[:-1] = start_bits[1:nb]
    ends[-1] = start_bits[nb] if nb < n_blocks_total else len(sb)
    final_idx = np.flatnonzero((sb & 0x80) == 0)
    rank0 = np.searchsorted(final_idx, starts)
    if (rank0 + ncp - 1 >= len(final_idx)).any():
        raise ValueError(".ri encoded stream truncated in cumulative ranks")
    cur = final_idx[rank0 + ncp - 1] + 1
    counts = np.minimum(
        r_total - np.arange(nb, dtype=np.int64) * enc_block_size,
        enc_block_size)
    active_all = np.arange(enc_block_size)[None, :] < counts[:, None]
    sym = np.zeros((nb, enc_block_size), np.int8)
    length = np.zeros((nb, enc_block_size), np.int64)
    for t in range(enc_block_size):
        active = active_all[:, t]
        if not active.any():
            break
        if int(cur[active].max()) >= len(sb):
            raise ValueError(".ri encoded stream truncated in runs")
        hdr = np.zeros(nb, np.int64)
        hdr[active] = sb[cur[active]]
        cur = cur + active
        prefix = hdr & 0x1F
        spill = active & (prefix == 31)
        val = np.zeros(nb, np.int64)
        off = 0
        alive = spill.copy()
        while alive.any():
            b = sb[cur[alive]].astype(np.int64)
            val[alive] += (b & 0x7F) << off
            cur[alive] += 1
            nxt = alive.copy()
            nxt[alive] = (b & 0x80) != 0
            alive = nxt
            off += 7
        sym[:, t] = np.where(active, (hdr >> 5) & 0x7, 0)
        length[:, t] = np.where(spill, 32 + val, prefix + 1) * active
    over = cur > ends
    if over.any():
        raise ValueError(
            f".ri encoded block {int(np.flatnonzero(over)[0])} overruns its extent")
    keep = active_all.reshape(-1)
    return sym.reshape(-1)[keep], length.reshape(-1)[keep]


def _decode_legacy_runs(buf: io.BytesIO, n_blocks: int, ncp: int,
                        r_total: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized legacy-block decode: full blocks have a uniform word
    stride [nbits][cum x ncp][n_runs][(sym, len) x block_size], so all of
    them decode via one reshape; only a trailing partial block (and the
    trailing empty block when r % block_size == 0) is read stepwise."""
    n_full = r_total // BLOCK_SIZE
    stride = 1 + ncp + 1 + 2 * BLOCK_SIZE  # in u64 words
    words = np.frombuffer(buf.read(8 * stride * n_full), dtype="<u8")
    if words.size != stride * n_full:
        raise ValueError(".ri legacy blocks truncated")
    blk = words.reshape(n_full, stride) if n_full else words.reshape(0, stride)
    sym_bytes = blk[:, 2 + ncp::2]
    run_len = blk[:, 3 + ncp::2].astype(np.int64).reshape(-1)
    run_sym = BYTE_TO_CODE[sym_bytes.astype(np.int64) & 0xFF].reshape(-1)
    tail_sym: list[int] = []
    tail_len: list[int] = []
    for _ in range(n_full, n_blocks):
        sdsl.read_int_vector(buf, fixed_width=64)
        for _ in range(sdsl.read_u64(buf)):
            sym_byte = int.from_bytes(buf.read(8), "little")
            tail_len.append(int.from_bytes(buf.read(8), "little"))
            tail_sym.append(int(BYTE_TO_CODE[sym_byte]))
    return (np.concatenate([run_sym, np.asarray(tail_sym, np.int64)]),
            np.concatenate([run_len, np.asarray(tail_len, np.int64)]))


def load(data) -> RIndex:
    """Load either format. `data` may be bytes or any seekable file-like (a
    mapping of the file included: only the sections being parsed are read
    out of it)."""
    buf = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    tag = int.from_bytes(buf.read(4), "little")
    if tag != TAG:
        raise ValueError(f"invalid .ri tag {tag:#x}")
    version = int.from_bytes(buf.read(4), "little")
    if version != VERSION:
        raise ValueError(f"unsupported .ri version {version}")
    max_len = int.from_bytes(buf.read(8), "little")
    flags = int.from_bytes(buf.read(8), "little")

    samples, _ = sdsl.read_int_vector(buf)
    last = sdsl.read_sd_vector(buf)
    last_to_run, _ = sdsl.read_int_vector(buf)
    sdsl.read_int_vector(buf, fixed_width=8)  # sym_map (recomputable)
    C_present, _ = sdsl.read_int_vector(buf, fixed_width=64)
    blocks_start = sdsl.read_sd_vector(buf)
    n = sdsl.read_u64(buf)
    n_seq = max_len and last.size // max_len

    if flags & FLAG_ENCODED:
        enc_block_size = sdsl.read_u64(buf)
        buf.read(1)  # has_N byte
        start_bits, _ = sdsl.read_int_vector(buf)
        stream_size = sdsl.read_u64(buf)
        stream = buf.read(stream_size)
        # block b holds runs [b*block_size, min((b+1)*block_size, r)); one
        # trailing empty block exists iff r % block_size == 0
        run_sym, run_len = _decode_encoded_runs(
            stream, start_bits, int(enc_block_size), len(C_present),
            r_total=len(samples))
    else:
        n_blocks = sdsl.read_u64(buf)
        run_sym, run_len = _decode_legacy_runs(
            buf, int(n_blocks), len(C_present), r_total=len(samples))

    idx = _finish_from_runs(
        run_sym, run_len, samples, last.positions, last_to_run,
        n=n, n_seq=int(n_seq), max_len=max_len,
    )
    # sanity: block heads recorded on disk must match recomputed run starts
    expect_heads = idx.run_start[::BLOCK_SIZE]
    if not np.array_equal(blocks_start.positions, expect_heads):
        raise ValueError(".ri block start positions inconsistent with runs")
    return idx


def file_sections(data: bytes) -> list[tuple[str, int]]:
    """On-disk byte size of every substructure of a `.ri` file, in file
    order: the categories print-stats reports (sdsl's size_in_bytes of a
    structure equals its serialized length)."""
    buf = io.BytesIO(data)
    sections: list[tuple[str, int]] = []

    def mark(name, fn):
        at = buf.tell()
        out = fn()
        sections.append((name, buf.tell() - at))
        return out

    tag = int.from_bytes(buf.read(4), "little")
    if tag != TAG:
        raise ValueError(f"invalid .ri tag {tag:#x}")
    buf.read(4 + 8)
    flags = int.from_bytes(buf.read(8), "little")
    sections.append(("header", 24))
    mark("samples", lambda: sdsl.read_int_vector(buf))
    mark("last (sd_vector)", lambda: sdsl.read_sd_vector(buf))
    mark("last_to_run", lambda: sdsl.read_int_vector(buf))
    mark("sym_map", lambda: sdsl.read_int_vector(buf, fixed_width=8))
    mark("C", lambda: sdsl.read_int_vector(buf, fixed_width=64))
    mark("blocks_start_pos (sd_vector)", lambda: sdsl.read_sd_vector(buf))
    misc = 8  # sequence_size
    buf.read(8)
    if flags & FLAG_ENCODED:
        buf.read(8 + 1)  # encoded_block_size, has_N
        misc += 9
        mark("blocks.encoded_start_bits (int_vector<0>)",
             lambda: sdsl.read_int_vector(buf))
        stream_size = sdsl.read_u64(buf)
        buf.read(stream_size)
        misc += 8
        sections.append(("blocks.encoded_stream (bytes)", stream_size))
    else:
        n_blocks = sdsl.read_u64(buf)
        misc += 8
        cum_bytes = runs_bytes = 0
        for _ in range(n_blocks):
            at = buf.tell()
            sdsl.read_int_vector(buf, fixed_width=64)
            cum_bytes += buf.tell() - at
            n_runs = sdsl.read_u64(buf)
            misc += 8
            buf.read(16 * n_runs)
            runs_bytes += 16 * n_runs
        sections.append(("blocks.character_cum_ranks", cum_bytes))
        sections.append(("blocks.runs (pairs)", runs_bytes))
    sections.append(("misc (sequence_size, block sizes)", misc))
    return sections


def load_file(path, use_mmap: bool = False) -> RIndex:
    """Load a .ri file. use_mmap parses straight out of a read-only mapping
    of the file: only the sections being parsed are copied, never the whole
    file."""
    with open(path, "rb") as fh:
        if not use_mmap:
            return load(fh.read())
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            return load(mm)
