"""``.tags`` tag-array file codecs: load and write all three reference
formats, convert an algorithm file to compressed bytecode (convert-tags),
and the on-disk sizes print-stats reports.

The port's copy of pangenome_index_tpu/formats/tags.py, cut to what the
commands call and the tests need to make every input format; the bytes are
identical.

1. **algorithm** format: an sdsl ``int_vector<8>`` container file
   ([u64 bit_count][payload padded to 64-bit words]) whose payload is a bare
   concatenation of ByteCode varints of *full* run encodings
   (offset:10 | is_rev:1 | length:9 | node_id<<20).
2. **compressed bytecode**: [u64 n_bytes][ByteCode varints of run encodings]
   [sd_vector: byte offset of every 10th run][sd_vector: BWT run starts].
   Values are *full* encodings (older writer) or *compact* ones. The
   reference's convert_tags reads the whole algorithm file, its 8-byte
   header and zero padding included, as ByteCode data (one bogus leading
   run, zero-length runs dropped); ``convert_algorithm`` reproduces that
   byte for byte with compat=True.
3. **compressed sdsl / compact**: [int_vector<0> of compact encodings]
   [sd_vector: item index of every 10th run][sd_vector: BWT run starts].
"""

from __future__ import annotations

import io
import mmap

import numpy as np

from ..models.tagarray import MAX_TAG_LEN, START_EVERY_K, TagArray, split_long_runs
from . import bytecode, sdsl

LENGTH_MASK = MAX_TAG_LEN - 1

#: optional self-describing wrapper: [8-byte magic]["v" u8][fmt u8][payload];
#: the reference formats carry no magic, so bare payloads are classified by
#: structural arithmetic (see _sniff)
WRAP_MAGIC = b"PanIdxTg"
_WRAP_FMTS = ["algorithm", "sdsl", "bytecode", "bytecode-compact"]


def wrap_payload(payload: bytes, fmt: str) -> bytes:
    return WRAP_MAGIC + bytes([1, _WRAP_FMTS.index(fmt)]) + payload


def unwrap_payload(data: bytes) -> tuple[bytes, str] | None:
    """(payload, fmt) if `data` carries the wrapper, else None."""
    if data[: len(WRAP_MAGIC)] != WRAP_MAGIC:
        return None
    version, fmt_code = data[len(WRAP_MAGIC)], data[len(WRAP_MAGIC) + 1]
    if version != 1 or fmt_code >= len(_WRAP_FMTS):
        raise ValueError(
            f"unsupported wrapped .tags version/format {version}/{fmt_code}")
    return data[len(WRAP_MAGIC) + 2 :], _WRAP_FMTS[fmt_code]


# ------------------------------------------------------------- encodings

def encode_full(pos_enc: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Full 64-bit pack with the 9-bit length field; pos_enc is the compact
    pack (id<<11|rev<<10|off)."""
    pos_enc = np.asarray(pos_enc, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    off = pos_enc & 0x3FF
    rev = (pos_enc >> 10) & 1
    nid = pos_enc >> 11
    return off | (rev << 10) | ((lengths & LENGTH_MASK) << 11) | (nid << (11 + 9))


def decode_full(values):
    values = np.asarray(values, dtype=np.int64)
    off = values & 0x3FF
    rev = (values >> 10) & 1
    lengths = (values >> 11) & LENGTH_MASK
    nid = values >> 20
    pos_enc = off | (rev << 10) | (nid << 11)
    return pos_enc, lengths


# ------------------------------------------------------- algorithm format

def read_algorithm(data: bytes) -> TagArray:
    nbits = int.from_bytes(data[:8], "little")
    payload = data[8 : 8 + nbits // 8]
    values = bytecode.decode_stream(payload)
    pos_enc, lengths = decode_full(values)
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return TagArray(pos_enc=pos_enc, bwt_start=starts, total=int(lengths.sum()))


def write_algorithm(tags: TagArray) -> bytes:
    lengths = tags.run_lengths()
    pos, lens = split_long_runs(tags.pos_enc, lengths)
    payload = bytecode.write_values(encode_full(pos, lens))
    nwords = (len(payload) + 7) // 8
    out = io.BytesIO()
    sdsl.write_u64(out, len(payload) * 8)
    out.write(payload)
    out.write(b"\x00" * (nwords * 8 - len(payload)))
    return out.getvalue()


# ------------------------------------------- compressed (both variants)

def _write_compressed_tail(buf, run_offsets: np.ndarray, lens: np.ndarray) -> None:
    """The two sd_vector sidecars of both compressed variants: the offset
    (byte or item) of every 10th run, and the BWT run starts."""
    t = len(lens)
    samples = run_offsets[::START_EVERY_K] if t else np.zeros(0, np.int64)
    size = int(samples[-1]) + 1 if t else 1
    sdsl.write_sd_vector(buf, sdsl.SdVector(size=size, positions=samples))
    starts = np.zeros(t, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    sdsl.write_sd_vector(buf, sdsl.SdVector(size=int(lens.sum()) + 1, positions=starts))


def write_compressed_sdsl(tags: TagArray, width: int | None = None) -> bytes:
    lengths = tags.run_lengths()
    pos, lens = split_long_runs(tags.pos_enc, lengths)
    t = len(pos)
    if width is None:
        # the reference sizes the element width from the largest node id:
        # 11 + bits(max node id)
        width = 11 + sdsl.bits_length(int(pos.max(initial=0)) >> 11)
    buf = io.BytesIO()
    sdsl.write_int_vector(buf, pos, width)
    _write_compressed_tail(buf, np.arange(t, dtype=np.int64), lens)
    return buf.getvalue()


def _write_compressed_bytecode_values(values: np.ndarray, lens: np.ndarray) -> bytes:
    t = len(values)
    stream = bytearray()
    byte_offsets = np.zeros(t, dtype=np.int64)
    for i, v in enumerate(values.tolist()):
        byte_offsets[i] = len(stream)
        bytecode.write_value(stream, v)
    buf = io.BytesIO()
    sdsl.write_u64(buf, len(stream))
    buf.write(bytes(stream))
    _write_compressed_tail(buf, byte_offsets, lens)
    return buf.getvalue()


def write_compressed_bytecode(tags: TagArray, compact: bool = False) -> bytes:
    lengths = tags.run_lengths()
    pos, lens = split_long_runs(tags.pos_enc, lengths)
    values = pos if compact else encode_full(pos, lens)
    return _write_compressed_bytecode_values(values, lens)


def convert_algorithm(raw: bytes, compact: bool = False, compat: bool = True) -> bytes:
    """convert-tags: an algorithm file -> a compressed bytecode file.

    compat=True gives the reference binary's bytes: the whole input file
    (header, payload and padding) is decoded as one ByteCode stream and
    zero-length runs are dropped; compat=False decodes the payload alone.
    """
    if compat:
        values = bytecode.decode_stream(raw)
    else:
        nbits = int.from_bytes(raw[:8], "little")
        values = bytecode.decode_stream(raw[8 : 8 + nbits // 8])
    pos_enc, lengths = decode_full(values)
    keep = lengths > 0
    pos_enc, lengths = pos_enc[keep], lengths[keep]
    out_values = pos_enc if compact else encode_full(pos_enc, lengths)
    return _write_compressed_bytecode_values(out_values, lengths)


def _as_buf(data):
    """bytes -> fresh BytesIO; file-likes (a mapping of the file included)
    pass through, rewound."""
    if isinstance(data, (bytes, bytearray)):
        return io.BytesIO(data)
    data.seek(0)
    return data


def _finish(pos_enc: np.ndarray, intervals: sdsl.SdVector) -> TagArray:
    starts = intervals.positions.astype(np.int64)
    return TagArray(pos_enc=pos_enc, bwt_start=starts, total=int(intervals.size) - 1)


def read_compressed_sdsl(data) -> TagArray:
    buf = _as_buf(data)
    pos_enc, _ = sdsl.read_int_vector(buf)
    sdsl.read_sd_vector(buf)  # item-index samples (recomputable)
    intervals = sdsl.read_sd_vector(buf)
    return _finish(pos_enc, intervals)


def read_compressed_bytecode(data) -> TagArray:
    buf = _as_buf(data)
    nbytes = sdsl.read_u64(buf)
    stream = buf.read(nbytes)
    values = bytecode.decode_stream(stream)
    sdsl.read_sd_vector(buf)  # byte-offset samples
    intervals = sdsl.read_sd_vector(buf)
    # detect full vs compact values: full encodings reproduce the interval
    # lengths in their 9-bit length field
    pos_full, lens_full = decode_full(values)
    iv_lens = np.diff(np.concatenate((intervals.positions, [intervals.size - 1])))
    if len(values) and np.array_equal(lens_full, iv_lens):
        return _finish(pos_full, intervals)
    return _finish(values, intervals)


def file_sections(data: bytes) -> list[tuple[str, int]]:
    """On-disk byte size of every substructure of a `.tags` file (the
    categories print-stats reports for the compressed formats); an
    algorithm-format file is one section."""
    buf = io.BytesIO(data)
    sections: list[tuple[str, int]] = []
    kind = _sniff(data)
    if kind == "algorithm":
        return [("encoded_runs (raw ByteCode stream)", len(data))]
    at = buf.tell()
    if kind == "sdsl":
        sdsl.read_int_vector(buf)
        sections.append(("encoded_runs (int_vector)", buf.tell() - at))
    else:
        nbytes = sdsl.read_u64(buf)
        buf.read(nbytes)
        sections.append(("encoded_runs (ByteCode)", buf.tell() - at))
    at = buf.tell()
    sdsl.read_sd_vector(buf)
    sections.append(("encoded_runs_starts (sd_vector)", buf.tell() - at))
    at = buf.tell()
    sdsl.read_sd_vector(buf)
    sections.append(("bwt_intervals (sd_vector)", buf.tell() - at))
    return sections


def _sniff(data: bytes) -> str:
    """Classify a .tags payload: 'algorithm', 'sdsl' (int_vector<0> of compact
    runs) or 'bytecode' (varint stream), by container arithmetic."""
    if len(data) >= 8:
        nbits = int.from_bytes(data[:8], "little")
        if nbits % 8 == 0 and 8 + ((nbits // 8 + 7) // 8) * 8 == len(data):
            return "algorithm"
    if len(data) >= 9:
        nbits = int.from_bytes(data[:8], "little")
        width = data[8]
        nwords = (nbits + 63) // 64
        if width and nbits % width == 0 and 9 + nwords * 8 < len(data):
            return "sdsl"
    return "bytecode"


def load_tags(data: bytes, fmt: str = "auto") -> TagArray:
    """Load a .tags payload. fmt='auto' detects the container (algorithm /
    compressed-sdsl / compressed-bytecode) by structural arithmetic, with an
    explicit override for a payload that parses as more than one format:
    'algorithm' | 'sdsl' | 'bytecode' (full values) | 'bytecode-compact'.
    A wrapped payload is detected first and dispatched by its recorded
    format."""
    wrapped = unwrap_payload(data) if len(data) >= 10 else None
    if wrapped is not None:
        data, wfmt = wrapped
        if fmt not in ("auto", wfmt):
            raise ValueError(
                f"wrapped .tags declares format {wfmt!r}, --tags-format says {fmt!r}")
        fmt = wfmt
    if fmt != "auto":
        if fmt == "algorithm":
            return read_algorithm(data)
        if fmt == "sdsl":
            return read_compressed_sdsl(data)
        if fmt in ("bytecode", "bytecode-compact"):
            buf = _as_buf(data)
            nbytes = sdsl.read_u64(buf)
            values = bytecode.decode_stream(buf.read(nbytes))
            sdsl.read_sd_vector(buf)
            intervals = sdsl.read_sd_vector(buf)
            if fmt == "bytecode":
                pos_full, _ = decode_full(values)
                return _finish(pos_full, intervals)
            return _finish(values, intervals)
        raise ValueError(f"unknown tags format {fmt!r}")
    kind = _sniff(data)
    if kind == "algorithm":
        # [u64 bit_count][payload padded to words], nothing after - the
        # compressed formats carry trailing sd_vectors
        try:
            return read_algorithm(data)
        except Exception:
            pass
    if kind == "sdsl":
        try:
            return read_compressed_sdsl(data)
        except Exception:
            pass
    return read_compressed_bytecode(data)


def load_tags_file(path, use_mmap: bool = False, fmt: str = "auto") -> TagArray:
    """Load a .tags file. use_mmap parses straight out of a read-only
    mapping of the file: the compressed formats copy only the sections being
    parsed; an algorithm-format or wrapped payload is sliced out of the
    mapping whole, as its parse needs it as bytes."""
    with open(path, "rb") as fh:
        if not use_mmap:
            return load_tags(fh.read(), fmt=fmt)
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            return load_tags(mm, fmt=fmt)
