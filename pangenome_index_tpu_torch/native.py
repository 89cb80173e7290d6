"""ctypes bindings for the native CPU engine (src/cpp).

The port's copy of pangenome_index_tpu/native.py, cut to the entry points
the port calls. The unchanged C++ sources under src/cpp/ are compiled on
first use (g++ -O3 -fopenmp) into the port's own build directory,
``build/torch_native/<content-hash>/libpanindex_native.so`` at the
repository root, never into src/cpp/; a failed build raises with the
compiler's output. The hash covers the sources, the flags and the host CPU's
feature flags (the library is built with -march=native).

The native engine is the exact host reference of the kernels (find_mems,
query_tags, count), the command line's formatter, the read-window pass of
serving, the BWT and suffix-array builds of the synthetic index (and the
reference of the card's BWT build), and the psi walk of build-rindex.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

from .utils.alphabet import CODE_TO_BASE

_ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = _ROOT / "src" / "cpp"
SOURCES = ("panindex_native.cpp", "sais.cpp", "gbwt_decode.cpp", "psi_walk.cpp",
           "bitio.cpp", "mem_format.cpp", "read_windows.cpp")
BUILD_ROOT = _ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
LIB_NAME = "libpanindex_native.so"

_lib = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: -march=native code runs only on a CPU
    that has the ones it was built on."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            for line in fh:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _cpu_flags())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile src/cpp into the content-addressed library; returns its path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    # compile into a private directory and rename: a concurrent process must
    # never load a half-written library
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp", dir=BUILD_ROOT))
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, *[str(SRC / s) for s in SOURCES],
             "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed on src/cpp:\n"
                               + proc.stdout.decode(errors="replace"))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not lib_path.exists():  # not a concurrent build that won
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.panindex_format_mems.restype = ctypes.c_int64
        lib.panindex_set_bits.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _index_args(idx):
    """The r-index arguments shared by find_mems and count (the arrays are
    returned too: they must outlive the call)."""
    run_sym = np.ascontiguousarray(idx.run_sym, np.int8)
    run_start = np.ascontiguousarray(idx.run_start, np.int64)
    cum = np.ascontiguousarray(idx.cum, np.int64)
    C = np.ascontiguousarray(idx.C, np.int64)
    return (run_sym, run_start, cum, C), (
        _ptr(run_sym, ctypes.c_int8), _ptr(run_start, ctypes.c_int64),
        _ptr(cum, ctypes.c_int64), _ptr(C, ctypes.c_int64),
        ctypes.c_int64(idx.n_runs), ctypes.c_int64(idx.n))


def find_mems_native(idx, codes: np.ndarray, lengths: np.ndarray,
                     min_len: int, min_occ: int, capacity: int = 64,
                     n_threads: int = 0):
    """Batched MEM finding on the native engine. Returns
    (start, end, bwt, size, count) arrays like ops.mems.MemResult."""
    lib = get_lib()
    B, L = codes.shape
    codes = np.ascontiguousarray(codes, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    keep, index_args = _index_args(idx)
    out = [np.zeros((B, capacity), np.int64) for _ in range(4)]
    count = np.zeros(B, np.int32)
    lib.panindex_find_mems(
        *index_args,
        _ptr(codes, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int64(L),
        ctypes.c_int64(min_len), ctypes.c_int64(min_occ), ctypes.c_int64(capacity),
        _ptr(out[0], ctypes.c_int64), _ptr(out[1], ctypes.c_int64),
        _ptr(out[2], ctypes.c_int64), _ptr(out[3], ctypes.c_int64),
        _ptr(count, ctypes.c_int32), ctypes.c_int32(n_threads),
    )
    del keep
    return out[0], out[1], out[2], out[3], count


def query_tags_native(tags, starts: np.ndarray, ends: np.ndarray,
                      capacity: int = 256, exact: bool = False,
                      n_threads: int = 0):
    """Batched tag interval queries; returns (positions [B, capacity],
    n_unique [B], n_runs [B]) matching models.tagarray.TagArray.query."""
    lib = get_lib()
    pos_enc = np.ascontiguousarray(tags.pos_enc, np.int64)
    bwt_start = np.ascontiguousarray(tags.bwt_start, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    B = len(starts)
    out_pos = np.zeros((B, capacity), np.int64)
    out_unique = np.zeros(B, np.int32)
    out_runs = np.zeros(B, np.int32)
    lib.panindex_query_tags(
        _ptr(pos_enc, ctypes.c_int64), _ptr(bwt_start, ctypes.c_int64),
        ctypes.c_int64(tags.n_runs),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        ctypes.c_int64(B), ctypes.c_int64(capacity), ctypes.c_int(1 if exact else 0),
        _ptr(out_pos, ctypes.c_int64), _ptr(out_unique, ctypes.c_int32),
        _ptr(out_runs, ctypes.c_int32), ctypes.c_int32(n_threads),
    )
    return out_pos, out_unique, out_runs


def count_native(idx, codes: np.ndarray, lengths: np.ndarray, n_threads: int = 0):
    """Batched backward search: (first, second) per read, (1, 0) when the
    read does not occur."""
    lib = get_lib()
    B, L = codes.shape
    codes = np.ascontiguousarray(codes, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    keep, index_args = _index_args(idx)
    first = np.zeros(B, np.int64)
    second = np.zeros(B, np.int64)
    lib.panindex_count(
        *index_args,
        _ptr(codes, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int64(L),
        _ptr(first, ctypes.c_int64), _ptr(second, ctypes.c_int64),
        ctypes.c_int32(n_threads),
    )
    del keep
    return first, second


def format_mems_native(counts: np.ndarray, starts: np.ndarray,
                       ends: np.ndarray, bwts: np.ndarray, sizes: np.ndarray,
                       tuniq: np.ndarray | None, tpos: np.ndarray | None,
                       fd: int) -> int:
    """Render the find-mems stdout format (src/cpp/mem_format.cpp) straight
    to `fd` from flat per-MEM arrays: counts [n_reads], starts/ends/bwts/
    sizes [n_flat], tag positions tpos [n_flat, tstride] with tuniq valid
    entries per row (None = no tag sections). Returns bytes written; a failed
    write raises."""
    lib = get_lib()
    counts = np.ascontiguousarray(counts, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    bwts = np.ascontiguousarray(bwts, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    if tuniq is None:
        tq = tp = None
        tstride = 0
    else:
        tq = np.ascontiguousarray(tuniq, np.int64)
        tp = np.ascontiguousarray(tpos, np.int64)
        tstride = tp.shape[1] if tp.ndim == 2 else 0
    n = lib.panindex_format_mems(
        ctypes.c_int64(len(counts)), _ptr(counts, ctypes.c_int64),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(bwts, ctypes.c_int64), _ptr(sizes, ctypes.c_int64),
        None if tq is None else _ptr(tq, ctypes.c_int64),
        None if tp is None else _ptr(tp, ctypes.c_int64),
        ctypes.c_int64(tstride), ctypes.c_int(fd),
    )
    if n < 0:
        raise RuntimeError("native formatter write failed")
    return int(n)


def window_radix_native(dict_keys: np.ndarray, s: int, bits: int = 20):
    """Bucket-start table over the dictionary keys' high bits (one-time per
    loaded dictionary; src/cpp/read_windows.cpp). Returns (lo [2^bits + 1]
    int64, shift) for read_windows_native."""
    lib = get_lib()
    dict_keys = np.ascontiguousarray(dict_keys, np.int64)
    shift = max(0, 2 * int(s) - bits)
    lo = np.zeros((1 << bits) + 1, np.int64)
    lib.panindex_window_radix(
        _ptr(dict_keys, ctypes.c_int64), ctypes.c_int64(len(dict_keys)),
        ctypes.c_int64(shift), ctypes.c_int64(1 << bits),
        _ptr(lo, ctypes.c_int64))
    return lo, shift


def read_windows_native(codes: np.ndarray, lengths: np.ndarray, m: int,
                        dict_keys: np.ndarray | None = None,
                        radix=None, n_threads: int = 0):
    """Rolling m-mer keys of every read position, and with dict_keys their
    dictionary rows, in one OpenMP pass (src/cpp/read_windows.cpp):
    (keys [B, L+1], valid [B, L+1], idx [B, L+1] or None). Entry i describes
    the window codes[i-m+1 .. i]; valid requires it to be ACGT-only and
    inside the read; idx is -1 for absent or invalid windows. `radix` is
    (lo, shift) from window_radix_native (built here if omitted)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, L = codes.shape
    c2b = np.ascontiguousarray(CODE_TO_BASE, np.int8)
    keys = np.zeros((B, L + 1), np.int64)
    valid = np.zeros((B, L + 1), np.uint8)
    idx = None
    dk_ptr = rl_ptr = None
    n_keys = shift = 0
    if dict_keys is not None and len(dict_keys):
        dict_keys = np.ascontiguousarray(dict_keys, np.int64)
        if radix is None:
            radix = window_radix_native(dict_keys, m)
        rlo, shift = radix
        rlo = np.ascontiguousarray(rlo, np.int64)
        dk_ptr = _ptr(dict_keys, ctypes.c_int64)
        rl_ptr = _ptr(rlo, ctypes.c_int64)
        n_keys = len(dict_keys)
        idx = np.full((B, L + 1), -1, np.int32)
    lib.panindex_read_windows(
        _ptr(codes, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(B), ctypes.c_int64(L), ctypes.c_int64(m),
        _ptr(c2b, ctypes.c_int8), ctypes.c_int64(len(c2b)),
        dk_ptr, ctypes.c_int64(n_keys), rl_ptr, ctypes.c_int64(shift),
        _ptr(keys, ctypes.c_int64), _ptr(valid, ctypes.c_uint8),
        None if idx is None else _ptr(idx, ctypes.c_int32),
        ctypes.c_int32(n_threads))
    return (keys.astype(np.int32 if m <= 15 else np.int64),
            valid.astype(bool), idx)


# ---- what utils/synth.py calls ---------------------------------------------

def build_bwt_native(lines: list[bytes]):
    """Multi-string BWT via SA-IS. Returns (bwt bytes array, da, sa_pos,
    seq_lengths incl. terminator); int32 da/sa_pos below 2^31 characters,
    int64 above."""
    lib = get_lib()
    text = np.frombuffer(b"".join(lines), np.uint8)
    seq_lens = np.array([len(l) for l in lines], np.int64)
    seq_ends = np.cumsum(seq_lens)
    n = int(text.size + len(lines))
    bwt = np.zeros(n, np.uint8)
    small = n + 1 < 2**31
    dt, ct = (np.int32, ctypes.c_int32) if small else (np.int64, ctypes.c_int64)
    da = np.zeros(n, dt)
    sa_pos = np.zeros(n, dt)
    fn = lib.panindex_build_bwt_i32 if small else lib.panindex_build_bwt
    fn(_ptr(np.ascontiguousarray(text), ctypes.c_uint8), ctypes.c_int64(text.size),
       _ptr(np.ascontiguousarray(seq_ends), ctypes.c_int64),
       ctypes.c_int64(len(lines)),
       _ptr(bwt, ctypes.c_uint8), _ptr(da, ct), _ptr(sa_pos, ct))
    return bwt, da, sa_pos, seq_lens + 1


def psi_walk_native(run_start: np.ndarray, psi_base: np.ndarray,
                    is_end: np.ndarray, n: int, n_seq: int,
                    n_threads: int = 0, full_sa: bool = False,
                    window: tuple[int, int] | None = None):
    """Run-length-bounded psi walk (src/cpp/psi_walk.cpp), O(r) memory: the
    lane (sequence) and step of every run head and tail, and each sequence's
    length incl. endmarker: (head_seq, head_t, tail_seq, tail_t, seq_len).
    With full_sa, also (sa_seq, sa_t), the lane and step of every BWT row;
    `window` = (lo, hi) restricts them to rows [lo, hi) (row i at i - lo),
    so that the streamed tag build keeps O(r + window) memory a pass.
    n_threads partitions the lanes over OpenMP threads (0 = the OpenMP
    default)."""
    lib = get_lib()
    run_start = np.ascontiguousarray(run_start, np.int64)
    psi_base = np.ascontiguousarray(psi_base, np.int64)
    is_end = np.ascontiguousarray(is_end, np.uint8)
    r = run_start.size
    heads = [np.zeros(r, np.int64) for _ in range(4)]
    seq_len = np.zeros(n_seq, np.int64)
    lo, hi = (window if window is not None else (0, n)) if full_sa else (0, 0)
    sa = [np.zeros(hi - lo, np.int64) for _ in range(2)]
    lib.panindex_psi_walk_v2(
        _ptr(run_start, ctypes.c_int64), _ptr(psi_base, ctypes.c_int64),
        _ptr(is_end, ctypes.c_uint8),
        ctypes.c_int64(r), ctypes.c_int64(n), ctypes.c_int64(n_seq),
        *(_ptr(h, ctypes.c_int64) for h in heads),
        _ptr(seq_len, ctypes.c_int64), ctypes.c_int32(n_threads),
        *((_ptr(a, ctypes.c_int64) for a in sa) if full_sa else (None, None)),
        ctypes.c_int64(lo), ctypes.c_int64(hi),
    )
    return (*heads, seq_len, *sa) if full_sa else (*heads, seq_len)


def psi_walk_sa_native(run_start: np.ndarray, psi_base: np.ndarray,
                       is_end: np.ndarray, n: int, n_seq: int,
                       n_threads: int = 0):
    """The psi walk over the whole BWT: (seq_len [n_seq] incl. endmarker,
    sa_seq [n], sa_t [n]), the lane and step of every BWT row."""
    res = psi_walk_native(run_start, psi_base, is_end, n, n_seq, n_threads,
                          full_sa=True)
    return res[4], res[5], res[6]


# ---- what formats/sdsl.py calls --------------------------------------------

def unpack_bits_native(words: np.ndarray, width: int, count: int) -> np.ndarray:
    """Single-pass LSB-first bit-field unpack (src/cpp/bitio.cpp)."""
    lib = get_lib()
    words = np.ascontiguousarray(words, "<u8")
    out = np.zeros(count, np.int64)
    lib.panindex_unpack_bits(
        _ptr(words, ctypes.c_uint64), ctypes.c_int64(words.size),
        ctypes.c_int64(width), ctypes.c_int64(count), _ptr(out, ctypes.c_int64))
    return out


def pack_bits_native(values: np.ndarray, width: int) -> np.ndarray:
    """Inverse of unpack_bits_native; returns LE uint64 words."""
    lib = get_lib()
    values = np.ascontiguousarray(values, np.int64)
    nwords = (values.size * width + 63) // 64
    words = np.zeros(nwords, "<u8")
    lib.panindex_pack_bits(
        _ptr(values, ctypes.c_int64), ctypes.c_int64(values.size),
        ctypes.c_int64(width), _ptr(words, ctypes.c_uint64))
    return words


def set_bits_native(words: np.ndarray, nbits: int, expected: int) -> np.ndarray:
    """Indices of set bits (ctz scan): the sd_vector high-bits decode."""
    lib = get_lib()
    words = np.ascontiguousarray(words, "<u8")
    out = np.zeros(expected, np.int64)
    got = lib.panindex_set_bits(
        _ptr(words, ctypes.c_uint64), ctypes.c_int64(nbits),
        _ptr(out, ctypes.c_int64), ctypes.c_int64(expected))
    return out[:got]
