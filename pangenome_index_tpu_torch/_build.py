"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``build/torch_kernels/<content-hash>/libpgt_kernels.so`` at the repository
root, and loaded with ``ctypes``. The first call to ``lib()`` builds it (one
``nvcc`` per source, all started together, then one link); later calls and
later processes reuse the library whose hash matches the sources. A failed
build raises with nvcc's output.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0, so a refused
launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libpgt_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
#: the arguments of an entry point after its rank provider's: extend,
#: find_mems (int32 / int64 positions) and the dictionary's level
_EXTEND = (_P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P)
_MEMS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I64, _P, _P, _P, _P, _P, _P)
_MEMS64 = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I64, _I, _I64, _P, _P, _P, _P, _P,
           _P)
_LEVEL = (_P, _P, _P, _I, _I64, _I64, _I64, _I64, _I64, _I, _I, _I64, _P, _P, _P, _P,
          _P, _P)
#: the bucketed provider's arguments: run_index, buckets, shift, run_rec,
#: run_start, runs
_BUCKET = (_P, _I64, _I, _P, _P, _I64)
#: the dense provider's arguments: lines, n_lines, rec, runs
_DENSE = (_P, _I64, _P, _I64)
#: the seed table's level after its rank provider's: C, parents, n_parents,
#: v, depth, out, stream
_MER = (_P, _P, _I64, _I, _I, _P, _P)
#: the lockstep MEM step's arguments: ranks, apply, super_base, n_super,
#: super_width, super_shift, C, codes, code_stride, lengths, seeds, B, W;
#: then min_len, min_occ, n (by position type); then M, the state arrays
#: and steps, the shard table (kind, count, host array), active and the
#: stream
_STEP_HEAD = (_P, _I, _P, _I64, _I, _I, _P, _P, _I, _P, _P, _I, _I)
_STEP_TAIL = (_I,) + (_P,) * 14 + (_I, _I, _P, _P, _P)
#: argument types of every C entry point (pointers and the stream as void*)
SIGNATURES = {
    "pgt_gather_rows": (_P, _I64, _I, _P, _I64, _P, _P),
    "pgt_rank6_dense": (_P, _I64, _P, _I64, _P, _I64, _P, _P),
    "pgt_extend_ckpt": (_P, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P),
    "pgt_extend_dense": (_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I64,
                         _P, _P, _P, _P),
    "pgt_resolve_seeds": (_P, _I64, _P, _P, _I, _P, _I64, _P, _I, _I64, _I, _P,
                          _P),
    "pgt_find_mems_ckpt": (_P, _I64, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I64, _P, _P, _P, _P, _P, _P),
    "pgt_find_mems_dense": (_P, _I64, _P, _I64, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I64, _P, _P, _P, _P, _P, _P),
    "pgt_query_mem_tags": (_P, _I64, _P, _I64, _P, _P, _P, _P, _I, _I, _I, _P,
                           _P, _P),
    "pgt_row_gather": (_P, _I64, _P, _I64, _I, _I, _P, _P),
    "pgt_gather_chain": (_P, _I64, _P, _I64, _I, _P, _P),
    "pgt_count_ckpt": (_P, _I64, _P, _P, _I64, _P, _I64, _I, _P, _P, _P),
    "pgt_count_dense": (_P, _I64, _P, _I64, _P, _P, _I64, _P, _I64, _I, _P,
                        _P, _P),
    "pgt_query_tags_batch": (_P, _I64, _P, _I64, _P, _P, _P, _I64, _I, _I, _I,
                             _P, _P, _P, _P, _P),
    "pgt_tag_upper_bound": (_P, _I64, _P, _I64, _P, _I64, _P, _P),
    "pgt_sdict_level_ckpt": (_P, _I64, _P, _P, _P, _I, _I64, _I64, _I64, _I64,
                             _I64, _I, _I, _I64, _P, _P, _P, _P, _P, _P),
    "pgt_sdict_level_dense": (_P, _I64, _P, _I64, _P, _P, _P, _I, _I64, _I64,
                              _I64, _I64, _I64, _I, _I, _I64, _P, _P, _P, _P,
                              _P, _P),
    "pgt_locate": (_P, _P, _I64, _P, _P, _P, _I64, _I, _I64, _P, _P, _I64, _I,
                   _P, _P, _P, _P),
    "pgt_bwt_sort_pairs": (_P, _I64, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                           _P),
    "pgt_bwt_rerank_group": (_P, _P, _I64, _I, _P, _P, _P, _P),
    "pgt_bwt_rerank_scatter": (_P, _I64, _I, _P, _P),
    "pgt_bwt_finish_symbols": (_P, _I64, _I64, _P, _P),
    "pgt_bwt_finish_read_off": (_P, _P, _I64, _P, _I64, _P, _P, _P, _P),
    # the int64 instantiations (n >= 2^31): checkpoint rows with their
    # superblock bases (ckpt, nrows, super_S, n_super, super_shift) and
    # int64 positions; the tag search and locate over int64 heads
    "pgt_extend_ckpt64": (_P, _I64, _P, _I64, _I, _P, _P, _P, _P, _P, _P,
                          _I64, _P, _P, _P, _P),
    "pgt_resolve_seeds64": (_P, _I64, _P, _P, _I, _P, _I64, _P, _I, _I64, _I,
                            _P, _P),
    "pgt_find_mems_ckpt64": (_P, _I64, _P, _I64, _I, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I64, _I, _I64, _P, _P, _P, _P, _P,
                             _P),
    "pgt_count_ckpt64": (_P, _I64, _P, _I64, _I, _P, _P, _I64, _P, _I64, _I64,
                         _P, _P, _P),
    "pgt_sdict_level_ckpt64": (_P, _I64, _P, _I64, _I, _P, _P, _P, _I, _I64,
                               _I64, _I64, _I64, _I64, _I, _I, _I64, _P, _P,
                               _P, _P, _P, _P),
    "pgt_tag_upper_bound64": (_P, _I64, _P, _I64, _P, _I64, _P, _P),
    "pgt_query_mem_tags64": (_P, _I64, _P, _I64, _P, _P, _P, _P, _I, _I, _I,
                             _P, _P, _P),
    "pgt_query_tags_batch64": (_P, _I64, _P, _I64, _P, _P, _P, _I64, _I, _I,
                               _I, _P, _P, _P, _P, _P),
    "pgt_locate64": (_P, _P, _I64, _P, _P, _P, _I64, _I, _I64, _P, _P, _I64,
                     _I, _P, _P, _P, _P),
    # the ultra (rank_table, rows) and bucketed (_BUCKET: the run index and
    # records) rank providers; bucketed64: int64 tables and positions
    "pgt_rank6_ultra": (_P, _I64, _P, _I64, _P, _P),
    "pgt_rank6_bucketed": _BUCKET + (_P, _I64, _P, _P),
    "pgt_rank6_bucketed64": _BUCKET + (_P, _I64, _P, _P),
    "pgt_extend_ultra": (_P, _I64) + _EXTEND,
    "pgt_extend_bucketed": _BUCKET + _EXTEND,
    "pgt_extend_bucketed64": _BUCKET + _EXTEND,
    "pgt_find_mems_ultra": (_P, _I64) + _MEMS,
    "pgt_find_mems_bucketed": _BUCKET + _MEMS,
    "pgt_find_mems_bucketed64": _BUCKET + _MEMS64,
    # K3's resident lanes an SM, one entry per rank provider
    **{f"pgt_find_mems_resident_{kind}": (_P,) for kind in (
        "ckpt", "ckpt64", "dense", "dense64", "ultra", "bucketed", "bucketed64")},
    "pgt_sdict_level_ultra": (_P, _I64) + _LEVEL,
    "pgt_sdict_level_bucketed": _BUCKET + _LEVEL,
    "pgt_sdict_level_bucketed64": _BUCKET + _LEVEL,
    # the seed table's level (csrc/mertable.cu), one a rank provider
    "pgt_mer_level_ckpt": (_P, _I64) + _MER,
    "pgt_mer_level_ckpt64": (_P, _I64, _P, _I64, _I) + _MER,
    "pgt_mer_level_dense": (_P, _I64, _P, _I64) + _MER,
    "pgt_mer_level_ultra": (_P, _I64) + _MER,
    "pgt_mer_level_bucketed": _BUCKET + _MER,
    "pgt_mer_level_bucketed64": _BUCKET + _MER,
    # the dense provider at int64 positions (int64 records, int32 lines)
    "pgt_rank6_dense64": _DENSE + (_P, _I64, _P, _P),
    "pgt_extend_dense64": _DENSE + _EXTEND,
    "pgt_find_mems_dense64": _DENSE + _MEMS64,
    "pgt_count_dense64": _DENSE + (_P, _P, _I64, _P, _I64, _I64, _P, _P, _P),
    "pgt_sdict_level_dense64": _DENSE + _LEVEL,
    "pgt_mer_level_dense64": _DENSE + _MER,
    # the one-card tag merge (csrc/merge.cu): a pass's count, scan, place
    "pgt_merge_scan": (_P, _P, _I64, _P),
    "pgt_merge_place": (_P, _P, _P, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _I64, _P, _P,
                        _P, _P, _P),
    # the per-component counts and the sort's digit totals (csrc/merge.cu)
    "pgt_merge_hist": (_P, _I64, _I, _P, _I, _P, _P),
    # a model shard's rank6 partials (csrc/shard.cu): checkpoint rows
    # (planes, rows_local, row0) or runs (rec, index, buckets, first
    # bucket, shift, run_start, runs_local, lo, upper), then pos, npos,
    # out, accumulate, stream
    "pgt_shard_ckpt_rank6": (_P, _I64, _I64, _P, _I64, _P, _I, _P),
    "pgt_shard_ckpt_rank6_64": (_P, _I64, _I64, _P, _I64, _P, _I, _P),
    "pgt_shard_run_rank6": (_P, _P, _I64, _I64, _I, _P, _I64, _I, _I, _P, _I64, _P, _I, _P),
    "pgt_shard_run_rank6_64": (_P, _P, _I64, _I64, _I, _P, _I64, _I64, _I64, _P, _I64, _P,
                               _I, _P),
    # one lockstep iteration of the MEM state machine, fused with the
    # partials of its shards (csrc/memstep.cu)
    "pgt_mem_step": _STEP_HEAD + (_I, _I, _I) + _STEP_TAIL,
    "pgt_mem_step64": _STEP_HEAD + (_I, _I64, _I64) + _STEP_TAIL,
}

_lib = None
#: the first failed build's error: a process does not run nvcc again after it
_build_error = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the content-addressed library; returns its path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp", dir=BUILD_ROOT))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log = []
        failed = []
        for src, _, proc in procs:
            out = proc.communicate()[0].decode(errors="replace")
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        log.append(f"== link\n{link.stdout.decode(errors='replace')}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not lib_path.exists():  # not a concurrent build that won
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """nvcc's output (ptxas register and spill counts) for the current build."""
    path = BUILD_ROOT / _digest() / "build.log"
    return path.read_text() if path.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; after a failed build,
    every later call raises the same error without running nvcc again)."""
    global _lib, _build_error
    if _lib is None:
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            path = build()
        except RuntimeError as exc:
            _build_error = str(exc)
            raise
        handle = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.pgt_error_string.argtypes = (ctypes.c_int,)
        handle.pgt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point `name`; raise if the launch reported a CUDA error."""
    handle = lib()
    err = getattr(handle, name)(*args)
    if err != 0:
        msg = handle.pgt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer for the C API."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, tensor, dtype, device) -> int:
    """Validate a kernel argument and return its data pointer."""
    if tensor.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {tensor.device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return tensor.data_ptr()
