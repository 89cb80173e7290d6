"""pangenome_index_tpu_torch: find-mems serving, the find-mems, query-tags,
build-sdict, build-bwt, build-rindex, print-stats, convert-tags, tags-check,
extract-text, build-tags and merge-tags commands, batched locate, the BWT
build, the tag build and merge and the gather-rate probe on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package pangenome_index_tpu, which stays the reference.
The port imports nothing of that package: the host side (index models,
codecs, synthetic data, the binding of the native C++ engine in src/cpp and
the numpy build functions) is the port's own copy, under the same module
names (utils/, models/, formats/, core/, native.py).

Layout:
  _build.py        nvcc build of csrc/*.cu into one library, loaded with ctypes
  csrc/            the kernels: K1 dense rank + row gather, the ultra and
                   bucketed rank6 (rankmodes.cu), K2 FMD extension, the
                   m-mer seed table's level (mertable.cu),
                   K3 MEM finding (with its seed-resolving pass), K4 per-MEM
                   tag counts, K5 gather probe,
                   K6 tag positions per interval, K7 backward search (count),
                   K8 locate (locate.cu), the tag search tree's descent
                   alone (tagsearch.cu), the long-seed dictionary's
                   frontier level (sparsedict.cu), and the BWT's prefix
                   doubling rounds: radix sort, rerank, finish (bwt.cu),
                   the tag merge, one card or a data shard of it (merge.cu),
                   a model shard's rank6 partials (shard.cu, bodies in
                   shard.cuh) and the lockstep MEM step fused with its
                   shards' partials (memstep.cu);
                   every serving kernel in an int32 instantiation and an
                   int64 one (indexes of n >= 2^31, two-level rank rows),
                   the chain kernels (K2, K3, the seed table's and the
                   dictionary's levels) for
                   each of the four rank providers of csrc/rank.cuh
  native.py        ctypes binding of the native C++ engine (src/cpp)
  utils/ models/ formats/   alphabet, synthetic data and graphs, host index
                   models, the .ri / .tags / GBZ codecs
  core/            the GBWT from paths, the tag build, its k-mer statistics,
                   the tag merge
  ops/             tables, a kernel wrapper and its plain PyTorch version per
                   kernel
  parallel/        the (data, model) mesh over torch.distributed: the
                   tables padded and placed, the model-sharded rank, the
                   distributed MEM and serving steps, the cross-card merge
  serve.py         the find-mems serving pipeline on one device
  spans.py         the serving path's spans and counters (off by default),
                   on one clock with the device
  cli.py           the find-mems, query-tags, build-sdict, build-bwt,
                   build-rindex, print-stats, convert-tags, tags-check,
                   extract-text, build-tags and merge-tags commands
  gather_probe.py  the gather-rate probe (random 64-byte row gathers)
  end_to_end.py    the demo: graph -> GBZ -> index -> MEMs -> tags through
                   the public functions

The public functions are the JAX package's: load_rindex, load_tags
(use_mmap: parse out of a mapping of the file), load_gbz, build_index (the
native SA-IS build; no host-sort fallback), to_device (on "cuda" unless the
caller names another device; dense records, bucketed runs with dense=False)
and find_mems.

Every function that makes tensors takes an explicit `device`. A kernel
wrapper launches its kernel for CUDA tensors (and counts the launch in its
`launches` attribute) and runs its plain version for CPU tensors.
"""

from __future__ import annotations

from .ops.bwt import bwt_finish, bwt_rerank, bwt_sort_pairs
from .ops.count import count
from .ops.dense_rank import gather_rows, rank6_dense
from .ops.fmd import extend
from .ops.gather_probe import gather_chain, row_gather
from .ops.locate import locate_batch
from .ops.merge import merge_rows, merge_rows_shard
from .ops.mems import find_mems as _find_mems_batch
from .ops.mems import mem_step_fused, resolve_seeds
from .ops.mertable import mer_level
from .ops.rank import rank6_bucketed, rank6_ultra
from .ops.shard_rank import shard_ckpt_rank6, shard_run_rank6
from .ops.sparsedict import sdict_level
from .ops.tagquery import query_mem_tags, query_tags_batch, tag_upper_bound

__version__ = "0.1.0"

#: the kernel wrappers, each with its `launches` count
KERNELS = {"gather_rows": gather_rows, "rank6_dense": rank6_dense,
           "extend": extend, "resolve_seeds": resolve_seeds,
           "find_mems": _find_mems_batch,
           "query_mem_tags": query_mem_tags, "row_gather": row_gather,
           "gather_chain": gather_chain, "count": count,
           "query_tags_batch": query_tags_batch,
           "tag_upper_bound": tag_upper_bound,
           "sdict_level": sdict_level, "locate_batch": locate_batch,
           "bwt_sort_pairs": bwt_sort_pairs, "bwt_rerank": bwt_rerank,
           "bwt_finish": bwt_finish, "rank6_ultra": rank6_ultra,
           "rank6_bucketed": rank6_bucketed, "mer_level": mer_level,
           "merge_rows": merge_rows, "shard_ckpt_rank6": shard_ckpt_rank6,
           "shard_run_rank6": shard_run_rank6, "mem_step_fused": mem_step_fused,
           "merge_rows_shard": merge_rows_shard}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def load_rindex(path, use_mmap: bool = False):
    """Load a .ri r-index file (legacy or encoded format); use_mmap parses
    it out of a read-only mapping of the file."""
    from .formats.ri import load_file

    return load_file(path, use_mmap=use_mmap)


def load_tags(path, use_mmap: bool = False):
    """Load a .tags tag-array file (any of the three on-disk formats);
    use_mmap parses it out of a read-only mapping of the file."""
    from .formats.tags import load_tags_file

    return load_tags_file(path, use_mmap=use_mmap)


def load_gbz(path):
    """Load a GBZ graph container (simple-sds format)."""
    from .formats.gbz import load_gbz as _load

    return _load(path)


def build_index(text_lines, keep_sa: bool = True):
    """Build an r-index from newline-free sequence byte strings by the native
    SA-IS build (src/cpp, compiled at first use). A failed native build
    raises with its error: there is no host-sort fallback. With keep_sa the
    index keeps its suffix array (sa_seq, sa_pos) and the sequence lengths,
    which the tag build reads.

    NOTE: FMD-based MEM finding assumes the text contains both strands;
    include each sequence's reverse complement (the reference's bidirectional
    workflow) when serving find_mems."""
    from .formats.rlbwt import rlbwt_from_text
    from .models.rindex import build_rindex_from_sa
    from .native import build_bwt_native

    bwt, da, sa_pos, seq_lengths = build_bwt_native(list(text_lines))
    return build_rindex_from_sa(rlbwt_from_text(bwt.tobytes()), da, sa_pos,
                                seq_lengths, keep_sa=keep_sa)


def to_device(idx, device="cuda", dense: bool = True, **kw):
    """r-index -> tables on `device` for find_mems, with the JAX package's
    to_device fields: dense records by default, at any n (int32 positions
    below 2^31, int64 past it or with dtype=torch.int64), bucketed runs
    with dense=False (bucketed=False asks for base tables, which only the
    plain versions read); checkpoint=True adds checkpoint rows, of
    ckpt_block=64 or 128 positions, and mem_only=True (with checkpoint)
    ships one-row stubs of the per-run and locate tables, as the JAX
    rindex_to_device does. Runs on the card unless the caller asks for the
    CPU."""
    import torch

    from .ops.tables import rindex_to_device

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"to_device: no CUDA device here (device={device!r}; "
                           "pass 'cpu' for the plain versions)")
    kw.setdefault("bucketed", True)
    return rindex_to_device(idx, device, dense=dense, **kw)


def find_mems(tables, reads, min_len: int, min_occ: int, capacity: int = 64):
    """Batched MEM finding on the tables' device. reads: list of byte
    strings. Returns per-read lists of (start, end, bwt_start, size)."""
    import torch

    from .cli import pack_reads

    codes, lens = pack_reads(reads)
    dev = tables.device
    res = _find_mems_batch(tables, torch.from_numpy(codes).to(dev),
                           torch.from_numpy(lens).to(dev), min_len, min_occ,
                           capacity=capacity)
    s, e, b, z = (a.cpu().numpy() for a in (res.start, res.end,
                                            res.bwt_start, res.size))
    cnt = res.count.cpu().numpy()
    return [
        [(int(s[i, m]), int(e[i, m]), int(b[i, m]), int(z[i, m]))
         for m in range(min(int(cnt[i]), capacity))]
        for i in range(len(reads))
    ]
