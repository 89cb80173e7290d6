"""find-mems, query-tags, build-sdict, build-bwt, build-rindex, print-stats,
convert-tags, tags-check, extract-text, build-tags and merge-tags on the
PyTorch/CUDA port.

    python -m pangenome_index_tpu_torch.cli find-mems RI TAGS READS MIN_LEN MIN_OCC [options]
    python -m pangenome_index_tpu_torch.cli query-tags RI TAGS READS [options]
    python -m pangenome_index_tpu_torch.cli build-sdict RI [-o OUT] [-s S] [options]
    python -m pangenome_index_tpu_torch.cli build-bwt TEXT OUT [--engine E] [--device D]
    python -m pangenome_index_tpu_torch.cli build-rindex RL_BWT [-o OUT] [--format F]
    python -m pangenome_index_tpu_torch.cli print-stats RI [TAGS] [--runtime]
    python -m pangenome_index_tpu_torch.cli convert-tags IN OUT [--compact] [--no-compat] [--wrapped]
    python -m pangenome_index_tpu_torch.cli tags-check TAGS... [--verify-gbz G --verify-rlbwt R]
    python -m pangenome_index_tpu_torch.cli extract-text GBZ [-o OUT] [--forward-only]
    python -m pangenome_index_tpu_torch.cli build-tags GBZ RL_BWT OUT [--k K] [--stats] [--stream-sa]
    python -m pangenome_index_tpu_torch.cli merge-tags GBZ RI TAGS_DIR OUT [--engine E] [--device D]

The commands of `python -m pangenome_index_tpu.cli` (cli.py:104-827) with
the same argv, and output byte-equal to theirs (find-mems and query-tags:
stdout under --engine native and --engine host, apart from the two "Total
time" lines; build-sdict: the npz; build-bwt: the .rl_bwt of every engine;
build-rindex: the .ri bytes of both formats; print-stats, convert-tags,
tags-check, extract-text, build-tags and merge-tags: stdout, the written
file and the exit code, and stderr apart from the seconds). Indexes of any
n are served: past 2^31 positions through int64 tables over two-level
checkpoint rows or bucketed runs (--rank-mode dense and ultra are served
there through bucketed runs, as the reference serves them). A missing file
or invalid input ends a command with `panidx: ...` on stderr and exit code
1, as the JAX command line does.

--engine takes the reference's choices, each with the reference's output:
  device  (the default) the port's kernels on --device (default cuda; a
          missing card is an error, and --device cpu runs the kernels'
          plain PyTorch versions);
  host    numpy on the host: find-mems through models/mems.py and the tag
          array's query per MEM, query-tags through RIndex.count,
          build-sdict through the host frontier build, build-bwt through
          the host rotation sort (models/oracle.py);
  native  the native C++ engine (src/cpp, built with g++ at first use; a
          failed build raises with the compiler's output): find-mems,
          query-tags' count and build-bwt's SA-IS.
find-mems and query-tags take all three, build-sdict device and host,
build-bwt device, native and host; merge-tags host (its default, as the
reference's) and device. --device is read by the device engine only.

find-mems: the rank tables of --rank-mode (checkpoint rows, dense records,
ultra rows or bucketed runs), the m-mer seed table (npz cache beside the
index, else built by its level kernel; m stepped down where the build would
not fit the device, as in the reference), the long-seed dictionary
(npz cache beside the index, else built on the device from the rank tables:
ops/sparsedict.py), MEM finding over the reads in input order in chunks
(K3; --batch-size 0 takes the reference's 4096 reads a launch, fewer where
the device's free memory would not hold them: chunk_size), escalation of
reads past --mem-capacity through K3 at capacity 128 and then 1024, a host
refind past that, tag positions per MEM (K6, in chunks of intervals bounded
the same way; overflowing windows re-queried on the host), and the native
formatter straight to the stdout descriptor - a formatter failure ends the
run (nothing is re-emitted).

query-tags: backward search of every read (K7), then its tag positions (K6,
the reference's run range quirk; overflowing lanes re-queried on the host).

build-sdict: the long-seed dictionary of an index, built ahead of serving
into the file find-mems --long-seed reads.

build-bwt: the text's lines (split on newlines, empty ones dropped) to the
run-length BWT file (.rl_bwt), the rotation sort on --device
(ops/bwt.py), or by the native SA-IS or the host sort. build-rindex: an .rl_bwt to the r-index (.ri) that find-mems
reads, on the host (the native psi walk; there is no device program).

print-stats, convert-tags and tags-check read and write the file formats
on the host and take no --device: the size of every on-disk substructure
of an .ri (and a .tags) file with its bits a run; an algorithm-format .tags
file to compressed bytecode; the run count of each .tags file (a file that
does not load ends the command with exit code 1), and with --verify-gbz
and --verify-rlbwt every tag against a fresh build from the graph.

extract-text and build-tags run on the host and take no --device: a GBZ's
haplotype texts; the tag array of a graph and its .rl_bwt (core/tagbuild.py:
the graph position of each BWT row's suffix, through the suffix array of
the native psi walk; --stats adds the reference's k-mer coverage lines).
merge-tags: the components' .tags files of a directory (any format) merged
into the whole genome's tag array over its GBZ and .ri (core/merge.py), on
the host or by the merge kernel (ops/merge.py) on --device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import native
from .core.merge import merge_tags_pipeline
from .core.tagbuild import (build_tags_pipeline, graph_arrays, tags_per_row,
                            visits_to_text)
from .formats import ri, tags as tagfmt
from .formats.gbz import load_gbz
from .formats.rlbwt import read_rlbwt, rlbwt_from_text, write_rlbwt
from .models.mems import find_all_mems
from .models.oracle import oracle_from_file
from .models.rindex import build_rindex
from .ops.bwt import bwt_tensors
from .ops.count import count
from .ops.mems import find_mems
from .ops.mertable import (device_budget, get_mer_table, read_mer_keys_fast,
                           resolve_mer_len)
from .ops.sparsedict import (DEVICE_BYTES_CAP, get_sparse_dict,
                             read_windows_fast, sdict_vals_to_device)
from .ops.tables import DeferredTables, pos_dtype_for, rindex_to_device, tags_to_device
from .ops.tagquery import query_tags_batch
from .serve import check_rank_tables
from .utils.alphabet import BYTE_TO_CODE

#: device capacities that overflowed reads are re-run at (cli.py:482)
ESCALATION_TIERS = (128, 1024)
#: reads a MEM launch takes when --batch-size is 0 (the reference's chunk,
#: pangenome_index_tpu/cli.py:436)
READ_CHUNK = 4096
#: MEM intervals a tag-position launch (K6) takes at most
TAG_CHUNK = 65536
ENGINE_HELP = ("device: the port's kernels on --device (the card, or their "
               "plain versions on the CPU); host: numpy on the host; native: "
               "the native C++ engine (src/cpp). --device is read by the "
               "device engine only")


def chunk_size(n: int, item_bytes: int, cap: int, budget: int | None) -> int:
    """How many of n items one launch takes: at most `cap`, and no more than
    half of `budget` bytes holds at `item_bytes` each (budget None: no
    limit); at least 1."""
    k = min(n, cap)
    if budget is not None:
        k = min(k, budget // (2 * item_bytes))
    return max(1, k)


def read_bytes(width: int, capacity: int, item: int = 4) -> int:
    """Device bytes one read of `width` codes costs a MEM launch at `item`
    bytes a position (4, or 8 past 2^31): its codes and length; at each of
    its width + 1 window ends the m-mer key (8), validity (1), dictionary
    row (4) and resolve_seeds' seed (4 positions); its [capacity] buffers
    (start, end, bwt_start, size), count, overflow and steps."""
    return (4 * width + 4 + (width + 1) * (8 + 1 + 4 + 4 * item)
            + 4 * item * capacity + 9)


def interval_bytes(capacity: int) -> int:
    """Device bytes one interval costs a K6 launch: its ends, a [capacity]
    row of int64 positions, n_unique, n_runs and overflow."""
    return 8 + 8 * capacity + 9


def read_reads(path: str) -> list[bytes]:
    with open(path, "rb") as fh:
        return [l for l in fh.read().split(b"\n") if l]


def pack_reads(reads: list[bytes]):
    """Reads -> (codes [B, L] int32 right-padded with 0, lengths [B] int32)."""
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    return codes, lens


def resolve_long_seed(arg: int, min_len: int, mer_m: int) -> int:
    """Long-seed dictionary window (ops/sparsedict.py). -1 = auto:
    min_len - 1 (step 1 of every MEM call becomes one stepwise extension),
    capped at 31 (int64 2-bit keys); off when it would not beat the dense
    tier or min_len is tiny. 0 disables."""
    if arg == 0:
        return 0
    s = min(min_len - 1, 31) if arg == -1 else arg
    return s if s > max(mer_m, 3) else 0


def load_serving(args):
    print("Reading the rindex file (encoded)", file=sys.stderr)
    idx = ri.load_file(args.ri)
    print("Reading the tag array index", file=sys.stderr)
    tags = tagfmt.load_tags_file(args.tags,
                                 fmt=getattr(args, "tags_format", "auto"))
    return idx, tags


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device here "
                               "(--device cpu runs the plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _phases(device: torch.device, seconds: dict):
    """mark(name) adds the seconds since the last mark to seconds[name],
    after the device has finished its queued work."""
    last = [time.perf_counter()]

    def mark(name: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - last[0]
        last[0] = now

    return mark


def rank_mode_for(n: int, mode: str) -> str:
    """The rank tables find-mems serves --rank-mode `mode` with at n
    positions: the reference's mapping (pangenome_index_tpu/cli.py:360-366),
    dense and ultra at n >= 2^31 through bucketed runs (their tables would
    be O(n) int64 there); every other case as asked."""
    return "bucketed" if mode in ("dense", "ultra") and n >= 2**31 else mode


def _tag_positions(tags, tt, qs: np.ndarray, qe: np.ndarray, capacity: int,
                   budget: int | None = None):
    """K6 over the intervals [qs, qe] (the reference's run range quirk), in
    chunks of chunk_size(..., TAG_CHUNK, budget) intervals, in order:
    (positions [B, w] int64 with only the occupied columns fetched,
    n_unique [B], n_runs [B]). Lanes past `capacity` are re-queried on the
    host (tags.query), so every lane is complete."""
    dev = tt.bwt_start.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, tt.bwt_start.dtype)

    step = chunk_size(len(qs), interval_bytes(capacity), TAG_CHUNK, budget)
    parts = []
    for a in range(0, len(qs), step):
        res = query_tags_batch(tt, put(qs[a : a + step]), put(qe[a : a + step]),
                               capacity=capacity)
        uniq = res.n_unique.cpu().numpy()
        parts.append((res.positions[:, : max(int(uniq.max()), 1)].contiguous()
                      .cpu().numpy(), uniq, res.n_runs.cpu().numpy(),
                      res.overflow.cpu().numpy()))
    wid = max(p[0].shape[1] for p in parts)
    tpos = np.concatenate([np.pad(p[0], ((0, 0), (0, wid - p[0].shape[1])))
                           for p in parts])
    tuniq, truns, tov = (np.concatenate(f) for f in list(zip(*parts))[1:])
    if tov.any():
        ov = np.flatnonzero(tov)
        vals_ov = [tags.query(int(qs[f]), int(qe[f]))[0] for f in ov]
        wid = max(wid, max(len(v) for v in vals_ov))
        tpos = np.pad(tpos, ((0, 0), (0, wid - tpos.shape[1])))
        for f, v in zip(ov, vals_ov):
            tpos[f, : len(v)] = v
            tuniq[f] = len(v)
    return tpos, tuniq, truns


def print_read_mems(n_reads: int, counts, mem_at, tag_at) -> None:
    """The reference's find-mems print form: per read `Seq: i`, per MEM its
    line and its tag positions (mem_at(i, m) -> (start, end, bwt_start,
    size); tag_at(i, m) -> (n_unique, positions)), then an empty line."""
    for i in range(n_reads):
        print(f"Seq: {i + 1}")
        for m in range(int(counts[i])):
            s, e, b, z = mem_at(i, m)
            print(f"MEM START: {s}, MEM END: {e} BWT START: {b} SIZE: {z}")
            n_unique, vals = tag_at(i, m)
            print(f"Number of unique positions: {n_unique}")
            print("".join(f"{v}, " for v in vals))
        print()


def find_mems_host(args, idx, tags, reads) -> tuple[float, float]:
    """find-mems --engine host (pangenome_index_tpu/cli.py:168-183): the
    numpy model per read and the tag array's query per MEM. Returns the
    seconds of MEM finding and of the tag queries."""
    mem_time = tag_time = 0.0
    found = []
    for read in reads:
        t0 = time.perf_counter()
        found.append(find_all_mems(idx, read, args.min_len, args.min_occ))
        mem_time += time.perf_counter() - t0

    def tag_at(i, m):
        nonlocal tag_time
        mm = found[i][m]
        t0 = time.perf_counter()
        vals, _ = tags.query(mm.bwt_start, mm.bwt_start + mm.size - 1)
        tag_time += time.perf_counter() - t0
        return len(vals), vals

    def mem_at(i, m):
        mm = found[i][m]
        return mm.start, mm.end, mm.bwt_start, mm.size

    print_read_mems(len(reads), [len(f) for f in found], mem_at, tag_at)
    return mem_time, tag_time


def find_mems_native(args, idx, tags, reads) -> tuple[float, float]:
    """find-mems --engine native (pangenome_index_tpu/cli.py:184-218): the
    native engine at --mem-capacity MEMs a read, the reads past it found
    again on the host, the native tag query at --tag-capacity. Returns the
    seconds of MEM finding and of the tag queries."""
    codes, lens = pack_reads(reads)
    t0 = time.perf_counter()
    s, e, b, z, cnt = native.find_mems_native(idx, codes, lens, args.min_len,
                                              args.min_occ, capacity=args.mem_capacity)
    mem_time = time.perf_counter() - t0
    for i in np.flatnonzero(cnt > args.mem_capacity):
        mems = find_all_mems(idx, reads[i], args.min_len, args.min_occ)
        pad = max(len(mems) - s.shape[1], 0)
        if pad:
            s, e, b, z = (np.pad(a, ((0, 0), (0, pad))) for a in (s, e, b, z))
        for m, mm in enumerate(mems):
            s[i, m], e[i, m], b[i, m], z[i, m] = mm.start, mm.end, mm.bwt_start, mm.size
        cnt[i] = len(mems)
    ii = np.repeat(np.arange(len(reads)), cnt)
    within = np.arange(len(ii)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    first_flat = np.cumsum(cnt) - cnt
    t0 = time.perf_counter()
    if len(ii):
        qs = b[ii, within]
        tpos, tuniq, _ = native.query_tags_native(tags, qs, qs + z[ii, within] - 1,
                                                  capacity=args.tag_capacity)
    tag_time = time.perf_counter() - t0

    def tag_at(i, m):
        f = first_flat[i] + m
        return tuniq[f], tpos[f, : tuniq[f]]

    print_read_mems(len(reads), cnt, lambda i, m: (s[i, m], e[i, m], b[i, m], z[i, m]),
                    tag_at)
    return mem_time, tag_time


def parse_mesh(text: str) -> tuple[int, int]:
    """--mesh DATAxMODEL -> (n_data, n_model), both positive."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh {text}: expected DATAxMODEL, two positive integers "
                         f"(e.g. 4x2)")
    return int(parts[0]), int(parts[1])


def cmd_find_mems(args, seconds: dict) -> int:
    if args.engine == "device" and args.mesh:
        return find_mems_mesh(args, seconds)
    if args.engine != "device":
        mark = _phases(torch.device("cpu"), seconds)
        reads = read_reads(args.reads)
        idx, tags = load_serving(args)
        mark("load")
        engine = find_mems_host if args.engine == "host" else find_mems_native
        total_mem_time, total_tag_time = engine(args, idx, tags, reads)
        print(f"\nTotal time for finding all MEMs: {total_mem_time} seconds")
        print(f"Total time for all tag queries: {total_tag_time} seconds")
        sys.stdout.flush()
        mark("output")
        return 0
    dev = _device(args.device)
    mark = _phases(dev, seconds)
    reads = read_reads(args.reads)
    idx, tags = load_serving(args)
    mark("load")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mode = rank_mode_for(idx.n, args.rank_mode)
    t = rindex_to_device(idx, dev, **{mode: True})
    check_rank_tables(t, mode)
    tt = tags_to_device(tags, dev)
    codes, lens = pack_reads(reads)
    mark("tables")

    # seed tiers: `shared` for every launch, `per_read` (host arrays, sent
    # with their chunk) in input read order
    shared, per_read = {}, {}
    mer_m = resolve_mer_len(args.mer_len, args.min_len, idx.n, dev)
    if mer_m:
        path = None if args.no_mer_cache else (lambda m: f"{args.ri}.mer{m}.npz")
        table, mer_m = get_mer_table(idx, mer_m, t, path)
        shared.update(mer_table=table, mer_m=mer_m)
        mark("mer_table")
        mk, mv = read_mer_keys_fast(codes, lens, mer_m)
        per_read.update(mer_keys=mk, mer_valid=mv)
    s_long = resolve_long_seed(args.long_seed, args.min_len, mer_m)
    if s_long:
        sd_path = None if args.no_mer_cache else f"{args.ri}.sdict{s_long}.npz"
        sd_keys, sd_vals = get_sparse_dict(idx, s_long, path=sd_path, tables=t)
        mark("sdict")
        sd_bytes = sd_vals.numel() * sd_vals.element_size()
        if sd_bytes > DEVICE_BYTES_CAP:
            print(f"long-seed dictionary is {sd_bytes >> 20} MB "
                  f"(> {DEVICE_BYTES_CAP >> 20} MB budget); serving with the "
                  f"dense tier only (PANIDX_SDICT_MAX_BYTES overrides)",
                  file=sys.stderr)
        else:
            _, _, di = read_windows_fast(codes, lens, s_long, sd_keys)
            shared.update(sdict_vals=sdict_vals_to_device(sd_vals, dev, t.pos_dtype),
                          sdict_m=s_long)
            per_read["sdict_idx"] = np.ascontiguousarray(di, np.int32)
    n_reads = len(reads)
    mark("windows")

    def mems_of(sel, capacity: int):
        """K3 over the reads `sel` (a slice, or input indices), their arrays
        sent to the device with the launch; the results as host arrays."""
        res = find_mems(t, put(codes[sel]), put(lens[sel]), args.min_len,
                        args.min_occ, capacity=capacity, **shared,
                        **{k: put(v[sel]) for k, v in per_read.items()})
        return [field.cpu().numpy() for field in res]

    t_mem = time.perf_counter()
    budget = device_budget(dev)

    def chunks(n: int, capacity: int):
        """Chunk starts and length for n reads at `capacity` MEMs a read."""
        size = chunk_size(n, read_bytes(codes.shape[1], capacity,
                                         t.C.element_size()),
                          args.batch_size or READ_CHUNK, budget)
        return range(0, n, size), size

    starts_at, B = chunks(n_reads, args.mem_capacity)
    parts = [mems_of(slice(s0, s0 + B), args.mem_capacity) for s0 in starts_at]
    starts, ends, bwts, sizes, counts, overflow = (
        np.concatenate(field) for field in zip(*parts))
    # reads past the buffer re-run on the device at a capacity that holds
    # them (`counts` is exact past the capacity)
    for tier in (c for c in ESCALATION_TIERS if c > args.mem_capacity):
        sel = np.flatnonzero(overflow & (counts <= tier))
        if not len(sel):
            continue
        pad = tier - starts.shape[1]
        if pad > 0:
            starts, ends, bwts, sizes = (np.pad(a, ((0, 0), (0, pad)))
                                         for a in (starts, ends, bwts, sizes))
        starts_at, size = chunks(len(sel), tier)
        for s0 in starts_at:
            part = sel[s0 : s0 + size]
            r2 = mems_of(part, tier)
            for dst, src in zip((starts, ends, bwts, sizes), r2):
                dst[part, :tier] = src
        overflow[sel] = False
        print(f"escalated {len(sel)} overflowed reads to device capacity "
              f"{tier}", file=sys.stderr)
    if overflow.any():
        print(f"{int(overflow.sum())} reads past the top device tier: host "
              f"refind", file=sys.stderr)
        for i in np.flatnonzero(overflow):
            mems = find_all_mems(idx, reads[i], args.min_len, args.min_occ)
            counts[i] = len(mems)
            pad = max(len(mems) - starts.shape[1], 0)
            if pad:
                starts, ends, bwts, sizes = (np.pad(a, ((0, 0), (0, pad)))
                                             for a in (starts, ends, bwts, sizes))
            for m, mm in enumerate(mems):
                starts[i, m], ends[i, m] = mm.start, mm.end
                bwts[i, m], sizes[i, m] = mm.bwt_start, mm.size
    total_mem_time = time.perf_counter() - t_mem
    mark("mems")

    t_tag = time.perf_counter()
    counts = counts.astype(np.int64)
    n_flat = int(counts.sum())
    ii = np.repeat(np.arange(n_reads), counts)
    within = np.arange(n_flat) - np.repeat(np.cumsum(counts) - counts, counts)
    qs = bwts[ii, within]
    tpos, tuniq = np.zeros((0, 1), np.int64), np.zeros(0, np.int64)
    if n_flat:
        tpos, tuniq, _ = _tag_positions(tags, tt, qs, qs + sizes[ii, within] - 1,
                                        args.tag_capacity, budget)
    total_tag_time = time.perf_counter() - t_tag
    mark("tags")

    sys.stdout.flush()
    native.format_mems_native(counts, starts[ii, within], ends[ii, within],
                              qs, sizes[ii, within], tuniq, tpos,
                              sys.stdout.fileno())
    print(f"\nTotal time for finding all MEMs: {total_mem_time} seconds")
    print(f"Total time for all tag queries: {total_tag_time} seconds")
    sys.stdout.flush()
    mark("output")
    return 0


def find_mems_mesh(args, seconds: dict) -> int:
    """find-mems --mesh DATAxMODEL (pangenome_index_tpu/cli.py:222-351): the
    reads over `data`, the index over `model`, one process a card. Under a
    process group named by the environment (torchrun's variables, or JAX's
    COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) this process is one rank
    of it, whose size must be DATA*MODEL; otherwise the command starts that
    many ranks itself on this host (torch.multiprocessing over a FileStore;
    one card a rank, gloo processes with --device cpu), this process being
    rank 0. Rank 0 prints."""
    from .parallel.multihost import init_distributed, launched, spawn_group

    n_data, n_model = parse_mesh(args.mesh)
    if launched():
        dev = init_distributed(device=args.device)
        return serve_mesh(args, n_data, n_model, dev, seconds)
    n = n_data * n_model
    dev = _device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"need {n} devices, have {torch.cuda.device_count()}")
    return spawn_group(_mesh_rank, n, (args.argv, seconds), device=dev.type)


def _mesh_rank(rank: int, world: int, argv: list, seconds: dict) -> int:
    """One rank of a group that find_mems_mesh started: the command's
    arguments parsed again, served as that rank."""
    args = build_parser().parse_args(argv)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(args.device).type == "cuda" else torch.device("cpu"))
    return serve_mesh(args, *parse_mesh(args.mesh), dev, seconds)


def serve_mesh(args, n_data: int, n_model: int, dev: torch.device, seconds: dict) -> int:
    """This rank's part of find-mems --mesh, in the joined process group:
    the seed table and dictionary replicated (built once where no cache
    holds them: rank 0 first), their per-read keys sent with the reads; the
    index whole on every card with model 1 (the one-card kernels), else
    padded and range-sharded over `model` (checkpoint rows for --rank-mode
    checkpoint, the run table otherwise), the whole index put on the card
    only for a seed tier's build and freed before the shards; B = batch *
    DATA global reads a chunk, each chunk padded to a multiple of DATA, this
    rank serving its slice (parallel/engine.py:make_distributed_serving_step),
    every slice gathered on every rank. Reads past --mem-capacity run again at 128,
    then 1024 MEMs a read, as the one-card command escalates them, and past
    that on the host; rank 0 queries the tags of windows past
    --tag-capacity on the host and prints through the one-card command's
    formatter."""
    import torch.distributed as dist

    from .parallel.engine import make_distributed_serving_step
    from .parallel.multihost import put_global
    from .parallel.sharding import make_mesh, pad_rindex_tables, shard_tables

    mesh = make_mesh(n_data, n_model, dev)
    first = mesh.rank == 0
    mark = _phases(dev, seconds)
    reads = read_reads(args.reads)
    idx, tags = load_serving(args)
    mark("load")
    mode = rank_mode_for(idx.n, args.rank_mode)

    def whole_tables():
        whole = rindex_to_device(idx, dev, **{mode: True})
        check_rank_tables(whole, mode)
        return whole

    # tables that build the seed tiers, and with model 1 serve the reads;
    # with model > 1 made only where a seed tier is not cached, and freed
    # before the shards are placed
    t = (whole_tables() if n_model == 1
         else DeferredTables(whole_tables, dev, pos_dtype_for(idx)))
    tt = tags_to_device(tags, dev)
    codes, lens = pack_reads(reads)
    mark("tables")

    shared, per_read = {}, {}
    mer_m = resolve_mer_len(args.mer_len, args.min_len, idx.n, dev)
    s_long = 0

    def seed_tiers():
        """Rank 0 builds (and caches) first; the others after it."""
        nonlocal mer_m, s_long
        if mer_m:
            path = None if args.no_mer_cache else (lambda m: f"{args.ri}.mer{m}.npz")
            table, mer_m = get_mer_table(idx, mer_m, t, path)
            shared.update(mer_table=table, mer_m=mer_m)
            mk, mv = read_mer_keys_fast(codes, lens, mer_m)
            per_read.update(mer_keys=mk, mer_valid=mv)
        s_long = resolve_long_seed(args.long_seed, args.min_len, mer_m)
        if s_long:
            sd_path = None if args.no_mer_cache else f"{args.ri}.sdict{s_long}.npz"
            sd_keys, sd_vals = get_sparse_dict(idx, s_long, path=sd_path, tables=t)
            sd_bytes = sd_vals.numel() * sd_vals.element_size() \
                if isinstance(sd_vals, torch.Tensor) else sd_vals.nbytes
            if sd_bytes > DEVICE_BYTES_CAP:
                if first:
                    print(f"long-seed dictionary is {sd_bytes >> 20} MB (> "
                          f"{DEVICE_BYTES_CAP >> 20} MB budget); serving with the dense "
                          f"tier only (PANIDX_SDICT_MAX_BYTES overrides)", file=sys.stderr)
                s_long = 0
            else:
                _, _, di = read_windows_fast(codes, lens, s_long, sd_keys)
                shared.update(sdict_vals=sdict_vals_to_device(sd_vals, dev, t.pos_dtype),
                              sdict_m=s_long)
                per_read["sdict_idx"] = np.ascontiguousarray(di, np.int32)

    if first:
        seed_tiers()
    dist.barrier()
    if not first:
        seed_tiers()
    mark("seeds")
    if n_model == 1:
        placed = t
    else:
        del t
        placed = shard_tables(pad_rindex_tables(idx, n_model,
                                                checkpoint=args.rank_mode == "checkpoint",
                                                device=mesh.device),
                              mesh)
    n_reads = len(reads)

    def serve(sel: np.ndarray, capacity: int):
        """The reads `sel` (global indices) at `capacity` MEMs a read, in
        chunks of B global reads (fewer at a larger capacity, so that a
        chunk's tag slots stay as many), each chunk's slices gathered on
        every rank: (the six MemResult fields, tag positions [n, M, w],
        n_unique and overflow [n, M]) for the reads of sel, in order."""
        step = make_distributed_serving_step(mesh, capacity=capacity,
                                             tag_capacity=args.tag_capacity, mer_m=mer_m,
                                             sdict_m=s_long)
        B = max(1, (args.batch_size or READ_CHUNK) * args.mem_capacity // capacity) * n_data
        parts = []
        for s0 in range(0, len(sel), B):
            rows = sel[s0 : s0 + B]
            pad = (-len(rows)) % n_data
            fill = {"sdict_idx": -1}
            chunk = {k: np.pad(v[rows], ((0, pad),) + ((0, 0),) * (v.ndim - 1),
                               constant_values=fill.get(k, 0))
                     for k, v in (("codes", codes), ("lens", lens), *per_read.items())}
            local = put_global(mesh, chunk, dict.fromkeys(chunk, "data"))
            seed = []
            if mer_m:
                seed += [shared["mer_table"], local["mer_keys"], local["mer_valid"]]
            if s_long:
                seed += [shared["sdict_vals"], local["sdict_idx"]]
            res, tq, _ = step(placed, tt, local["codes"], local["lens"], args.min_len,
                              args.min_occ, *seed)
            uniq = tq.n_unique.cpu().numpy()
            M = res.bwt_start.shape[1]
            wid = max(int(uniq.max(initial=0)), 1)
            mine = None
            if mesh.axis_index("model") == 0:  # model peers hold the same results
                mine = ([f.cpu().numpy() for f in res],
                        tq.positions.reshape(-1, M, args.tag_capacity)[:, :, :wid].cpu().numpy(),
                        uniq, tq.overflow.cpu().numpy())
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            parts.append((len(rows), [every[d * n_model] for d in range(n_data)]))
        return _gathered(parts)

    t_mem = time.perf_counter()
    found = serve(np.arange(n_reads), args.mem_capacity)
    # reads past the buffer run again at a capacity that holds them (the
    # count is exact past the capacity), then on the host
    for tier in (c for c in ESCALATION_TIERS if c > args.mem_capacity):
        counts, overflow = found[4], found[5]
        sel = np.flatnonzero(overflow & (counts <= tier))
        if not len(sel):
            continue
        again = serve(sel, tier)
        found = [_widen(a, tier) for a in found]
        wid = max(found[6].shape[2], again[6].shape[2])  # tag positions [n, M, w]
        found[6], again[6] = (np.pad(a, ((0, 0), (0, 0), (0, wid - a.shape[2])))
                              for a in (found[6], again[6]))
        for dst, src in zip(found, again):
            dst[sel] = src
        found[5][sel] = False
        if first:
            print(f"escalated {len(sel)} overflowed reads to device capacity {tier}",
                  file=sys.stderr)
    total_mem_time = time.perf_counter() - t_mem
    mark("mems")
    if not first:
        return 0
    t_tag = time.perf_counter()
    _print_mesh_mems(args, idx, tags, reads, found)
    total_tag_time = time.perf_counter() - t_tag
    print(f"\nTotal time for finding all MEMs: {total_mem_time} seconds")
    print(f"Total time for all tag queries: {total_tag_time} seconds")
    sys.stdout.flush()
    mark("output")
    return 0


def _widen(a: np.ndarray, width: int) -> np.ndarray:
    """a with its second dimension zero-padded to at least `width`."""
    if a.ndim < 2 or a.shape[1] >= width:
        return a
    return np.pad(a, ((0, 0), (0, width - a.shape[1])) + ((0, 0),) * (a.ndim - 2))


def _gathered(parts) -> list:
    """The chunks' gathered slices, each cut to its chunk's reads, as whole
    arrays: [start, end, bwt_start, size, count, overflow, tag positions
    [n, M, w], n_unique [n, M], tag overflow [n, M]]."""
    out = []
    for n_chunk, slices in parts:
        wid = max(s[1].shape[2] for s in slices)
        out.append([np.concatenate(f)[:n_chunk] for f in zip(*(s[0] for s in slices))]
                   + [np.concatenate([np.pad(s[1], ((0, 0), (0, 0), (0, wid - s[1].shape[2])))
                                      for s in slices])[:n_chunk],
                      np.concatenate([s[2] for s in slices])[:n_chunk],
                      np.concatenate([s[3] for s in slices])[:n_chunk]])
    wid = max(p[6].shape[2] for p in out)
    for p in out:
        p[6] = np.pad(p[6], ((0, 0), (0, 0), (0, wid - p[6].shape[2])))
    return [np.concatenate(f) for f in zip(*out)]


def _print_mesh_mems(args, idx, tags, reads, found) -> None:
    """Rank 0's output of find-mems --mesh: the gathered MEMs (reads past
    the top device capacity found again on the host, tag windows past the
    tag capacity queried on the host) through the native formatter."""
    starts, ends, bwts, sizes, counts, overflow, tp, tu, tof = found
    counts, tof = counts.astype(np.int64), tof.copy()
    refind = {int(i): find_all_mems(idx, reads[i], args.min_len, args.min_occ)
              for i in np.flatnonzero(overflow)}
    if refind:
        print(f"{len(refind)} reads past the top device tier: host refind", file=sys.stderr)
        width = max(len(m) for m in refind.values())
        starts, ends, bwts, sizes, tu, tof = (_widen(a, width)
                                              for a in (starts, ends, bwts, sizes, tu, tof))
        tp = _widen(tp, width)
        for i, mems in refind.items():
            counts[i] = len(mems)
            for m, mm in enumerate(mems):
                starts[i, m], ends[i, m] = mm.start, mm.end
                bwts[i, m], sizes[i, m] = mm.bwt_start, mm.size
                tof[i, m] = True
    n_flat = int(counts.sum())
    ii = np.repeat(np.arange(len(reads)), counts)
    within = np.arange(n_flat) - np.repeat(np.cumsum(counts) - counts, counts)
    qs, zs = bwts[ii, within].astype(np.int64), sizes[ii, within].astype(np.int64)
    tuniq, tpos = tu[ii, within].astype(np.int64), tp[ii, within]
    again = np.flatnonzero(tof[ii, within])
    vals = [tags.query(int(qs[f]), int(qs[f] + zs[f] - 1))[0] for f in again]
    wid = max([tpos.shape[1]] + [len(v) for v in vals])
    tpos = np.pad(tpos, ((0, 0), (0, wid - tpos.shape[1])))
    for f, v in zip(again, vals):
        tpos[f, : len(v)] = v
        tuniq[f] = len(v)
    sys.stdout.flush()
    native.format_mems_native(counts, starts[ii, within], ends[ii, within], qs, zs, tuniq,
                              tpos, sys.stdout.fileno())


def query_tags_host(args, idx, tags, reads) -> None:
    """query-tags --engine host|native (pangenome_index_tpu/cli.py:600-606,
    631-643): each read's range by RIndex.count (host) or the native
    engine's backward search, then the tag array's query of the range."""
    if args.engine == "host":
        ranges = [idx.count(r) for r in reads]
    else:
        codes, lens = pack_reads(reads)
        first, second = native.count_native(idx, codes, lens)
        ranges = list(zip(first.tolist(), second.tolist()))
    for i, (read, (first, second)) in enumerate(zip(reads, ranges)):
        if first > second:
            print(f"Read {i} has no matches", file=sys.stderr)
            continue
        vals, nruns = tags.query(first, second)
        print(f"Number of unique positions: {len(vals)}")
        print("".join(f"{v}, " for v in vals))
        print(f"read_index={i}\tlen={len(read)}\tbwt_start={first}\tbwt_end={second}"
              f"\truns={nruns}")


def cmd_query_tags(args, seconds: dict) -> int:
    if args.engine != "device":
        mark = _phases(torch.device("cpu"), seconds)
        reads = read_reads(args.reads)
        idx, tags = load_serving(args)
        mark("load")
        query_tags_host(args, idx, tags, reads)
        sys.stdout.flush()
        mark("output")
        return 0
    dev = _device(args.device)
    mark = _phases(dev, seconds)
    reads = read_reads(args.reads)
    idx, tags = load_serving(args)
    mark("load")
    t = rindex_to_device(idx, dev, checkpoint=True)
    tt = tags_to_device(tags, dev)
    codes, lens = pack_reads(reads)
    codes_d, lens_d = (torch.from_numpy(a).to(dev) for a in (codes, lens))
    mark("tables")
    first, second = (a.cpu().numpy() for a in count(t, codes_d, lens_d))
    mark("count")
    ok = first <= second
    tpos, tuniq, truns = _tag_positions(tags, tt, np.where(ok, first, 0),
                                        np.where(ok, second, 0),
                                        args.tag_capacity, device_budget(dev))
    mark("tags")
    for i, read in enumerate(reads):
        if first[i] > second[i]:
            print(f"Read {i} has no matches", file=sys.stderr)
            continue
        vals = tpos[i, : tuniq[i]]
        print(f"Number of unique positions: {len(vals)}")
        print("".join(f"{v}, " for v in vals))
        print(f"read_index={i}\tlen={len(read)}\tbwt_start={first[i]}"
              f"\tbwt_end={second[i]}\truns={truns[i]}")
    sys.stdout.flush()
    mark("output")
    return 0


def cmd_build_sdict(args, seconds: dict) -> int:
    """The long-seed dictionary of an index, built ahead of serving into the
    content-keyed file find-mems --long-seed reads (the JAX command's
    arguments and stderr summary). --engine device: the frontier levels run
    on --device from the index's checkpoint rank tables, shipped mem_only
    as the JAX command ships them (the levels read only the rows, C and n:
    the per-run and locate tables stay on the host); host: the numpy
    frontier (build_sparse_dict), nothing on a device. The file is the same
    either way."""
    host = args.engine == "host"
    dev = torch.device("cpu") if host else _device(args.device)
    mark = _phases(dev, seconds)
    idx = ri.load_file(args.ri, use_mmap=True)
    mark("load")
    s = args.s if args.s > 0 else min(args.min_len - 1, 31)
    out = args.output or f"{args.ri}.sdict{s}.npz"
    t = None if host else rindex_to_device(idx, dev, checkpoint=True, mem_only=True)
    mark("tables")
    t0 = time.perf_counter()
    keys, vals = get_sparse_dict(idx, s, path=out, min_keep=args.min_keep,
                                 tables=t)
    mark("sdict")
    nbytes = keys.nbytes + (vals.nbytes if isinstance(vals, np.ndarray)
                            else vals.numel() * vals.element_size())
    print(f"sparse dict s={s}: {len(keys)} entries, {nbytes >> 20} MB -> {out} "
          f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    return 0


def cmd_build_bwt(args, seconds: dict) -> int:
    """Text -> .rl_bwt (the JAX command's arguments, file and stderr
    summary): the rotations sorted on --device (--engine device), by the
    native engine's SA-IS (native) or by the host rotation sort (host)."""
    dev = _device(args.device) if args.engine == "device" else torch.device("cpu")
    mark = _phases(dev, seconds)
    if args.engine == "host":
        bwt = oracle_from_file(args.text).bwt
        mark("read")
    else:
        with open(args.text, "rb") as fh:
            lines = [l for l in fh.read().split(b"\n") if l]
        mark("read")
        if args.engine == "native":
            bwt = native.build_bwt_native(lines)[0]
        elif lines:
            # only the BWT comes back from the device (the document array
            # and the suffix positions stay there)
            bwt = bwt_tensors(lines, dev)[0].cpu().numpy()
        else:
            # an empty text has no rotation to sort: an empty file, as the
            # reference's default (native) engine writes
            bwt = np.zeros(0, np.uint8)
    mark("build")
    rlbwt = rlbwt_from_text(bwt.tobytes())
    write_rlbwt(args.output, rlbwt)
    mark("write")
    print(f"build-bwt: {rlbwt.n_runs} runs over {rlbwt.size} characters",
          file=sys.stderr)
    return 0


def cmd_build_rindex(args, seconds: dict) -> int:
    """.rl_bwt -> .ri bytes on stdout or in -o (the JAX command's arguments,
    bytes and stderr summary), built on the host."""
    mark = _phases(torch.device("cpu"), seconds)
    rlbwt = read_rlbwt(args.rl_bwt)
    mark("read")
    idx = build_rindex(rlbwt)
    mark("build")
    data = (ri.serialize_legacy(idx) if args.format == "legacy"
            else ri.serialize_encoded(idx))
    if args.output == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.flush()
    else:
        with open(args.output, "wb") as fh:
            fh.write(data)
    mark("write")
    print(f"r-index: {idx.n_runs} runs, {idx.n_seq} sequences, BWT size {idx.n}",
          file=sys.stderr)
    return 0


def cmd_print_stats(args, seconds: dict) -> int:
    """The size of every on-disk substructure of the .ri (and the .tags)
    file, with its bits a run, in the JAX command's lines; --runtime adds
    the host arrays of the loaded index that the device tables are made
    from."""
    def human(name, nbytes, runs):
        line = f"{name}: {nbytes} bytes ({nbytes / (1024.0 * 1024.0):g} MB)"
        if runs:
            line += f", {nbytes * 8.0 / runs:g} bits/run"
        print(line)

    with open(args.ri, "rb") as fh:
        ri_data = fh.read()
    idx = ri.load(ri_data)
    r = idx.n_runs
    print("=== High-level ===")
    print(f"Total sequence length (BWT size): {idx.n}")
    print(f"BWT runs (r-index): {r}")
    tags = None
    if args.tags:
        with open(args.tags, "rb") as fh:
            tags_data = fh.read()
        tags = tagfmt.load_tags(tags_data)
        print(f"Tag array runs: {tags.n_runs}")
    print()
    print("=== R-index components ===")
    sections = ri.file_sections(ri_data)
    for name, nbytes in sections:
        human(name, nbytes, r)
    human("TOTAL r-index (on disk)", sum(b for _, b in sections), r)
    print()
    if tags is not None:
        print("=== Tag arrays (compressed) components ===")
        tsections = tagfmt.file_sections(tags_data)
        for name, nbytes in tsections:
            human(name, nbytes, tags.n_runs)
        human("TOTAL tag arrays (compressed)", sum(b for _, b in tsections), tags.n_runs)
    if args.runtime:
        print()
        print("=== Runtime flat tables (device layout) ===")
        subs = [("run symbols", idx.run_sym.nbytes), ("run starts", idx.run_start.nbytes),
                ("cumulative counts", idx.cum.nbytes), ("SA samples", idx.samples.nbytes),
                ("last (run tails)", idx.last_sorted.nbytes),
                ("last_to_run", idx.last_to_run.nbytes)]
        for name, nbytes in subs:
            human(name, nbytes, r)
        human("TOTAL runtime", sum(b for _, b in subs), r)
    return 0


def cmd_convert_tags(args, seconds: dict) -> int:
    """An algorithm-format .tags file to compressed bytecode (the
    reference's bytes unless --no-compat; compact values with --compact;
    --wrapped prefixes the self-describing wrapper)."""
    with open(args.input, "rb") as fh:
        raw = fh.read()
    data = tagfmt.convert_algorithm(raw, compact=args.compact, compat=args.compat)
    if args.wrapped:
        data = tagfmt.wrap_payload(data, "bytecode-compact" if args.compact else "bytecode")
    with open(args.output, "wb") as fh:
        fh.write(data)
    return 0


def cmd_tags_check(args, seconds: dict) -> int:
    """The run count and covered BWT positions of each .tags file; a file
    that does not load ends the command with its error on stderr and exit
    code 1. With --verify-gbz and --verify-rlbwt, every tag is also held
    against a fresh ground-truth build (core/tagbuild.tags_per_row): a
    `verification OK` or `FAILED (k positions differ)` line a file, exit
    code 1 where one differs."""
    truth = None
    if args.verify_gbz and args.verify_rlbwt:
        mark = _phases(torch.device("cpu"), seconds)
        gbz = load_gbz(args.verify_gbz)
        idx = build_rindex(read_rlbwt(args.verify_rlbwt), keep_sa=True)
        truth = tags_per_row(gbz, idx)
        del idx
        mark("truth")
    rc = 0
    for path in args.tags:
        try:
            tags = tagfmt.load_tags_file(path)
        except Exception as exc:  # the JAX command's report, any load error
            print(f"{path}: FAILED to load ({exc})", file=sys.stderr)
            return 1
        print(f"{path}: {tags.n_runs} runs, covers {tags.total} BWT positions")
        if truth is not None:
            per_pos = np.repeat(tags.pos_enc, tags.run_lengths())
            cmp = per_pos[-len(truth):] if len(per_pos) >= len(truth) else per_pos
            ok = np.array_equal(cmp, truth[: len(cmp)])
            mism = int((cmp != truth[: len(cmp)]).sum()) if not ok else 0
            print(f"{path}: verification {'OK' if ok else f'FAILED ({mism} positions differ)'}")
            rc = rc or (0 if ok else 1)
    return rc


def cmd_extract_text(args, seconds: dict) -> int:
    """GBZ -> newline-separated haplotype text, every GBWT sequence (or the
    forward ones) in sequence order, on stdout or in -o: the paths' node
    visits by the native walk of the record table and their oriented node
    sequences (core/tagbuild.visits_to_text)."""
    mark = _phases(torch.device("cpu"), seconds)
    gbz = load_gbz(args.gbz)
    mark("load")
    n = gbz.index.sequences // 2 if args.forward_only else gbz.index.sequences
    seq_ids = np.arange(n, dtype=np.int64) * (2 if args.forward_only else 1)
    visits, vptr = gbz.index.table().extract_all(seq_ids)
    _, _, node_lens, first = graph_arrays(gbz)
    ends = np.concatenate(([0], np.cumsum(node_lens[(visits >> 1) - first])))[vptr[1:]]
    text = np.insert(visits_to_text(gbz, visits), ends, ord("\n"))
    mark("extract")
    if args.output == "-":
        sys.stdout.buffer.write(text.tobytes())
        sys.stdout.flush()
    else:
        with open(args.output, "wb") as fh:
            fh.write(text.tobytes())
    mark("write")
    return 0


def cmd_build_tags(args, seconds: dict) -> int:
    """GBZ + .rl_bwt -> the tag array in the algorithm format, on the host
    (core/tagbuild.py; its phases' seconds on stderr, as the JAX command
    prints them)."""
    return build_tags_pipeline(args.gbz, args.rl_bwt, args.output, k=args.k,
                               stats=args.stats, stream_sa=args.stream_sa,
                               sa_window_bytes=args.sa_window_bytes, seconds=seconds)


def cmd_merge_tags(args, seconds: dict) -> int:
    """Per-component .tags files (any format) -> the whole genome's tag
    array, compressed sdsl: merged on the host (--engine host, the default)
    or by the merge kernel on --device (--engine device)."""
    mesh = None
    if args.engine == "device":
        from .parallel.multihost import global_mesh, init_distributed, launched

        if launched():
            dev = init_distributed(device=args.device)
            mesh = global_mesh(1, dev)
        else:
            dev = _device(args.device)
    else:
        dev = torch.device("cpu")
    return merge_tags_pipeline(args.gbz, args.ri, args.tags_dir, args.output,
                               window=args.window, chunk_runs=args.chunk_runs,
                               engine=args.engine, device=dev,
                               mark=_phases(dev, seconds), mesh=mesh)


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser."""
    p = argparse.ArgumentParser(prog="python -m pangenome_index_tpu_torch.cli",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, mems in (("find-mems", cmd_find_mems, True),
                           ("query-tags", cmd_query_tags, False)):
        q = sub.add_parser(name)
        q.add_argument("ri")
        q.add_argument("tags")
        q.add_argument("reads")
        q.add_argument("--tag-capacity", type=int, default=256,
                       help="tag positions per interval on the device; "
                            "overflowing intervals re-query on the host")
        if mems:
            q.add_argument("min_len", type=int)
            q.add_argument("min_occ", type=int)
            q.add_argument("--mem-capacity", type=int, default=32,
                           help="MEMs per read in the first launch; reads "
                                "with more re-run at 128, then 1024, then "
                                "on the host")
            q.add_argument("--mer-len", type=int, default=-1,
                           help="m-mer seed table size; -1 = auto (14 on a "
                                "CUDA device, 8 on the CPU, at most "
                                "min_len - 1), 0 disables")
            q.add_argument("--long-seed", type=int, default=-1,
                           help="long-seed dictionary window; -1 = auto "
                                "(min(min_len - 1, 31)), 0 disables")
            q.add_argument("--no-mer-cache", action="store_true",
                           help="neither read nor write the seed table and "
                                "dictionary caches beside the index")
            q.add_argument("--batch-size", type=int, default=0,
                           help="reads per MEM launch; 0 = 4096, fewer where "
                                "the device's free memory would not hold "
                                "them")
            q.add_argument("--rank-mode", default="checkpoint",
                           choices=["checkpoint", "dense", "ultra", "bucketed"],
                           help="device rank representation (checkpoint: one "
                                "64B gather per rank6 query - the fastest, "
                                "see PERF.md)")
            q.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                           help="serve over a (data x model) mesh of processes, "
                                "one a card (gloo processes with --device cpu), "
                                "e.g. 4x2: reads data-sharded, the index "
                                "model-sharded (rank = one all_reduce)")
        q.add_argument("--tags-format", default="auto",
                       choices=["auto", "algorithm", "sdsl", "bytecode",
                                "bytecode-compact"])
        q.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the "
                            "kernels' plain versions)")
        q.add_argument("--engine", choices=["device", "host", "native"],
                       default="device", help=ENGINE_HELP)
        q.set_defaults(fn=fn)
    bs = sub.add_parser("build-sdict")
    bs.add_argument("ri")
    bs.add_argument("-o", "--output", default=None,
                    help="artifact path (default <ri>.sdict<s>.npz: the path "
                         "find-mems --long-seed reads)")
    bs.add_argument("-s", type=int, default=0,
                    help="window length (default min(min_len - 1, 31))")
    bs.add_argument("--min-len", type=int, default=20,
                    help="serving min MEM length the dictionary targets")
    bs.add_argument("--min-keep", type=int, default=1)
    bs.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    bs.add_argument("--engine", choices=["device", "host"], default="device",
                    help=ENGINE_HELP)
    bs.set_defaults(fn=cmd_build_sdict)
    bb = sub.add_parser("build-bwt")
    bb.add_argument("text")
    bb.add_argument("output")
    bb.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    bb.add_argument("--engine", choices=["device", "native", "host"],
                    default="device", help=ENGINE_HELP)
    bb.set_defaults(fn=cmd_build_bwt)
    br = sub.add_parser("build-rindex")
    br.add_argument("rl_bwt")
    br.add_argument("-o", "--output", default="-")
    br.add_argument("--format", choices=["encoded", "legacy"], default="encoded")
    br.set_defaults(fn=cmd_build_rindex)
    ps = sub.add_parser("print-stats")
    ps.add_argument("ri")
    ps.add_argument("tags", nargs="?")
    ps.add_argument("--runtime", action="store_true",
                    help="also report the host arrays the device tables are made from")
    ps.set_defaults(fn=cmd_print_stats)
    ct = sub.add_parser("convert-tags")
    ct.add_argument("input")
    ct.add_argument("output")
    ct.add_argument("--compact", action="store_true")
    ct.add_argument("--no-compat", dest="compat", action="store_false",
                    help="skip the int_vector header instead of decoding it as "
                         "data (the reference's bytes are the default)")
    ct.add_argument("--wrapped", action="store_true",
                    help="prefix the output with a self-describing magic and "
                         "format byte (off: the reference's bytes)")
    ct.set_defaults(fn=cmd_convert_tags)
    tc = sub.add_parser("tags-check")
    tc.add_argument("tags", nargs="+")
    tc.add_argument("--verify-gbz",
                    help="cross-check tag values against a fresh build from this GBZ")
    tc.add_argument("--verify-rlbwt", help="the matching rl_bwt for --verify-gbz")
    tc.set_defaults(fn=cmd_tags_check)
    et = sub.add_parser("extract-text")
    et.add_argument("gbz")
    et.add_argument("-o", "--output", default="-")
    et.add_argument("--forward-only", action="store_true")
    et.set_defaults(fn=cmd_extract_text)
    bt = sub.add_parser("build-tags")
    bt.add_argument("gbz")
    bt.add_argument("rl_bwt")
    bt.add_argument("output")
    bt.add_argument("--k", type=int, default=31)
    bt.add_argument("--stats", action="store_true",
                    help="run the anchored pipeline for coverage statistics")
    bt.add_argument("--stream-sa", action="store_true",
                    help="never hold the 16 B/row SA: windowed native psi walks "
                         "a row window at a time (O(r + window) memory)")
    bt.add_argument("--sa-window-bytes", type=int, default=2 << 30,
                    help="per-pass SA window budget for --stream-sa")
    bt.set_defaults(fn=cmd_build_tags)
    mt = sub.add_parser("merge-tags")
    mt.add_argument("gbz")
    mt.add_argument("ri")
    mt.add_argument("tags_dir")
    mt.add_argument("output")
    mt.add_argument("--window", type=int, default=1 << 22,
                    help="BWT rows processed per batch (bounds peak memory)")
    mt.add_argument("--chunk-runs", type=int, default=1 << 20,
                    help="input-cursor refill size in runs per tag file "
                         "(bounds input-side resident memory)")
    mt.add_argument("--engine", choices=["host", "device"], default="host",
                    help="host: the streamed merge on the host; device: the "
                         "merge kernel on --device. The same output")
    mt.add_argument("--device", default="cuda",
                    help="torch device of --engine device (default cuda; cpu "
                         "runs the kernel's plain version)")
    mt.set_defaults(fn=cmd_merge_tags)
    return p


def main(argv=None, seconds: dict | None = None) -> int:
    """Run one command; `seconds`, when given, receives the seconds of each
    phase (load, tables, ..., output)."""
    args = build_parser().parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return args.fn(args, {} if seconds is None else seconds)
    except FileNotFoundError as exc:
        print(f"panidx: {exc}", file=sys.stderr)
        return 1
    except ValueError as exc:
        print(f"panidx: invalid input: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
