"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one CUDA card, nvcc)

Builds the port's CUDA kernels from csrc/ (nvcc, first use) and drives the
port's paths through the entry points a user calls, with every kernel's
launch count set to 0 just before a path and read just after it:

1. serving (serve.prepare/run): the bench workload - a 20 Mbp synthetic
   pangenome (8 haplotypes), 16384 reads of 150 bp with 1% errors, min_len
   20, min_occ 1, m=14 seed table, s=19 long-seed dictionary, MEM capacity
   8, tag capacity 8 - through the checkpoint-rank and the dense-rank
   configurations, checked against the native C++ engine;
2. the gather-rate probe (gather_probe.sweep): random 64-byte row gathers
   from a [312500, 16] int32 table, independent and as dependent chains;
3. the find-mems and query-tags commands (cli.main) on the bench index
   written as .ri/.tags files, byte-compared with the JAX package's
   command-line engine `--engine native` (run as its own process), then
   timed per phase on all reads.

Every kernel is held against its plain PyTorch version on the card at its
path's shapes (every value is an integer: tolerance 0). Exits non-zero on
any failure, and at once where there is no card.

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with the launch count of the path that runs it, its largest
difference from the plain version, and both times.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BASE_LEN, N_HAPS, SNP_RATE, INDEX_SEED = 2_500_000, 8, 0.002, 3
N_READS, READ_LEN, READ_ERRORS, READ_SEED = 16384, 150, 0.01, 1
MIN_LEN, MIN_OCC, MER_M, SDICT_S, MEM_CAP, TAG_CAP = 20, 1, 14, 19, 8, 8
N_LANES = 32768   # K1/K2 comparison batch
N_K3 = 512        # K3 comparison: the first sorted reads
REPEATS = 3       # timed serving repeats after the first
CLI_FIND_READS = 2048   # find-mems byte comparison: the first bench reads
CLI_QUERY_ERRORS = 1024  # query-tags: bench reads with errors after the exact ones
PROBE_GROUP_BATCH = 65536  # K5 comparison batch (the probe's grouped sweep)
#: kernel -> (source, the TPU kernel or device program it replaces, the path
#: whose launch count the kernels line reports)
SOURCES = {
    "gather_rows": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:39", "serve"),
    "rank6_dense": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:70", "serve"),
    "extend": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31", "serve"),
    "find_mems": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43", "serve"),
    "query_mem_tags": ("csrc/tagquery.cu", "pangenome_index_tpu/ops/tagquery.py:71", "serve"),
    "row_gather": ("csrc/gather_probe.cu", "examples/gather_pipeline_probe.py:77", "probe"),
    "gather_chain": ("csrc/gather_probe.cu", "examples/gather_pipeline_probe.py:56", "probe"),
    "count": ("csrc/count.cu", "pangenome_index_tpu/ops/rank.py:196", "query-tags"),
    "query_tags_batch": ("csrc/tagbatch.cu", "pangenome_index_tpu/ops/tagquery.py:32", "find-mems"),
}
#: kernels each path must launch (find-mems: its first run, seed table not cached)
PATH_KERNELS = {
    "serve": ("gather_rows", "rank6_dense", "extend", "find_mems", "query_mem_tags"),
    "probe": ("row_gather", "gather_chain"),
    "find-mems": ("gather_rows", "extend", "find_mems", "query_tags_batch"),
    "query-tags": ("count", "query_tags_batch"),
}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    # the run drives one card: show the process only the first visible one,
    # so that torch.cuda.device_count() in the last line counts what was used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import pangenome_index_tpu_torch as port
    from pangenome_index_tpu_torch import _build, gather_probe, host
    from pangenome_index_tpu_torch import cli as port_cli
    from pangenome_index_tpu_torch.ops import (count, dense_rank, fmd,
                                               gather_probe as probe_ops, mems,
                                               mertable, tagquery)
    from pangenome_index_tpu_torch.ops.tables import rindex_to_device, tags_to_device
    from pangenome_index_tpu_torch.serve import prepare, run

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = gather_probe.card_name(dev)
    log(smi)
    card = f"[{smi}]"

    # --- 1. build the kernels -------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas " + line.split("ptxas info    :")[-1].strip())

    # --- workload (host; the index is cached under .bench_cache/) --------
    t0 = time.perf_counter()
    cache = os.path.join(REPO, ".bench_cache")
    idx, lines = host.build_synth_index(BASE_LEN, N_HAPS, snp_rate=SNP_RATE,
                                        seed=INDEX_SEED, cache_dir=cache)
    reads = host.synth_reads(lines, N_READS, READ_LEN, error_rate=READ_ERRORS,
                             seed=READ_SEED)
    codes = host.BYTE_TO_CODE[np.frombuffer(b"".join(reads), np.uint8)]
    codes = codes.reshape(N_READS, READ_LEN).astype(np.int32)
    lens = np.full(N_READS, READ_LEN, np.int32)
    tags = host.synth_tag_array(idx, lines=lines, cache_dir=cache)
    log(f"index: n={idx.n} runs={idx.n_runs} tag runs={tags.n_runs} "
        f"({time.perf_counter() - t0:.1f} s)")
    # the index as files for the command line; the serving phase's
    # dictionary cache is the one find-mems reads beside the .ri
    stem = os.path.join(cache, f"bench_{BASE_LEN}_{N_HAPS}_{INDEX_SEED}")
    ri_path, tags_path = stem + ".ri", stem + ".tags"
    if not (os.path.exists(ri_path) and os.path.exists(tags_path)):
        t0 = time.perf_counter()
        for path, data in ((ri_path, host.ri.serialize_encoded(idx)),
                           (tags_path, host.tagfmt.write_compressed_bytecode(tags))):
            with open(path + ".tmp", "wb") as fh:
                fh.write(data)
            os.replace(path + ".tmp", path)
        log(f"wrote {ri_path} and {tags_path} ({time.perf_counter() - t0:.1f} s)")

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def max_abs_err(got, expect):
        got = got if isinstance(got, tuple) else (got,)
        expect = expect if isinstance(expect, tuple) else (expect,)
        check(len(got) == len(expect), "output arity")
        err = 0
        for g, e in zip(got, expect):
            check(g.shape == e.shape, f"shape {tuple(g.shape)} vs {tuple(e.shape)}")
            err = max(err, int((g.long() - e.long()).abs().max()) if g.numel() else 0)
        return err

    kernels = {}

    def compare(name, kernel, plain, reps=20, plain_reps=3, record=True):
        err = max_abs_err(kernel(), plain())
        torch.cuda.synchronize()
        check(err == 0, f"{name}: kernel differs from its plain version by {err}")
        if not record:
            log(f"{name}: identical to its plain version")
            return
        ms, plain_ms = time_ms(kernel, reps), time_ms(plain, plain_reps)
        kernels[name] = dict(name=name, route="cuda",
                             source="pangenome_index_tpu_torch/" + SOURCES[name][0],
                             replaces=SOURCES[name][1], max_abs_err=err,
                             ms=ms, plain_ms=plain_ms)
        log(f"{name}: identical to its plain version; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms {card}")

    launches = {}

    def read_launches(path):
        launches[path] = {name: fn.launches for name, fn in port.KERNELS.items()}
        log(f"launches on the {path} path: {launches[path]}")
        for name in PATH_KERNELS[path]:
            check(launches[path][name] > 0, f"{name} was not launched on the {path} path")

    # --- 2. K1 and K2 against their plain versions ------------------------
    t_ck = rindex_to_device(idx, dev, checkpoint=True)
    t_dn = rindex_to_device(idx, dev, dense=True)
    rng = np.random.default_rng(7)
    pos = T(rng.integers(0, idx.n + 1, N_LANES).astype(np.int32))
    rows = T(rng.integers(0, idx.n_runs, N_LANES).astype(np.int32))
    compare("gather_rows", lambda: dense_rank.gather_rows(t_dn.rec, rows),
            lambda: dense_rank.gather_rows_plain(t_dn.rec, rows))
    compare("rank6_dense",
            lambda: dense_rank.rank6_dense(t_dn.rec, t_dn.pos_to_run, pos),
            lambda: dense_rank.rank6_dense_plain(t_dn.rec, t_dn.pos_to_run, pos))
    k = rng.integers(0, idx.n, N_LANES)
    lanes = [T(a.astype(np.int32)) for a in (
        k, rng.integers(0, idx.n, N_LANES),
        rng.integers(1, np.minimum(idx.n - k, 4096) + 1),
        rng.choice(np.array([1, 2, 3, 5]), N_LANES))]
    fwd = T(rng.integers(0, 2, N_LANES).astype(bool))
    compare("extend", lambda: fmd.extend(t_ck, *lanes, forward=fwd),
            lambda: fmd.extend_plain(t_ck, *lanes, forward=fwd))
    for t, what in ((t_ck, "checkpoint"), (t_dn, "dense")):
        for f in (None, fwd):
            compare(f"extend ({what}, "
                    f"{'backward' if f is None else 'both directions'})",
                    lambda: fmd.extend(t, *lanes, forward=f),
                    lambda: fmd.extend_plain(t, *lanes, forward=f), record=False)

    # --- 3. the seed-table schedule: m=8 through K2 == host build ---------
    t0 = time.perf_counter()
    check(np.array_equal(mertable.build_mer_table_device(t_ck, 8).cpu().numpy(),
                         host.build_mer_table(idx, 8)),
          "m=8 seed table built with K2 differs from the host build")
    log(f"m=8 seed table through K2: identical to the host build "
        f"({time.perf_counter() - t0:.1f} s)")
    del t_dn

    # --- 4./6. the serving path, both rank configurations -----------------
    sdict_path = f"{ri_path}.sdict{SDICT_S}.npz"
    port.reset_launches()
    results, batches = {}, {}
    for dense in (False, True):
        cfg = "dense" if dense else "checkpoint"
        batches[cfg] = prepare(idx, tags, codes, lens, dev, dense=dense,
                               min_occ=MIN_OCC, mer_m=MER_M, sdict_s=SDICT_S,
                               sdict_path=sdict_path)
        results[cfg] = run(batches[cfg], min_len=MIN_LEN, min_occ=MIN_OCC,
                           capacity=MEM_CAP, tag_capacity=TAG_CAP,
                           repeats=REPEATS)
    read_launches("serve")
    for cfg, r in results.items():
        sec = r.seconds
        log(f"serve [{cfg} rank]: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in sec.items()))
        log(f"serve [{cfg} rank]: dictionary {r.dict_entries} entries, window "
            f"hit rate {r.dict_hit_rate:.4f}")
        log(f"serve [{cfg} rank]: MEM-only {N_READS / sec['mems']:.1f} reads/s, "
            f"MEM+tags {N_READS / (sec['mems'] + sec['tags']):.1f} reads/s "
            f"(steady mean of {REPEATS}; first run {sec['mems_first']:.4f} s "
            f"+ {sec['tags_first']:.4f} s) {card}")

    # --- 5. cross-checks against the native engine (all reads) -----------
    r = results["checkpoint"]
    for name in ("count", "start", "end", "bwt_start", "size", "tag_nu", "tag_ov"):
        a = getattr(r, name)
        check(a.shape == ((N_READS,) if name == "count" else (N_READS, MEM_CAP)),
              f"{name} shape {a.shape}")
    t0 = time.perf_counter()
    s, e, b, z, cnt = host.native.find_mems_native(
        idx, codes, lens, MIN_LEN, MIN_OCC, capacity=MEM_CAP, n_threads=0)
    native_s = time.perf_counter() - t0
    check(np.array_equal(r.count, cnt), "MEM counts differ from the native engine")
    for name, ref in (("start", s), ("end", e), ("bwt_start", b), ("size", z)):
        check(np.array_equal(getattr(r, name), ref),
              f"buffered MEM {name} differs from the native engine")
    eff = np.minimum(cnt, MEM_CAP).astype(np.int64)
    ii = np.repeat(np.arange(N_READS), eff)
    within = np.arange(len(ii)) - np.repeat(np.cumsum(eff) - eff, eff)
    qs = b[ii, within]
    qe = qs + z[ii, within] - 1
    _, tuniq, _ = host.native.query_tags_native(tags, qs, qe, capacity=256,
                                                n_threads=0)
    ok = ~r.tag_ov[ii, within]
    check(np.array_equal(r.tag_nu[ii, within][ok], tuniq[ok]),
          "tag unique counts differ from the native engine")
    check(not r.tag_nu[r.count[:, None] <= np.arange(MEM_CAP)[None, :]].any(),
          "tag counts in empty MEM slots")
    log(f"native cross-check: {int(cnt.sum())} MEMs over {N_READS} reads, "
        f"counts and all {len(ii)} buffered slots identical; tag unique counts "
        f"identical on {int(ok.sum())} slots ({int((~ok).sum())} overflowed); "
        f"native engine {native_s:.2f} s on {os.cpu_count()} cores")

    d = results["dense"]
    for name in ("count", "start", "end", "bwt_start", "size", "tag_nu", "tag_ov"):
        check(np.array_equal(getattr(d, name), getattr(r, name)),
              f"dense-rank configuration differs from checkpoint on {name}")
    log("dense-rank configuration: counts, buffers and tags identical to checkpoint")

    # --- 2 (cont.). K3 and K4 against their plain versions ----------------
    per_read = ("mer_keys", "mer_valid", "sdict_idx")

    def k3(fn, bt, kw, n):  # MemResult fields and the per-read step counts
        res, stats = fn(bt.tables, bt.codes[:n], bt.lengths[:n], MIN_LEN,
                        MIN_OCC, capacity=MEM_CAP, with_stats=True, **kw)
        return (*res, stats["steps"])

    for cfg, bt in batches.items():
        kw = {k: (v[:N_K3] if k in per_read else v) for k, v in bt.seed_kw.items()}
        compare("find_mems" if cfg == "checkpoint" else f"find_mems ({cfg} rank)",
                lambda: k3(mems.find_mems, bt, kw, N_K3),
                lambda: k3(mems.find_mems_plain, bt, kw, N_K3),
                reps=10, plain_reps=1, record=cfg == "checkpoint")
    tt = tags_to_device(tags, dev)
    bufs = (T(r.bwt_start), T(r.size), T(r.count))
    compare("query_mem_tags",
            lambda: tagquery.query_mem_tags(tt, *bufs, capacity=TAG_CAP),
            lambda: tagquery.query_mem_tags_plain(tt, *bufs, capacity=TAG_CAP))
    # K3's time per dependent extension step: the kernel's device time on
    # the whole sorted batch (the profiler's, without the seed resolution
    # the wrapper runs first), set by the batch's longest per-read chain
    bt = batches["checkpoint"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k3_steps = k3(mems.find_mems, bt, bt.seed_kw, N_READS)[-1]
        torch.cuda.synchronize()
    k3_dev = [ev for ev in prof.key_averages() if "find_mems_kernel" in ev.key]
    check(len(k3_dev) == 1 and k3_dev[0].count == 3,
          "the profiler saw no K3 launches")
    k3_ms = k3_dev[0].device_time_total / 3 / 1e3
    k3_us_step = k3_ms * 1e3 / int(k3_steps.max())
    log(f"K3 kernel on all {N_READS} sorted reads: {k3_ms:.4f} ms (device), "
        f"longest read {int(k3_steps.max())} steps (mean "
        f"{float(k3_steps.float().mean()):.2f}): {k3_us_step:.4f} us per "
        f"dependent step {card}")
    del batches, bt

    # --- 7. the gather-rate probe -----------------------------------------
    port.reset_launches()
    t0 = time.perf_counter()
    records = list(gather_probe.sweep(dev))
    read_launches("probe")
    for rec in records:
        log(json.dumps({**rec, "card": smi}))
    log(f"probe sweep: {time.perf_counter() - t0:.1f} s")
    chain = {rec["B"]: rec["us_per_iter"] for rec in records
             if rec["kind"] == "gather_chain"}
    log(f"dependent 64-byte gather: {chain[N_READS]:.4f} us per iteration at "
        f"B={N_READS} (probe gather_chain, device time) vs K3 "
        f"{k3_us_step:.4f} us per extension step at {N_READS} reads: K3 step "
        f"= {k3_us_step / chain[N_READS]:.2f} dependent gathers {card}")
    prng = np.random.default_rng(0)
    PT = gather_probe.make_table(prng, dev)
    for G in (1, 8, 64):
        gidx = T(gather_probe.grouped_indices(prng, G, PROBE_GROUP_BATCH))
        for depth in probe_ops.DEPTHS:
            compare("row_gather" if (G, depth) == (1, 4)
                    else f"row_gather (G={G}, depth={depth})",
                    lambda: probe_ops.row_gather(PT, gidx, G, depth),
                    lambda: probe_ops.row_gather_plain(PT, gidx, G, depth),
                    record=(G, depth) == (1, 4))
    cidx = T(prng.integers(0, gather_probe.ROWS, N_READS).astype(np.int32))
    compare("gather_chain", lambda: probe_ops.gather_chain(PT, cidx),
            lambda: probe_ops.gather_chain_plain(PT, cidx), plain_reps=1)
    del PT

    # --- 8. the find-mems and query-tags commands -------------------------
    cli_dir = os.path.join(cache, "cli")
    os.makedirs(cli_dir, exist_ok=True)

    def reads_file(name, rs):
        path = os.path.join(cli_dir, name)
        with open(path, "wb") as fh:
            fh.write(b"\n".join(rs) + b"\n")
        return path

    def without_seconds(path):
        with open(path, "rb") as fh:
            return b"\n".join(l for l in fh.read().splitlines()
                              if b"seconds" not in l)

    def port_cmd(argv, out):
        """The port's command in this process (its launch counts are this
        process's), stdout (fd 1) to `out` and stderr (fd 2) to `out`.err."""
        seconds = {}
        sys.stdout.flush()
        sys.stderr.flush()
        saved = [os.dup(1), os.dup(2)]
        with open(out, "wb") as fo, open(out + ".err", "wb") as fe:
            os.dup2(fo.fileno(), 1)
            os.dup2(fe.fileno(), 2)
            try:
                rc = port_cli.main(argv, seconds)
                sys.stdout.flush()
                sys.stderr.flush()
            finally:
                os.dup2(saved[0], 1)
                os.dup2(saved[1], 2)
                for fd in saved:
                    os.close(fd)
        check(rc == 0, f"port {argv[0]} exited {rc}")
        return seconds

    def jax_cmd(argv, out):
        """The JAX package's command-line engine, as its own process."""
        t0 = time.perf_counter()
        with open(out, "wb") as fh:
            proc = subprocess.run([sys.executable, "-m", "pangenome_index_tpu.cli",
                                   *argv], stdout=fh, stderr=subprocess.PIPE,
                                  cwd=REPO, timeout=900)
        check(proc.returncode == 0, f"JAX {argv[0]} exited {proc.returncode}: "
              + proc.stderr.decode(errors="replace")[-2000:])
        return time.perf_counter() - t0

    common = [ri_path, tags_path]
    fmt = ["--tags-format", "bytecode"]
    fm_reads = reads_file("find_reads.txt", reads[:CLI_FIND_READS])
    mer_cache = f"{ri_path}.mer{MER_M}.npz"
    if os.path.exists(mer_cache):
        os.remove(mer_cache)  # the first run builds the seed table through K2
    port.reset_launches()
    sec = port_cmd(["find-mems", *common, fm_reads, str(MIN_LEN), str(MIN_OCC),
                    *fmt], os.path.join(cli_dir, "find_port.txt"))
    read_launches("find-mems")
    check(launches["find-mems"]["find_mems"] >= 2,
          "find-mems ran no escalation tier through K3")
    with open(os.path.join(cli_dir, "find_port.txt.err")) as fh:
        for line in fh:
            if "escalated" in line or "refind" in line:
                log("  port find-mems: " + line.strip())
    jax_s = jax_cmd(["find-mems", *common, fm_reads, str(MIN_LEN), str(MIN_OCC),
                     *fmt, "--engine", "native", "--mem-capacity", "1024"],
                    os.path.join(cli_dir, "find_jax.txt"))
    got = without_seconds(os.path.join(cli_dir, "find_port.txt"))
    check(got == without_seconds(os.path.join(cli_dir, "find_jax.txt")),
          "find-mems stdout differs from the JAX command line (--engine native)")
    log(f"find-mems on {CLI_FIND_READS} reads: stdout byte-equal to the JAX "
        f"command line --engine native ({len(got)} bytes, "
        f"{got.count(b'MEM START')} MEMs; JAX native {jax_s:.1f} s); port "
        + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))

    exact = host.synth_reads(lines, N_READS, READ_LEN, error_rate=0.0, seed=2)
    qt_reads = reads_file("query_reads.txt", exact + reads[:CLI_QUERY_ERRORS])
    port.reset_launches()
    sec = port_cmd(["query-tags", *common, qt_reads, *fmt],
                   os.path.join(cli_dir, "query_port.txt"))
    read_launches("query-tags")
    jax_s = jax_cmd(["query-tags", *common, qt_reads, *fmt, "--engine", "native"],
                    os.path.join(cli_dir, "query_jax.txt"))
    got = without_seconds(os.path.join(cli_dir, "query_port.txt"))
    check(got == without_seconds(os.path.join(cli_dir, "query_jax.txt")),
          "query-tags stdout differs from the JAX command line (--engine native)")
    log(f"query-tags on {len(exact) + CLI_QUERY_ERRORS} reads: stdout "
        f"byte-equal to the JAX command line --engine native ({len(got)} "
        f"bytes, {got.count(b'read_index=')} reads found; JAX native "
        f"{jax_s:.1f} s); port " + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()))

    all_reads = reads_file("all_reads.txt", reads)
    for name, argv in (("find-mems", ["find-mems", *common, all_reads,
                                      str(MIN_LEN), str(MIN_OCC), *fmt]),
                       ("query-tags", ["query-tags", *common, qt_reads, *fmt])):
        t0 = time.perf_counter()
        sec = port_cmd(argv, os.path.join(cli_dir, "timed.txt"))
        log(f"{name} on all {N_READS if name == 'find-mems' else len(exact) + CLI_QUERY_ERRORS} "
            f"reads (caches warm): {time.perf_counter() - t0:.4f} s; "
            + ", ".join(f"{k} {v:.4f} s" for k, v in sec.items()) + f" {card}")
    for suffix in ("", ".err"):
        os.remove(os.path.join(cli_dir, "timed.txt" + suffix))

    # --- 9. K6 and K7 against their plain versions, at the commands' shapes
    # the buffered MEM intervals of the serving batch, at the command line's
    # tag capacity
    mq = (T(qs.astype(np.int32)), T(qe.astype(np.int32)))
    for ex in (False, True):
        compare("query_tags_batch (exact)" if ex else "query_tags_batch",
                lambda: tagquery.query_tags_batch(tt, *mq, 256, ex),
                lambda: tagquery.query_tags_batch_plain(tt, *mq, 256, ex),
                record=not ex)
    qcodes, qlens = host.pack_reads(exact + reads[:CLI_QUERY_ERRORS])
    qc, ql = T(qcodes), T(qlens)
    compare("count", lambda: count.count(t_ck, qc, ql),
            lambda: count.count_plain(t_ck, qc, ql), plain_reps=1)
    t_dn = rindex_to_device(idx, dev, dense=True)
    compare("count (dense rank)", lambda: count.count(t_dn, qc, ql),
            lambda: count.count_plain(t_dn, qc, ql), record=False)

    for name, entry in kernels.items():
        entry["launches"] = launches[SOURCES[name][2]][name]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernels[n] for n in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
