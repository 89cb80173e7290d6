"""Drive the PyTorch/CUDA port of find-mems serving on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; one CUDA card, nvcc)

Builds the port's CUDA kernels from csrc/ (nvcc, first use), holds each kernel
against its plain PyTorch version on the card at the serving path's shapes
(every value is an integer: tolerance 0), then serves the bench workload -
a 20 Mbp synthetic pangenome (8 haplotypes), 16384 reads of 150 bp with 1%
errors, min_len 20, min_occ 1, m=14 seed table, s=19 long-seed dictionary,
MEM capacity 8, tag capacity 8 - through the checkpoint-rank and the
dense-rank configurations, and checks every result against the native C++
engine. Exits non-zero on any failure, and at once where there is no card.

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launch count on the serving path, its largest
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
SOURCES = {
    "gather_rows": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:39"),
    "rank6_dense": ("csrc/dense_rank.cu", "pangenome_index_tpu/ops/pallas_rank.py:70"),
    "extend": ("csrc/fmd.cu", "pangenome_index_tpu/ops/fmd.py:31"),
    "find_mems": ("csrc/mems.cu", "pangenome_index_tpu/ops/mems.py:43"),
    "query_mem_tags": ("csrc/tagquery.cu", "pangenome_index_tpu/ops/tagquery.py:71"),
}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import pangenome_index_tpu_torch as port
    from pangenome_index_tpu_torch import _build, host
    from pangenome_index_tpu_torch.ops import dense_rank, fmd, mems, mertable, tagquery
    from pangenome_index_tpu_torch.ops.tables import rindex_to_device, tags_to_device
    from pangenome_index_tpu_torch.serve import prepare, run

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
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
    del t_ck, t_dn

    # --- 4./6. the serving path, both rank configurations -----------------
    sdict_path = os.path.join(cache, f"port_sdict_s{SDICT_S}.npz")
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
    launches = {name: fn.launches for name, fn in port.KERNELS.items()}
    log(f"launches on the serving path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the serving path")
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
    _, tuniq, _ = host.native.query_tags_native(tags, qs, qs + z[ii, within] - 1,
                                                capacity=256, n_threads=0)
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

    def k3(fn, bt, kw):  # MemResult fields and the per-read step counts
        res, stats = fn(bt.tables, bt.codes[:N_K3], bt.lengths[:N_K3], MIN_LEN,
                        MIN_OCC, capacity=MEM_CAP, with_stats=True, **kw)
        return (*res, stats["steps"])

    for cfg, bt in batches.items():
        kw = {k: (v[:N_K3] if k in per_read else v) for k, v in bt.seed_kw.items()}
        compare("find_mems" if cfg == "checkpoint" else f"find_mems ({cfg} rank)",
                lambda: k3(mems.find_mems, bt, kw),
                lambda: k3(mems.find_mems_plain, bt, kw),
                reps=10, plain_reps=1, record=cfg == "checkpoint")
    tt = tags_to_device(tags, dev)
    bufs = (T(r.bwt_start), T(r.size), T(r.count))
    compare("query_mem_tags",
            lambda: tagquery.query_mem_tags(tt, *bufs, capacity=TAG_CAP),
            lambda: tagquery.query_mem_tags_plain(tt, *bufs, capacity=TAG_CAP))

    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernels[n] for n in SOURCES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
