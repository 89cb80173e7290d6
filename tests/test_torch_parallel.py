"""The port's multi-card path in one process, against the JAX package: the
padded tables (pad_rindex_tables), the model shards' rank6 partials summed
over S virtual shards (the plain versions of csrc/shard.cu) against JAX's
distributed_ckpt_rank6 / distributed_rank6 under shard_map on the
8-virtual-device CPU mesh, the lockstep MEM engine (the plain step of
csrc/memstep.cu) against find_mems_plain and JAX's find_mems_impl, the data
shards' merge against merge_rows, stitch_rle_shards, the mesh's refusals,
and the host oracle brute_force_mems. Every output is an integer: the
tolerance is 0. The real process groups are tests/test_torch_distributed.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pangenome_index_tpu.models.oracle import brute_force_mems as jax_brute_force_mems
from pangenome_index_tpu.ops.mems import find_mems_impl
from pangenome_index_tpu.parallel import multihost as jax_multihost
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu_torch import cli, native
from pangenome_index_tpu_torch.formats.rlbwt import rlbwt_from_text
from pangenome_index_tpu_torch.models.rindex import build_rindex_from_sa
from pangenome_index_tpu_torch.models import oracle
from pangenome_index_tpu_torch.ops import merge as merge_ops
from pangenome_index_tpu_torch.ops import mems, rank
from pangenome_index_tpu_torch.ops.mertable import (build_mer_table, get_mer_table,
                                                     read_mer_keys_fast)
from pangenome_index_tpu_torch.ops.sparsedict import (build_sparse_dict, get_sparse_dict,
                                                      read_windows_fast)
from pangenome_index_tpu_torch.ops.tables import (DeferredTables, pos_dtype_for,
                                                  rindex_to_device)
from pangenome_index_tpu_torch.parallel import merge as pmerge
from pangenome_index_tpu_torch.parallel import multihost, sharding
from pangenome_index_tpu_torch.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu_torch.utils.synth import (build_synth_index, synth_haplotypes,
                                                   synth_reads)

#: the padded tables' forms: bucketed runs, checkpoint rows, two-level rows
#: forced on a small index, the MEM-only stubs
PAD_FORMS = {"runs": {}, "checkpoint": dict(checkpoint=True),
             "two-level": dict(checkpoint=True, super_shift=9),
             "mem-only": dict(checkpoint=True, mem_only=True)}
FIELDS = ("run_sym", "run_start", "cum", "C", "samples", "last_sorted", "last_to_run",
          "bucket_lo", "ckpt", "ckpt_super")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(6_000, 4, seed=2)


def packed(reads, L):
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    return codes, lens


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("form", list(PAD_FORMS))
def test_pad_rindex_tables_matches_jax(index, form, S):
    idx, _ = index
    with jax.enable_x64(False):
        want = jax_sharding.pad_rindex_tables(idx, S, **PAD_FORMS[form])
    got = sharding.pad_rindex_tables(idx, S, device="cpu", **PAD_FORMS[form])
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    assert (got.n, got.n_seq, got.max_len) == (int(want.n), int(want.n_seq),
                                                int(want.max_len))
    if got.ckpt is not None:
        assert got.ckpt.shape[0] % S == 0
        assert got.ckpt_planes.shape == got.ckpt.shape
    else:
        assert got.run_start.shape[0] % S == 0


def boundary_positions(idx, t, S, rng):
    """Random positions, 0, n - 1, n, and both sides of each shard's start."""
    edges = [0, idx.n - 1, idx.n]
    if t.ckpt is not None:
        rows = t.ckpt.shape[0] // S
        edges += [64 * rows * m + d for m in range(S) for d in (-1, 0, 1)]
    else:
        runs = t.run_start.shape[0] // S
        edges += [int(t.run_start[runs * m]) + d for m in range(S) for d in (-1, 0, 1)]
    edges = np.clip(edges, 0, idx.n)
    return np.concatenate((rng.integers(0, idx.n + 1, 1500), edges))


def jax_sharded_rank6(t_jax, pos, S, ckpt: bool):
    """JAX's distributed rank6 under shard_map over a 1 x S mesh of the
    8 virtual CPU devices."""
    mesh = jax_sharding.make_mesh(1, S)

    def mapped(fn, *specs):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(),
                                     check_vma=False))

    if not ckpt:
        fn = mapped(jax_sharding.distributed_rank6, P("model"), P("model"),
                    P("model", None), P())
        return np.asarray(fn(t_jax.run_start, t_jax.run_sym, t_jax.cum, pos))
    if t_jax.ckpt_super is None:
        fn = mapped(jax_sharding.distributed_ckpt_rank6, P("model", None), P())
        return np.asarray(fn(t_jax.ckpt, pos))
    fn = mapped(lambda c, p, sb: jax_sharding.distributed_ckpt_rank6(c, p, super_base=sb),
                P("model", None), P(), P())
    return np.asarray(fn(t_jax.ckpt, pos, t_jax.ckpt_super))


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("form", ["checkpoint", "two-level", "runs"])
def test_shard_partials_sum_to_jax_distributed_rank6(index, form, S):
    """The S shards' partials (each by its plain version), summed, equal
    JAX's distributed rank6 on the same padded tables and positions, and
    the whole index's rank6; where positions straddle the shards' starts
    exactly one shard owns each."""
    idx, _ = index
    kw = PAD_FORMS[form]
    with jax.enable_x64(False):
        t_jax = jax_sharding.pad_rindex_tables(idx, S, **kw)
    t = sharding.pad_rindex_tables(idx, S, device="cpu", **kw)
    pos = boundary_positions(idx, t, S, np.random.default_rng(S))
    with jax.enable_x64(False):
        want = jax_sharded_rank6(t_jax, jnp.asarray(pos, t_jax.pos_dtype), S, "runs" != form)
    prov = sharding.virtual_shards(t, S, "cpu")
    tp = torch.from_numpy(pos).to(t.pos_dtype)
    got = prov(tp)
    np.testing.assert_array_equal(got.long().numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.long().numpy(), rank.rank6(t, tp).long().numpy())
    owners = sum((sh.rank6(tp) != 0).any(dim=1).long() for sh in prov.shards)
    assert int(owners.max()) <= 1


@pytest.mark.parametrize("tiers", ["none", "dense", "sdict", "both"])
@pytest.mark.parametrize("form", ["checkpoint", "two-level", "runs"])
def test_lockstep_engine_matches_plain_and_jax(index, form, tiers):
    """find_mems_lockstep over 2 virtual shards (the fused step's plain
    version: the plain step and the plain partials), find_mems_plain with
    that provider as rank6_fn, and find_mems_plain through the whole tables
    give one MemResult, equal to JAX's find_mems_impl through the same
    padded tables."""
    idx, lines = index
    S = 2
    kw = PAD_FORMS[form]
    t = sharding.pad_rindex_tables(idx, S, device="cpu", **kw)
    reads = synth_reads(lines, 30, 44, error_rate=0.03, seed=11) + [lines[0][:9],
                                                                    lines[1][:30]]
    codes, lens = packed(reads, 44)
    seed_np = {}
    if tiers in ("dense", "both"):
        mk, mv = read_mer_keys_fast(codes, lens, 6)
        seed_np.update(mer_table=build_mer_table(idx, 6), mer_keys=np.asarray(mk, np.int32),
                       mer_valid=mv)
    if tiers in ("sdict", "both"):
        keys, vals = build_sparse_dict(idx, 15)
        seed_np.update(sdict_vals=vals, sdict_idx=np.asarray(
            read_windows_fast(codes, lens, 15, keys)[2], np.int32))
    ms = dict(mer_m=6 if "mer_table" in seed_np else 0,
              sdict_m=15 if "sdict_vals" in seed_np else 0)

    def torch_kw():
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in seed_np.items()}
        for k in ("mer_table", "sdict_vals"):
            if k in out:
                out[k] = out[k].to(t.pos_dtype)
        return {**out, **{k: v for k, v in ms.items() if v}}

    c, n = torch.from_numpy(codes), torch.from_numpy(lens)
    prov = sharding.virtual_shards(t, S, "cpu")
    got = mems.find_mems_lockstep(prov.shards, prov.C, prov.n, c, n, 12, 1, capacity=6,
                                  super_base=prov.super_base, super_shift=prov.super_shift,
                                  **torch_kw())
    hooked = mems.find_mems_plain(t, c, n, 12, 1, capacity=6, rank6_fn=prov, **torch_kw())
    whole = mems.find_mems_plain(t, c, n, 12, 1, capacity=6, **torch_kw())
    with jax.enable_x64(False):
        t_jax = jax_sharding.pad_rindex_tables(idx, S, **kw)
        jkw = {k: jnp.asarray(v) for k, v in seed_np.items()}
        for k in ("mer_table", "sdict_vals"):
            if k in jkw:
                jkw[k] = jkw[k].astype(t_jax.pos_dtype)
        want = find_mems_impl(t_jax, jnp.asarray(codes), jnp.asarray(lens), 12, 1,
                              capacity=6, **jkw, **ms)
    for g, h, w, j in zip(got, hooked, whole, want):
        assert torch.equal(g.long(), h.long()) and torch.equal(g.long(), w.long())
        np.testing.assert_array_equal(g.long().numpy(), np.asarray(j).astype(np.int64))
    assert int(got.count.sum()) > len(reads)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("C", [1, 3, 300])
def test_merge_shards_match_one_card(C, shards):
    """The data shards' merge (each shard's base from the counts of the
    shards before it) equals merge_rows on all rows, including rows of no
    component; and equals JAX's merge_tags_device's scan by definition."""
    rng = np.random.default_rng(C * 10 + shards)
    n = 3001
    comp = rng.integers(-1, C, n).astype(np.int32)
    counts = np.bincount(comp[comp >= 0], minlength=C)
    stream = rng.integers(0, 1 << 40, int(counts.sum())).astype(np.int64)
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    on = [torch.from_numpy(a) for a in (comp, stream, offsets)]
    want = merge_ops.merge_rows_plain(*on)
    assert torch.equal(pmerge.merge_virtual_shards(*on, shards), want)
    one = merge_ops.merge_rows_shard_plain(*on, lambda c: torch.zeros_like(c))
    assert torch.equal(one, want)


def test_merge_inputs_relabel_as_jax():
    """merge_inputs relabels components as JAX's merge_tags_device: sorted
    ids to 0..C-1, rows of components without a stream and endmarkers to
    -1."""
    rng = np.random.default_rng(3)
    comps = [5, 9, 40]
    streams = {c: rng.integers(0, 1000, 7) for c in comps}
    cpr = np.array([9, -1, 5, 40, 7, 9, 5, 40], np.int64)
    dense, flat, offsets = pmerge.merge_inputs(cpr, streams)
    np.testing.assert_array_equal(dense, [1, -1, 0, 2, -1, 1, 0, 2])
    np.testing.assert_array_equal(flat, np.concatenate([streams[c] for c in comps]))
    np.testing.assert_array_equal(offsets, [0, 7, 14, 21])


@pytest.mark.parametrize("seed", range(6))
def test_stitch_rle_shards_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(int(rng.integers(0, 6))):
        k = int(rng.integers(0, 5))
        shards.append((rng.integers(0, 3, k).astype(np.int64),
                       rng.integers(1, 4, k).astype(np.int64)))
    got, want = multihost.stitch_rle_shards(shards), jax_multihost.stitch_rle_shards(shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mesh_refusals_and_noop_join(monkeypatch):
    """Without a process group a mesh has one place; a larger one is the
    JAX message. init_distributed without a coordinator does nothing."""
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed() is None
    assert not torch.distributed.is_initialized()
    m = sharding.make_mesh(1, 1, "cpu")
    assert m.shape == {"data": 1, "model": 1} and m.axis_index("model") == 0
    t = torch.arange(3)
    assert torch.equal(m.all_reduce(t.clone(), "model"), t)
    assert torch.equal(m.all_gather(t, "data"), t[None])
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        sharding.make_mesh(4, 2)
    for bad in ("4", "2x", "x2", "2x0", "axb", "2x2x2"):
        with pytest.raises(ValueError, match="DATAxMODEL"):
            cli.parse_mesh(bad)
    assert cli.parse_mesh("4X2") == (4, 2)


def test_mesh_entry_points_default_to_the_card(monkeypatch, tmp_path, index):
    """make_mesh, global_mesh, init_distributed with a coordinator,
    spawn_group and pad_rindex_tables place on a card unless asked for the
    CPU: with no card they raise, before any group is joined, rank started
    or table built."""
    idx, _ = index
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: sharding.make_mesh(1, 1), lambda: multihost.global_mesh(1),
                 lambda: multihost.spawn_group(print, 2),
                 lambda: sharding.pad_rindex_tables(idx, 2, checkpoint=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_distributed()
    assert not torch.distributed.is_initialized()
    assert sharding.make_mesh(1, 1, "cpu").device == torch.device("cpu")
    assert sharding.pad_rindex_tables(idx, 2, device="cpu").device == torch.device("cpu")


def test_brute_force_mems_matches_jax_and_find_mems():
    """The port's copy of the oracle equals JAX's on small texts, and the
    port's plain MEM finder (through tables of the same text) finds the
    same (start, end, occurrences)."""
    fwd = synth_haplotypes(400, 3, seed=5)
    lines = fwd + [l.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1] for l in fwd]
    bwt, da, sa_pos, seq_lengths = native.build_bwt_native(lines)
    idx = build_rindex_from_sa(rlbwt_from_text(bwt.tobytes()), da, sa_pos, seq_lengths)
    reads = synth_reads(fwd, 6, 40, error_rate=0.05, seed=6)
    t = rindex_to_device(idx, "cpu", checkpoint=True)
    codes, lens = packed(reads, 40)
    res = mems.find_mems_plain(t, torch.from_numpy(codes), torch.from_numpy(lens), 10, 1,
                               capacity=64)
    for i, r in enumerate(reads):
        got = oracle.brute_force_mems(lines, r, 10, 1)
        assert got == jax_brute_force_mems(lines, r, 10, 1)
        k = int(res.count[i])
        found = [(int(res.start[i, m]), int(res.end[i, m]), int(res.size[i, m]))
                 for m in range(k)]
        assert sorted(found) == sorted(got)


def test_cached_seed_tiers_need_no_whole_tables(index, tmp_path):
    """The model-sharded command defers the whole index's tables: a seed
    table or dictionary read from its cache builds none of them, a miss
    builds them once, and both give the same tiers."""
    idx = index[0]
    t = rindex_to_device(idx, "cpu", checkpoint=True)
    assert pos_dtype_for(idx) == t.pos_dtype
    built = []

    def once():
        built.append(1)
        return t

    def never():
        raise AssertionError("the whole tables were built for a cache hit")

    mer_path, sd_path = str(tmp_path / "m.npz"), str(tmp_path / "d.npz")
    miss = DeferredTables(once, "cpu", t.pos_dtype)
    table, m = get_mer_table(idx, 6, miss, mer_path)
    keys, vals = get_sparse_dict(idx, 12, path=sd_path, tables=miss)
    assert built == [1] and m == 6
    hit = DeferredTables(never, "cpu", t.pos_dtype)
    table2, m2 = get_mer_table(idx, 6, hit, mer_path)
    keys2, vals2 = get_sparse_dict(idx, 12, path=sd_path, tables=hit)
    assert m2 == m and torch.equal(table2, table) and table2.dtype == t.pos_dtype
    np.testing.assert_array_equal(keys2, keys)
    assert torch.equal(vals2, vals)
