"""The lockstep MEM step fused with its shards' rank partials, on the CPU
(its plain version: what ops/mems.py:mem_step_fused runs for CPU tensors),
against the unfused step and the JAX package: the step equals
mem_step_plain followed by the shards' summed partials at the new query
positions, and those ranks equal JAX's distributed rank6 under shard_map on
the 8-virtual-device CPU mesh, at the first iteration and deep in the loop;
the engine built on it (find_mems_lockstep) equals JAX's find_mems_impl on
batches whose last read finishes off a multiple of the iterations between
two reads of the active count, and on batches of one read and of none.
Every output is an integer: the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pangenome_index_tpu.ops.mems import find_mems_impl
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu_torch.ops import mems
from pangenome_index_tpu_torch.ops.mertable import build_mer_table, read_mer_keys_fast
from pangenome_index_tpu_torch.ops.sparsedict import build_sparse_dict, read_windows_fast
from pangenome_index_tpu_torch.parallel import sharding
from pangenome_index_tpu_torch.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu_torch.utils.synth import build_synth_index, synth_reads

FORMS = {"checkpoint": dict(checkpoint=True),
         "two-level": dict(checkpoint=True, super_shift=9), "runs": {}}
MIN_LEN, MIN_OCC, CAPACITY, L = 12, 1, 6, 44
#: iterations run before the "deep" step is checked
DEEP = 37


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    return build_synth_index(6_000, 4, seed=2)


def packed(reads):
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    return codes, lens


def seed_tiers(idx, codes, lens):
    """Both seed tiers' host arrays (m = 6, s = 15) and their sizes."""
    mk, mv = read_mer_keys_fast(codes, lens, 6)
    keys, vals = build_sparse_dict(idx, 15)
    return (dict(mer_table=build_mer_table(idx, 6), mer_keys=np.asarray(mk, np.int32),
                 mer_valid=np.asarray(mv), sdict_vals=vals,
                 sdict_idx=np.asarray(read_windows_fast(codes, lens, 15, keys)[2], np.int32)),
            dict(mer_m=6, sdict_m=15))


def torch_seeds(seed_np, ms, pd):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in seed_np.items()}
    for k in ("mer_table", "sdict_vals"):
        out[k] = out[k].to(pd)
    return {**out, **ms}


def jax_sharded_rank6(t_jax, pos, S, ckpt: bool):
    """JAX's distributed rank6 under shard_map over a 1 x S mesh."""
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


def copy(state):
    return mems.StepState(*(f.clone() for f in state))


@pytest.mark.parametrize("at", ["first", "deep"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_fused_step_equals_step_then_partials(index, form, S, at):
    """The fused step's plain version on S virtual shards equals
    mem_step_plain followed by the shards' summed partials at the new query
    positions (zeros for reads not in a step), state for state; its ranks,
    with two-level rows' superblock bases added, equal JAX's distributed
    rank6 at those positions."""
    idx, lines = index
    t = sharding.pad_rindex_tables(idx, S, device="cpu", **FORMS[form])
    prov = sharding.virtual_shards(t, S, "cpu")
    reads = synth_reads(lines, 40, L, error_rate=0.03, seed=21) + [lines[2][:13]]
    codes, lens = packed(reads)
    seed_np, ms = seed_tiers(idx, codes, lens)
    c = torch.from_numpy(codes)
    padded, _ = mems._prepare(c, align=8)
    B, W = c.shape[0], c.shape[1] + 1
    seeds = mems.resolve_seeds(B, W, MIN_OCC, **torch_seeds(seed_np, ms, t.pos_dtype))
    args = (prov.C, prov.n, padded, torch.from_numpy(lens), seeds, L, MIN_LEN, MIN_OCC,
            prov.super_base, prov.super_shift)
    state = mems.step_state(B, CAPACITY, t.pos_dtype, "cpu")
    ranks = torch.zeros((2 * B, 6), dtype=t.pos_dtype)
    apply = at == "deep"
    if apply:
        mems.mem_step_fused_plain(state, ranks, prov.shards, *args, apply=False)
        for _ in range(DEEP - 1):
            mems.mem_step_fused_plain(state, ranks, prov.shards, *args)
        phases = torch.bincount(state.phase.long(), minlength=5)
        assert int(phases[1:4].min()) > 0  # reads in each step remain
    ref, ref_ranks = copy(state), ranks.clone()
    live = mems.mem_step_fused_plain(state, ranks, prov.shards, *args, apply=apply)
    want_live = mems.mem_step_plain(ref, ref_ranks if apply else None, *args)
    on, pos = mems.query_positions(ref)
    summed = prov.partial(pos.to(t.pos_dtype))
    want = torch.where(torch.cat((on, on))[:, None], summed, 0)
    assert live == want_live > 0
    assert torch.equal(ranks, want)
    for f in mems.StepState._fields:
        assert torch.equal(getattr(state, f), getattr(ref, f)), f
    full = ranks.long()
    if prov.super_base is not None:
        full = mems._super_add(full, pos, prov.super_base, prov.super_shift)
    with jax.enable_x64(False):
        t_jax = jax_sharding.pad_rindex_tables(idx, S, **FORMS[form])
        jpos = jnp.asarray(pos.numpy(), t_jax.pos_dtype)
        jr = jax_sharded_rank6(t_jax, jpos, S, form != "runs").astype(np.int64)
    both = torch.cat((on, on)).numpy()
    np.testing.assert_array_equal(full.numpy()[both], jr[both])


def edge_batch(lines, case):
    """The reads of a batch-shape case: many reads whose last finishes off a
    multiple of ACTIVE_CHECK_EVERY iterations, one read, none."""
    if case == "none":
        return []
    if case == "one":
        return synth_reads(lines, 1, L, error_rate=0.03, seed=5)
    return synth_reads(lines, 25, L, error_rate=0.03, seed=10) + [lines[1][:20]]


@pytest.mark.parametrize("case", ["off-multiple", "one", "none"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_lockstep_engine_batch_edges(index, form, S, case):
    """find_mems_lockstep (the fused step's plain version, eager, the count
    read every ACTIVE_CHECK_EVERY iterations) equals JAX's find_mems_impl
    through the same padded tables, with both seed tiers; its iters is the
    first multiple of ACTIVE_CHECK_EVERY at or past the iteration after
    which no read is active (0 without reads), which for the off-multiple
    batch is not itself a multiple."""
    idx, lines = index
    t = sharding.pad_rindex_tables(idx, S, device="cpu", **FORMS[form])
    prov = sharding.virtual_shards(t, S, "cpu")
    reads = edge_batch(lines, case)
    codes, lens = packed(reads)
    seed_np, ms = seed_tiers(idx, codes, lens)
    c, n = torch.from_numpy(codes), torch.from_numpy(lens)
    kw = torch_seeds(seed_np, ms, t.pos_dtype)
    got, stats = mems.find_mems_lockstep(prov.shards, prov.C, prov.n, c, n, MIN_LEN, MIN_OCC,
                                         capacity=CAPACITY, with_stats=True,
                                         super_base=prov.super_base,
                                         super_shift=prov.super_shift, **kw)
    # the iteration after which no read is active, stepping one at a time
    B = len(reads)
    state = mems.step_state(B, CAPACITY, t.pos_dtype, "cpu")
    ranks = torch.zeros((2 * B, 6), dtype=t.pos_dtype)
    padded, _ = mems._prepare(c, align=8)
    seeds = mems.resolve_seeds(B, L + 1, MIN_OCC, **kw)
    args = (prov.C, prov.n, padded, n, seeds, L, MIN_LEN, MIN_OCC, prov.super_base,
            prov.super_shift)
    done = 0
    if B:
        mems.mem_step_fused_plain(state, ranks, prov.shards, *args, apply=False)
        while True:
            done += 1
            if mems.mem_step_fused_plain(state, ranks, prov.shards, *args) == 0:
                break
    every = mems.ACTIVE_CHECK_EVERY
    assert stats["iters"] == -(-done // every) * every
    if case == "off-multiple":
        assert done % every != 0
    with jax.enable_x64(False):
        t_jax = jax_sharding.pad_rindex_tables(idx, S, **FORMS[form])
        jkw = {k: jnp.asarray(v) for k, v in seed_np.items()}
        for k in ("mer_table", "sdict_vals"):
            jkw[k] = jkw[k].astype(t_jax.pos_dtype)
        want = find_mems_impl(t_jax, jnp.asarray(codes), jnp.asarray(lens), MIN_LEN, MIN_OCC,
                              capacity=CAPACITY, **jkw, **ms)
    for f, g, w in zip(got._fields, got, want):
        assert g.shape == (B, CAPACITY) or g.shape == (B,), f
        np.testing.assert_array_equal(g.long().numpy(), np.asarray(w).astype(np.int64),
                                      err_msg=f)
