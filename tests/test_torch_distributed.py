"""The port's multi-card path in real process groups on the CPU (gloo), held
against the JAX package on the 8-virtual-device CPU mesh: the distributed
MEM and serving steps on meshes 1x1, 2x1, 1x2 and 2x2 (at most 4
processes) in the checkpoint, two-level and run-table forms, with and
without both seed tiers, equal to JAX's make_distributed_mem_step /
make_distributed_serving_step on make_mesh of the same shape, and the
model group's distributed rank6 equal to JAX's rank6; the cross-card
merge on 1, 2 and 4 ranks equal to JAX's merge_tags_device on
make_mesh(d, 8 // d); init_distributed joining through COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID in two processes. Groups are spawned over a
FileStore under tmp_path (no TCP port, but for the coordinator case), each
joined within its own time limit and killed past it, with collectives that
time out: a hang fails a test and cannot stop the suite. All outputs are
integers: the tolerance is 0."""

import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as worker
from pangenome_index_tpu.ops.rank import rank6 as jax_rank6
from pangenome_index_tpu.ops.tables import tags_to_device as jax_tags_to_device
from pangenome_index_tpu.parallel import engine as jax_engine
from pangenome_index_tpu.parallel import merge as jax_merge
from pangenome_index_tpu.parallel import sharding as jax_sharding
from pangenome_index_tpu_torch.parallel.multihost import spawn_group

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
#: seconds a spawned group may take before its ranks are killed
JOIN = 150


@pytest.fixture(autouse=True)
def short_collectives(monkeypatch):
    """A rank stuck in a collective fails within a minute."""
    monkeypatch.setenv("PANIDX_DIST_TIMEOUT", "60")


@pytest.fixture(scope="module")
def workload():
    return worker.workload()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The steps' outputs of every rank, per mesh shape (one group each)."""
    out = {}

    def get(shape):
        if shape not in out:
            d = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
            spawn_group(worker.engine_rank, shape[0] * shape[1], (*shape, str(d)),
                        device="cpu", join_seconds=JOIN)
            out[shape] = d
        return out[shape]

    return get


@pytest.fixture(scope="module")
def jax_steps(workload):
    """JAX's serving and MEM steps' outputs per (mesh, form, tiers)."""
    idx, tags, codes, lens, seeds = workload
    cache = {}

    def get(shape, form, tiers):
        key = (shape, form, tiers)
        if key not in cache:
            with jax.enable_x64(False):
                mesh = jax_sharding.make_mesh(*shape)
                t = jax_sharding.pad_rindex_tables(idx, shape[1], **worker.FORMS[form])
                pd = t.pos_dtype
                ms, seed = {}, ()
                if tiers == "both":
                    ms = dict(mer_m=worker.MER_M, sdict_m=worker.SDICT_S)
                    seed = (jnp.asarray(seeds["mer_table"], pd), jnp.asarray(seeds["mer_keys"]),
                            jnp.asarray(seeds["mer_valid"]),
                            jnp.asarray(seeds["sdict_vals"], pd),
                            jnp.asarray(seeds["sdict_idx"]))
                args = (jnp.asarray(codes), jnp.asarray(lens),
                        jnp.asarray(worker.MIN_LEN, pd), jnp.asarray(worker.MIN_OCC, pd),
                        *seed)
                serve = jax_engine.make_distributed_serving_step(
                    mesh, capacity=worker.CAPACITY, tag_capacity=worker.TAG_CAPACITY,
                    tables=t, **ms)
                mem = jax_engine.make_distributed_mem_step(mesh, capacity=worker.CAPACITY,
                                                          tables=t, **ms)
                with mesh:
                    res, tq, total = serve(t, jax_tags_to_device(tags), *args)
                    res2, total2 = mem(t, *args)
                cache[key] = ({f: np.asarray(getattr(res, f)) for f in res._fields},
                              {f: np.asarray(getattr(tq, f)) for f in tq._fields},
                              int(total),
                              {f: np.asarray(getattr(res2, f)) for f in res2._fields},
                              int(total2))
        return cache[key]

    return get


@pytest.mark.parametrize("tiers", worker.TIERS)
@pytest.mark.parametrize("form", list(worker.FORMS))
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_distributed_steps_match_jax(served, jax_steps, shape, form, tiers):
    """Every rank's MemResult and TagQueryResult are JAX's rows of its data
    slice (model peers alike), and the totals JAX's total."""
    d_size, m_size = shape
    d = served(shape)
    want_res, want_tq, want_total, want_res2, want_total2 = jax_steps(shape, form, tiers)
    B = len(want_res["count"])
    b = B // d_size
    for rank in range(d_size * m_size):
        got = np.load(d / f"{form}-{tiers}-{rank}.npz")
        rows = slice((rank // m_size) * b, (rank // m_size + 1) * b)
        for f, w in want_res.items():
            np.testing.assert_array_equal(got[f"mem_{f}"], w[rows], err_msg=f)
            np.testing.assert_array_equal(got[f"mem2_{f}"], want_res2[f][rows], err_msg=f)
        for f, w in want_tq.items():
            np.testing.assert_array_equal(got[f"tq_{f}"], w[rows], err_msg=f)
        assert int(got["total"]) == want_total == int(got["total2"]) == want_total2
    assert want_total > B


@pytest.mark.parametrize("form", list(worker.FORMS))
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_distributed_rank6_over_the_model_group(served, workload, shape, form):
    """distributed_ckpt_rank6 / distributed_rank6 on every rank (its shard,
    one all_reduce over its model group) give the whole index's rank6,
    equal to JAX's rank6 on the same padded tables."""
    idx = workload[0]
    d = served(shape)
    with jax.enable_x64(False):
        t = jax_sharding.pad_rindex_tables(idx, shape[1], **worker.FORMS[form])
        want = np.asarray(jax_rank6(t, jnp.asarray(worker.rank_positions(idx), t.pos_dtype)))
    for rank in range(shape[0] * shape[1]):
        np.testing.assert_array_equal(np.load(d / f"{form}-rank6-{rank}.npy"),
                                      want.astype(np.int64))


def merge_case(rng, C):
    """Rows of C components (ids spread, some rows outside any stream) and
    the components' streams, each as long as its rows."""
    ids = np.sort(rng.choice(10 * C + 10, C, replace=False)).astype(np.int64)
    cpr = np.where(rng.random(2001) < 0.05, -1, ids[rng.integers(0, C, 2001)])
    streams = {int(c): rng.integers(0, 1 << 30, int((cpr == c).sum())).astype(np.int64)
               for c in ids}
    return cpr, streams


@pytest.fixture(scope="module")
def merge_cases():
    rng = np.random.default_rng(31)
    return {f"C{C}": merge_case(rng, C) for C in (3, 300)}


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_cross_card_merge_matches_jax(tmp_path, merge_cases, shards):
    """Every rank of a data mesh of `shards` ranks gathers JAX's
    merge_tags_device tags on make_mesh(shards, 8 // shards), C = 3 and 300."""
    spawn_group(worker.merge_rank, shards, (merge_cases, str(tmp_path)),
                device="cpu", join_seconds=JOIN)
    for name, (cpr, streams) in merge_cases.items():
        with jax.enable_x64(False):
            want = jax_merge.merge_tags_device(jax_sharding.make_mesh(shards, 8 // shards),
                                               cpr, streams)
        for rank in range(shards):
            np.testing.assert_array_equal(np.load(tmp_path / f"{name}-{rank}.npy"),
                                          want.astype(np.int64))


def test_init_distributed_joins_through_the_coordinator(tmp_path):
    """Two processes join through COORDINATOR_ADDRESS, NUM_PROCESSES and
    PROCESS_ID (a local TCP port) and sum over the group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.coordinator_rank,
                         args=(r, f"127.0.0.1:{port}", 2, str(tmp_path / f"{r}.txt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN)
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        assert (tmp_path / f"{r}.txt").read_text() == "2 3"
