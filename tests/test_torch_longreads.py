"""Long reads through the serving path on the CPU: HiFi-like reads of 2,000
bases at 0.1% substitutions, every MEM kept (capacity 64), against the
benchmark's plain reference (benchmark/reference.py), which imports nothing
of the program; the long-read cell in miniature (benchmark.tiny) comes out
correct, and the readers of K3's counters read its recorded calls."""

import numpy as np
import pytest
import torch

from benchmark import data, reference, run, tiny
from benchmark.metrics import _spans
from pangenome_index_tpu_torch import serve
from pangenome_index_tpu_torch.ops.mems import find_mems, unpack_start_end
from pangenome_index_tpu_torch.ops.tagquery import query_mem_tags

#: the long-read configuration in miniature: pg450m-hifi's settings over 3
#: haplotypes of 4,000 bases (and tiny's small seed tiers)
CONFIG = {"base_len": 4000}
MIX = {"read_len": 2000, "error_rate": 0.001, "reads_per_call": 4, "pool_batches": 2,
       "traced_calls": 2, "checked_reads_per_call": 2}
READERS = ("mems.k3_lane_fill", "mems.k3_us_per_chain_step")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The plain version's tensors are small: intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"), base="pg450m-hifi",
                          config=CONFIG, mix=MIX)


@pytest.fixture(scope="module")
def served(root):
    """(configuration, lines, the reads' codes and lengths, a prepared
    batch of them) of the miniature cell, seeded."""
    _, cfg, _ = run.cell_files(run.load_benchmark(root), tiny.TINY_CELL, root)
    lines = data.sequences(cfg, 2**33 + 7)
    idx, tags = data.index(cfg, lines, "cpu")
    codes, lens = data.reads(lines, 6, MIX["read_len"], MIX["error_rate"],
                             data.rng(2**33 + 7, 1, 0))
    batch = serve.prepare(idx, tags, codes, lens, "cpu", rank_mode=cfg["rank_mode"],
                          min_occ=cfg["min_occ"], mer_m=cfg["mer_m"], sdict_s=cfg["sdict_s"])
    return cfg, lines, codes, lens, batch


def test_the_miniature_config_is_the_long_read_one(root):
    _, cfg, mix = run.cell_files(run.load_benchmark(root), tiny.TINY_CELL, root)
    assert (cfg["capacity"], cfg["strands"], mix["read_len"]) == (64, 2, 2000)


def test_find_mems_and_tags_match_the_reference(served):
    """find_mems then query_mem_tags on seeded reads of 2,000 bases equal
    reference.answers: every count, every kept MEM (all of them: no read
    passes the capacity) and its tag counts."""
    cfg, lines, codes, lens, batch = served
    res = find_mems(batch.tables, batch.codes, batch.lengths, cfg["min_len"], cfg["min_occ"],
                    capacity=cfg["capacity"], **batch.seed_kw)
    nu, ov = query_mem_tags(batch.tag_tables, res.bwt_start, res.size, res.count,
                            capacity=cfg["tag_capacity"])
    fmd = reference.fmd_index(lines, "cpu")
    want = reference.answers(
        fmd, torch.from_numpy(codes), torch.from_numpy(lens), min_len=cfg["min_len"],
        min_occ=cfg["min_occ"], capacity=cfg["capacity"], tag_capacity=cfg["tag_capacity"],
        tags=reference.tag_runs(fmd, cfg["node_len"], cfg["copies"]), copies=cfg["copies"])
    count, slots, want_nu, want_ov = (a.numpy() for a in want)
    assert 0 < count.max() <= cfg["capacity"]
    np.testing.assert_array_equal(res.count.numpy(), count)
    got = np.stack([res.start, res.end, res.bwt_start, res.size], axis=2)
    np.testing.assert_array_equal(got, slots)
    np.testing.assert_array_equal(nu.numpy(), want_nu)
    np.testing.assert_array_equal(ov.numpy(), want_ov.astype(ov.numpy().dtype))


def test_the_readers_on_recorded_long_read_calls(served):
    """The readers of K3's counters over two recorded calls: a full lane
    fill on the CPU (the plain version's lockstep advances every read at
    once), a step time; and the counters' steps a kilobase near one a base
    (the forward extension covers nearly every base of a read with few
    errors)."""
    cfg, _, _, lens, batch = served
    readings = {"traced_calls": 2}
    run_kw = dict(min_len=cfg["min_len"], min_occ=cfg["min_occ"], capacity=cfg["capacity"],
                  tag_capacity=cfg["tag_capacity"])
    got = {}
    for name in READERS:
        reader = run.load_reader(name)
        reader.probe(readings, [batch], run_kw)
        got[name] = reader.read(readings)
    assert len(readings["spans"]) == 2
    for call in readings["spans"]:
        assert call["counters"]["mems.k3.lanes"] == len(lens)
        assert call["counters"]["mems.k3.bases"] == int(lens.sum())
        assert call["counters"]["mems.k3.resident_lanes"] == len(lens)
        assert 900 < 1000 * call["counters"]["mems.k3.steps"] / int(lens.sum()) < 1200
        assert len(_spans.named(call, "mems.k3")) == 1
    assert got["mems.k3_lane_fill"] == 100.0
    assert got["mems.k3_us_per_chain_step"] > 0


def test_the_long_read_cell_is_correct(root, tmp_path):
    line, _ = run.run_cell(tiny.TINY_CELL, 2**40 + 3, 0.2, False, device="cpu", root=root,
                           work_dir=tmp_path)
    assert line["correct"] and line["attempted"] >= MIX["reads_per_call"]
    assert {k: v["value"] for k, v in line["compared"].items()} == {k: 0 for k in run.LIMITS}
    assert line["checked_reads"] >= MIX["reads_per_call"]


def test_a_traced_long_read_run_reads_its_metrics(tmp_path):
    """A traced run of the miniature long-read cell, at one call of two
    reads of 300 bases traced, reads every per-layer metric that lists it
    but the rooflines, which read device time. The window of 4 s holds
    calls of a fraction of a second each even on a busy host."""
    root = tiny.make_root(tmp_path / "checkout", base="pg450m-hifi", config=CONFIG,
                          mix={**MIX, "read_len": 300, "reads_per_call": 2, "pool_batches": 1,
                               "traced_calls": 1, "checked_reads_per_call": 1})
    line, _ = run.run_cell(tiny.TINY_CELL, 2**41 + 5, 4.0, True, device="cpu", root=root,
                           work_dir=tmp_path)
    assert line["correct"]
    want = {m["name"] for m in run.metrics_of(run.load_benchmark(root), "per_layer",
                                              tiny.TINY_CELL)}
    assert {"mems.k3_lane_fill", "mems.steps_per_read", "seeds.dict_hit_rate"} <= want
    assert want - set(line["metrics"]) == {"find_mems_roofline", "query_mem_tags_roofline"}
    assert line["metrics"]["mems.k3_lane_fill"]["value"] == 100.0


@pytest.mark.parametrize("start, end", [(0, 20), (32_767, 32_800), (32_768, 40_000),
                                        (65_514, 65_534)])
def test_start_and_end_unpack_unsigned(start, end):
    """(start << 16) | end as the kernels write it, in an int32 whose sign
    bit a start past 32767 sets, unpacks to the start and end themselves at
    both position dtypes: the engine serves reads up to 65,534 bases."""
    packed = (start << 16) | end
    se = torch.tensor([[packed - 2**32 if packed >= 2**31 else packed]], dtype=torch.int32)
    for pd in (torch.int32, torch.int64):
        s, e = unpack_start_end(se, pd)
        assert (int(s), int(e), s.dtype, e.dtype) == (start, end, pd, pd)
