"""The plain reference against the program's host model and the textbook
MEMs, and the byte counts of the roofline bounds. (The reference imports
nothing of the program; these tests compare it with the program.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import data, reference
from benchmark.metrics import _bounds

CFG = {"base_len": 3000, "haplotypes": 3, "snp_rate": 0.002, "strands": 2,
       "copies": 1, "node_len": 512}


@pytest.fixture(scope="module")
def world():
    from pangenome_index_tpu_torch import build_index
    from pangenome_index_tpu_torch.models.tagarray import TagArray

    lines = data.sequences(CFG, 13)
    idx = build_index(lines, keep_sa=True)
    tags = TagArray.from_runs(*data.tag_runs(idx.sa_pos, idx.n_seq, 512))
    fmd = reference.fmd_index(lines, "cpu")
    return lines, idx, tags, fmd


def test_suffix_order_and_bwt_are_the_native_builds(world):
    lines, idx, _, fmd = world
    # the BWT's runs, read off the reference's own suffix order
    bwt = fmd.text.codes[(fmd.sa - 1) % fmd.n].numpy()
    cut = np.flatnonzero(bwt[1:] != bwt[:-1]) + 1
    heads = np.concatenate(([0], cut))
    # the native index splits endmarker runs into unit runs
    syms = bwt[heads]
    ends = np.concatenate((cut, [bwt.size]))
    runs = np.concatenate([np.arange(h, e) if s == 0 else [h]
                           for h, e, s in zip(heads, ends, syms)])
    assert np.array_equal(runs, idx.run_start)
    assert np.array_equal(fmd.C.numpy(), idx.C[:6])
    assert np.array_equal(fmd.sa.numpy(), np.asarray(idx.sa_pos, np.int64)
                          + data_starts(lines)[np.asarray(idx.sa_seq)])


def data_starts(lines):
    return np.concatenate(([0], np.cumsum([len(s) + 1 for s in lines])[:-1]))


def test_mems_are_the_host_models_and_the_textbook_ones(world):
    from pangenome_index_tpu_torch.models.mems import find_all_mems
    from pangenome_index_tpu_torch.models.oracle import brute_force_mems

    lines, idx, _, fmd = world
    codes, lens = data.reads(lines, 60, 70, 0.03, data.rng(13, 1, 0))
    lens[::7] = 45                      # shorter reads: the sentinel inside the row
    codes[::7, 45:] = 0
    cnt, slots = reference.mems(fmd, torch.from_numpy(codes), torch.from_numpy(lens), 20, 1, 4)
    assert int(cnt.sum()) > 60
    for i in range(len(codes)):
        read = bytes(b"\nACGNT"[c] for c in codes[i, : lens[i]])
        want = find_all_mems(idx, read, 20, 1)
        assert int(cnt[i]) == len(want)
        got = slots[i, : min(len(want), 4)].tolist()
        assert got == [[m.start, m.end, m.bwt_start, m.size] for m in want[:4]]
        if i < 12:
            assert [(m.start, m.end, m.size) for m in want] == \
                [tuple(b) for b in brute_force_mems(lines, read, 20, 1)]


def test_tag_counts_are_the_program_plain_k4(world):
    from pangenome_index_tpu_torch.ops.tables import tags_to_device
    from pangenome_index_tpu_torch.ops.tagquery import query_mem_tags_plain

    lines, idx, tags, fmd = world
    codes, lens = data.reads(lines, 80, 70, 0.02, data.rng(13, 1, 1))
    cnt, slots = reference.mems(fmd, torch.from_numpy(codes), torch.from_numpy(lens), 20, 1, 4)
    for copies in (1, 3):
        vals, heads = reference.tag_runs(fmd, 512, copies)
        sl = slots.clone()
        sl[..., 2:] *= copies
        nu, ov = reference.tag_counts(vals, heads, cnt, sl, 4, 8)
        if copies == 1:
            tt_tags = tags
        else:
            from pangenome_index_tpu_torch.models.tagarray import TagArray
            tt_tags = TagArray.from_runs(tags.pos_enc, tags.run_lengths() * copies)
        assert np.array_equal(vals.numpy(), tt_tags.pos_enc)
        assert np.array_equal(heads.numpy(), tt_tags.bwt_start)
        tt = tags_to_device(tt_tags, "cpu")
        pnu, pov = query_mem_tags_plain(tt, sl[..., 2], sl[..., 3], cnt.int(), 8)
        assert torch.equal(nu, pnu.long()) and torch.equal(ov, pov)
        assert int(nu.sum()) > 0


def test_without_step_3_some_mems_are_lost():
    lines = data.sequences({**CFG, "haplotypes": 8, "snp_rate": 0.05}, 13)
    fmd = reference.fmd_index(lines, "cpu")
    codes, lens = data.reads(lines, 400, 60, 0.05, data.rng(13, 1, 2))
    args = (fmd, torch.from_numpy(codes), torch.from_numpy(lens), 20, 1, 8)
    cnt, slots = reference.mems(*args)
    cnt2, slots2 = reference.mems(*args, rescan=False)
    assert bool((cnt2 <= cnt).all()) and bool((cnt2 < cnt).any())


def test_split_runs_at_the_edges():
    v, l = reference.split_runs(torch.tensor([7, 8, 9, 10]), torch.tensor([1, 511, 512, 1533]))
    assert v.tolist() == [7, 8, 9, 9, 10, 10, 10]
    assert l.tolist() == [1, 511, 511, 1, 511, 511, 511]


def test_byte_counts():
    # 2 reads of 150 bases, 8 slots, 10 runs, int32 positions
    assert _bounds.mems_bytes(2, 150, 8, 10, 4) == 2 * 150 + 2 * (4 + 8 * 16) + 10 * 5
    assert _bounds.mems_bytes(1, 150, 8, 10, 8) == 150 + 4 + 8 * 24 + 10 * 9
    assert _bounds.tags_bytes(2, 8, 10, 4) == 2 * (4 + 8 * 8) + 2 * 8 * 5 + 10 * 12
    assert _bounds.tags_bytes(1, 8, 10, 8) == 4 + 8 * 16 + 8 * 5 + 10 * 16
    assert _bounds.share(3.35e12, 2.0) == pytest.approx(50.0)
    assert _bounds.share(1.0, 0.0) is None
