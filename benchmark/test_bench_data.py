"""The generators: deterministic for a seed, the reads distributed as the
port's synth_reads, the tag array and the k-copy index as the originals."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import data

CFG = {"base_len": 4000, "haplotypes": 3, "snp_rate": 0.002, "strands": 2,
       "copies": 1, "node_len": 512}


def test_same_seed_same_inputs_and_a_large_seed():
    big = 2**31 + 987654321
    a, b, c = (data.sequences(CFG, s) for s in (big, big, big + 1))
    assert a == b and a != c
    ra = data.reads(a, 200, 50, 0.05, data.rng(big, 1, 0))
    rb = data.reads(a, 200, 50, 0.05, data.rng(big, 1, 0))
    rc = data.reads(a, 200, 50, 0.05, data.rng(big, 1, 1))
    assert all(np.array_equal(x, y) for x, y in zip(ra, rb))
    assert not np.array_equal(ra[0], rc[0])
    assert np.array_equal(data.rng(-3).integers(0, 10**9, 4), data.rng(-3).integers(0, 10**9, 4))


def test_sequences_are_haplotypes_and_their_reverse_complements():
    from pangenome_index_tpu_torch.utils.synth import synth_haplotypes

    seqs = data.sequences(CFG, 11)
    haps = data.haplotypes(4000, 3, 0.002, data.rng(11, 0))
    assert seqs[0::2] == haps and len(seqs) == 6
    assert all(rc == h.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
               for h, rc in zip(seqs[0::2], seqs[1::2]))
    # the frozen copy gives synth_haplotypes' values for the same generator
    assert data.haplotypes(4000, 3, 0.002, np.random.default_rng(5)) == \
        synth_haplotypes(4000, 3, 0.002, seed=5)
    assert data.sequences({**CFG, "strands": 1}, 11) == haps


def _mismatches(lines, codes):
    """Per read: the fewest mismatches against any placement in any line."""
    text = [data.BYTE_CODE[np.frombuffer(s, np.uint8)] for s in lines]
    L = codes.shape[1]
    best = []
    for r in codes:
        m = min(int((np.lib.stride_tricks.sliding_window_view(t, L) != r).sum(1).min())
                for t in text)
        best.append(m)
    return np.array(best)


def test_reads_follow_synth_reads_distribution():
    """Both generators' reads are substrings of the sequences with
    substitutions: the mean number of mismatches a read (the error rate
    times 3/4, since a substitution may draw the same base) and its spread
    agree within sampling error, and reads come from every sequence."""
    from pangenome_index_tpu_torch.utils.synth import synth_reads

    lines = data.sequences(CFG, 3)
    n, L, rate = 400, 40, 0.05
    codes, lens = data.reads(lines, n, L, rate, data.rng(3, 1, 0))
    assert codes.shape == (n, L) and codes.dtype == np.int32 and (lens == L).all()
    assert set(np.unique(codes)) <= {1, 2, 3, 5}
    theirs = synth_reads(lines, n, L, rate, seed=4)
    their_codes = data.BYTE_CODE[np.frombuffer(b"".join(theirs), np.uint8)].reshape(n, L)
    ours, them = _mismatches(lines, codes), _mismatches(lines, their_codes)
    expect = L * rate * 0.75
    sd = np.sqrt(L * rate * 0.75 * (1 - rate * 0.75) / n)
    for got in (ours, them):
        assert abs(got.mean() - expect) < 5 * sd + 0.05
    assert abs(ours.var() - them.var()) < 0.5


def test_reads_need_longer_sequences():
    with pytest.raises(ValueError):
        data.reads([b"ACGT" * 10], 4, 40, 0.01, data.rng(0))


def test_tag_runs_are_synth_tag_arrays():
    from pangenome_index_tpu_torch import build_index
    from pangenome_index_tpu_torch.models.tagarray import TagArray
    from pangenome_index_tpu_torch.utils.synth import synth_tag_array

    lines = data.sequences(CFG, 7)
    idx = build_index(lines, keep_sa=True)
    vals, lens = data.tag_runs(idx.sa_pos, idx.n_seq, 512)
    want = synth_tag_array(build_index(lines, keep_sa=False), node_len=512)
    got = TagArray.from_runs(vals, lens)
    assert np.array_equal(got.pos_enc, want.pos_enc)
    assert np.array_equal(got.bwt_start, want.bwt_start) and got.total == want.total


def test_k_copy_index_is_the_native_build_of_the_repeated_lines():
    from pangenome_index_tpu_torch import build_index
    from pangenome_index_tpu_torch.models.tagarray import TagArray

    lines = data.sequences({**CFG, "base_len": 600, "haplotypes": 2}, 9)
    k = 3
    idx = build_index(lines, keep_sa=True)
    tags = TagArray.from_runs(*data.tag_runs(idx.sa_pos, idx.n_seq, 512))
    big, big_tags = data.k_copy_index(idx, tags, k)
    want = build_index([s for s in lines for _ in range(k)], keep_sa=False)
    for f in ("run_sym", "run_start", "run_len", "cum", "C", "samples", "last_sorted",
              "last_to_run"):
        assert np.array_equal(np.asarray(getattr(big, f)), np.asarray(getattr(want, f))), f
    assert (big.n, big.n_seq, big.max_len) == (want.n, want.n_seq, want.max_len)
    assert big_tags.total == want.n


def test_index_is_the_native_build():
    """The index the benchmark builds (the program's device BWT build, here
    its plain version) is the native SA-IS build's, its tag array that of
    the native suffix array, and the k-copy index is made from it."""
    from pangenome_index_tpu_torch import build_index
    from pangenome_index_tpu_torch.models.tagarray import TagArray

    cfg = {**CFG, "base_len": 800, "repeats": REPEATS}
    lines = data.sequences(cfg, 21)
    idx, tags = data.index(cfg, lines, "cpu")
    want = build_index(lines, keep_sa=True)
    want_tags = TagArray.from_runs(*data.tag_runs(want.sa_pos, want.n_seq, 512))
    for f in ("run_sym", "run_start", "run_len", "cum", "C", "samples", "last_sorted",
              "last_to_run"):
        assert np.array_equal(np.asarray(getattr(idx, f)), np.asarray(getattr(want, f))), f
    assert (idx.n, idx.n_seq, idx.max_len) == (want.n, want.n_seq, want.max_len)
    assert np.array_equal(tags.pos_enc, want_tags.pos_enc)
    assert np.array_equal(tags.bwt_start, want_tags.bwt_start)
    big, _ = data.index({**cfg, "copies": 2}, lines, "cpu")
    assert big.n == 2 * idx.n


REPEATS = {"share": 0.2, "length": 50, "families": 2, "divergence": 0.02}


def test_repeats_are_copies_of_their_families():
    """With repeats, `share` of the base is copies of the families'
    consensus at `divergence`; without, the values are synth_haplotypes'."""
    gen = np.random.default_rng(8)
    base = data.ALPHABET[gen.integers(0, 4, 10000)]
    before = base.copy()
    data.add_repeats(base, np.random.default_rng(9), share=0.2, length=50, families=2,
                     divergence=0.02)
    blocks = base.reshape(200, 50)
    changed = (blocks != before.reshape(200, 50)).any(axis=1)
    assert changed.sum() == 40
    copies = blocks[changed]
    # each copy is within a few substitutions of one of two consensus sequences
    near = (copies[:, None, :] != copies[None, :, :]).sum(axis=2) < 15
    groups = {tuple(np.flatnonzero(row)) for row in near}
    assert len(groups) <= 2 + 4   # two families, a few copies on the edge
    assert near.sum(axis=1).min() >= 2
    same = data.haplotypes(4000, 3, 0.002, np.random.default_rng(5), None)
    assert same == data.haplotypes(4000, 3, 0.002, np.random.default_rng(5))
    assert data.sequences({**CFG, "repeats": REPEATS}, 4) != data.sequences(CFG, 4)
