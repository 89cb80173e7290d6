"""The port's BWT build (ops/bwt.py on CPU tensors: the plain versions of the
sort, rerank and finish kernels; the rotation order kept from the last
round's sort), the .rl_bwt codec, the psi-walk r-index
build and the legacy .ri writer against the JAX package's, exactly: the
same lines, made with numpy from seeds, through the JAX function (on the
CPU) and the port's, and through the port's native SA-IS build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangenome_index_tpu.formats import ri as jri
from pangenome_index_tpu.formats import rlbwt as jrlbwt
from pangenome_index_tpu.models import rindex as jrindex
from pangenome_index_tpu.ops import bwt as jbwt
from pangenome_index_tpu_torch import native
from pangenome_index_tpu_torch.formats import ri, rlbwt
from pangenome_index_tpu_torch.models.rindex import build_rindex, build_rindex_from_sa
from pangenome_index_tpu_torch.ops import bwt
from pangenome_index_tpu_torch.utils import synth

INDEX_FIELDS = ("run_sym", "run_start", "run_len", "cum", "C", "samples",
                "last_sorted", "last_to_run")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def random_lines(rng, lengths, alphabet=ACGT):
    return [rng.choice(alphabet, int(n)).tobytes() for n in lengths]


def line_sets():
    """name -> lines, each made from a seed."""
    rng = np.random.default_rng(31)
    return {
        "synth": synth.synth_haplotypes(3000, 4, seed=1),
        # mixed lengths, length 1 among them
        "mixed": random_lines(rng, [1, 7, 1, 33, 2, 120, 1, 5, 64]),
        "identical": [b"ACGTTGCAAC"] * 2,
        "with-N": random_lines(rng, [40, 3, 25], np.frombuffer(b"ACGNT", np.uint8)),
        "one-line": random_lines(rng, [500]),
        # 300 separators: keys past 255, a sort of 9 bits at k = 0
        "300-short": random_lines(rng, rng.integers(1, 13, 300)),
    }


LINES = line_sets()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_rounds(keys, count=None):
    """The JAX package's ranks after its initial sort and after each of the
    first `count` doubling rounds (count None: every round its loop runs,
    up to the one whose max is n - 1), with each round's max."""
    n = keys.size
    with jax.enable_x64(False):
        kd = jnp.asarray(keys, jnp.int32)
        k_s, order0 = jax.lax.sort((kd, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
        rank = jbwt._rerank(order0, k_s, k_s, n)
        out = [(np.asarray(rank), int(rank.max()))]
        k = 1
        while (len(out) <= count if count is not None
               else len(out) == 1 or out[-1][1] != n - 1) and k < n:
            rank, mx = jbwt._doubling_round(rank, k, n)
            out.append((np.asarray(rank), int(mx)))
            k *= 2
    return out


@pytest.mark.parametrize("name", list(LINES))
def test_bwt_matches_jax_and_native(name):
    """bwt, da, sa_pos and seq_lengths equal the JAX function's (values and
    dtypes) and the native SA-IS build's (values; it hands int32 below
    2^31)."""
    lines = LINES[name]
    got = bwt.bwt_from_lines_device(lines, device="cpu")
    with jax.enable_x64(False):
        want = jbwt.bwt_from_lines_device(lines)
    nat = native.build_bwt_native(lines)
    for g, w, v in zip(got, want, nat):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, v)
    assert got[0].size == sum(len(l) + 1 for l in lines)


@pytest.mark.parametrize("name", list(LINES))
def test_rounds_match_jax(name):
    """The rank array and its max after the initial sort and each of the
    first three doubling rounds, through the wrappers (plain versions on the
    CPU) and through the plain round, equal the JAX _rerank / _doubling_round."""
    keys, _, _, top_key = bwt.text_keys(LINES[name])
    want = jax_rounds(keys, 3)
    assert len(want) == 4
    for round_fn in (bwt.doubling_round, bwt.doubling_round_plain):
        rank, top, _ = round_fn(torch.from_numpy(keys), 0, top_key.bit_length())
        got = [(rank.numpy(), int(top))]
        for k in (1, 2, 4):
            rank, top, _ = round_fn(rank, k, max(1, got[-1][1].bit_length()))
            got.append((rank.numpy(), int(top)))
        for (g, gm), (w, wm) in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
            assert gm == wm


@pytest.mark.parametrize("name", list(LINES))
def test_kept_payload_is_the_argsort_of_the_jax_ranks(name):
    """rotation_rank, through the wrappers (plain versions on the CPU) and
    through the plain round, ends on the JAX loop's last rank and top and
    keeps the last round's sort payload, which equals jnp.argsort of the
    JAX package's last ranks (_rerank, then _doubling_round until the max
    is n - 1): the rotation order, with no inverse formed."""
    keys, _, _, top_key = bwt.text_keys(LINES[name])
    n = keys.size
    rounds = jax_rounds(keys)
    last, last_max = rounds[-1]
    assert last_max == n - 1
    with jax.enable_x64(False):
        want = np.asarray(jnp.argsort(jnp.asarray(last)))
    for round_fn in (bwt.doubling_round, bwt.doubling_round_plain):
        rank, top, order = bwt.rotation_rank(torch.from_numpy(keys), top_key, round_fn)
        assert top == n - 1 and order.dtype == torch.int32
        np.testing.assert_array_equal(rank.numpy(), last)
        np.testing.assert_array_equal(order.numpy(), want)


def finish_case(lines):
    """(order, keys, line_starts) tensors of a line set, the order from the
    JAX rotation_order_device; and the JAX bwt_from_lines_device's arrays."""
    keys, starts, _, _ = bwt.text_keys(lines)
    with jax.enable_x64(False):
        order = np.asarray(jbwt.rotation_order_device(keys)).astype(np.int32)
        want = jbwt.bwt_from_lines_device(lines)
    return (torch.from_numpy(order), torch.from_numpy(keys), torch.from_numpy(starts)), want


#: the finish's edges (the card's cases in test_torch_cuda.py): one
#: character (a lone separator); lines of length 0 among others; 2100 lines
#: (a deep search of the line starts)
FINISH_EDGES = {"n-1": [b""], "empty-lines": [b"AC", b"", b"G", b"", b""],
                "many-lines": random_lines(np.random.default_rng(8),
                                           np.random.default_rng(9).integers(0, 4, 2100))}


@pytest.mark.parametrize("name", [*LINES, *FINISH_EDGES])
def test_finish_plain_matches_jax_read_off(name):
    """bwt_finish_plain(order, keys, line_starts), and the wrapper on CPU
    tensors, equal the JAX bwt_from_lines_device's read-off (bwt, da,
    sa_pos: values and dtypes) on every line set and at the finish's
    edges."""
    lines = LINES.get(name) or FINISH_EDGES[name]
    args, want = finish_case(lines)
    for fn in (bwt.bwt_finish_plain, bwt.bwt_finish):
        got = fn(*args)
        assert len(got) == 3
        for g, w in zip(got, want[:3]):
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(bwt.bwt_from_lines_device(lines, device="cpu")[0], want[0])


@pytest.mark.parametrize("keys", [
    [5], [1, 1], [2, 3, 2, 3, 2, 3], [7, 0, 7, 0, 7, 1], [3, 1, 2, 3, 1, 2, 3, 1, 2, 9]],
    ids=["one", "periodic-2", "periodic-6", "aperiodic", "past-n"])
def test_rotation_order_matches_jax(keys):
    """The rotation order of hand-made keys, periodic ones (rotations not
    all distinct: the stable argsort of the last ranks) among them."""
    keys = np.array(keys, np.int32)
    with jax.enable_x64(False):
        want = np.asarray(jbwt.rotation_order_device(keys))
    np.testing.assert_array_equal(bwt.rotation_order_device(keys, device="cpu"), want)
    np.testing.assert_array_equal(bwt.rotation_order_plain(keys), want)


def test_line_sets_rotation_order_plain():
    """rotation_order_plain on every line set equals the JAX order."""
    for lines in LINES.values():
        keys = bwt.text_keys(lines)[0]
        with jax.enable_x64(False):
            want = np.asarray(jbwt.rotation_order_device(keys))
        np.testing.assert_array_equal(bwt.rotation_order_plain(keys), want)


def test_sort_pairs_is_the_stable_sort_of_the_pair_keys():
    """The sort's keys and payload: key = rank[i] << bits | rank[(i + k) mod
    n] (k = 0: rank[i]), payload i, ties in index order; the passes count
    the key's significant bits at most 8 at a time, in digits as narrow as
    that many passes allow."""
    rng = np.random.default_rng(3)
    n = 1000
    rank = torch.from_numpy(rng.integers(0, 37, n).astype(np.int32))
    for k in (0, 1, 999):
        keys, order = bwt.bwt_sort_pairs(rank, k, 6)
        r = rank.numpy().astype(np.int64)
        want_keys = r if k == 0 else (r << 6) | np.roll(r, -k)
        want_order = np.argsort(want_keys, kind="stable")
        np.testing.assert_array_equal(order.numpy(), want_order)
        np.testing.assert_array_equal(keys.numpy(), want_keys[want_order])
        assert order.dtype == torch.int32 and keys.dtype == torch.int64
    widths = ((0, 7), (0, 9), (1, 4), (1, 5), (8, 25), (8, 31))
    assert [bwt.sort_passes(k, b) for k, b in widths] == [1, 2, 1, 2, 7, 8]
    assert [bwt.digit_bits(k, b) for k, b in widths] == [7, 5, 8, 5, 8, 8]


#: (k, bits) where the digit plan turns: one pass (a key of 8 bits or
#: fewer), the first width past it, a partial last digit, keys of 62 bits
DIGIT_EDGES = {"one-pass": (0, 8), "one-pass-pairs": (1, 4), "two-passes": (0, 9),
               "two-passes-pairs": (1, 5), "partial-last-digit": (1, 17),
               "k0-partial": (0, 23), "widest-k0": (0, 31), "widest-pairs": (5, 31)}


@pytest.mark.parametrize("k,bits", list(DIGIT_EDGES.values()), ids=list(DIGIT_EDGES))
def test_sort_pairs_at_the_digit_edges(k, bits):
    """The sort's contract (the stable order of the pair keys, with payload
    i) at the key widths where the digit plan changes, on ranks that use
    every bit (0 and 2^bits - 1 among them); the plan covers the key's bits
    in the fewest passes of at most MAX_DIGIT_BITS, its last digit the only
    partial one."""
    rng = np.random.default_rng(bits * 64 + k)
    n = 4 * bwt.TILE + 123
    r = rng.integers(0, 2**bits, n)
    r[:2] = (0, 2**bits - 1)
    r[rng.integers(0, n, n // 3)] = r[rng.integers(0, n, n // 3)]  # ties
    keys, order = bwt.bwt_sort_pairs(torch.from_numpy(r.astype(np.int32)), k, bits)
    want_keys = r if k == 0 else (r << bits) | np.roll(r, -k)
    want_order = np.argsort(want_keys, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(keys.numpy(), want_keys[want_order])
    key_bits = bits * (2 if k else 1)
    passes, width = bwt.sort_passes(k, bits), bwt.digit_bits(k, bits)
    assert width <= bwt.MAX_DIGIT_BITS and passes == -(-key_bits // bwt.MAX_DIGIT_BITS)
    assert (passes - 1) * width < key_bits <= passes * width


#: n at the rerank's edges (the card's cases in test_torch_cuda.py): one key;
#: 1024 groups of one destination and one past; a tile one below, at and one
#: above; 1024 groups of 1024 and one past
RERANK_N = [1, 2, 1023, 1024, 1025, 4095, 4096, 4097, 2**20 - 1, 2**20, 2**20 + 1]


@pytest.mark.parametrize("kind", ["equal", "distinct", "ties"])
@pytest.mark.parametrize("n", RERANK_N)
def test_rerank_plain_matches_jax(n, kind):
    """bwt_rerank_plain, and the wrapper on CPU tensors, against the JAX
    _rerank on sorted keys all equal, all distinct (past 2^32: the int64
    compare) and with ties, through a random order, the identity and its
    reverse. JAX compares the keys' dense codes at 32 bits: the same
    adjacent changes."""
    rng = np.random.default_rng(n)
    if kind == "equal":
        keys = np.full(n, 7, np.int64)
    elif kind == "distinct":
        keys = np.arange(n, dtype=np.int64) * 3 + (1 << 40)
    else:
        keys = np.sort(rng.integers(0, max(n // 4, 1), n)).astype(np.int64)
    codes = np.unique(keys, return_inverse=True)[1].astype(np.int32)
    for order in (rng.permutation(n), np.arange(n), np.arange(n)[::-1]):
        order = order.astype(np.int32)
        with jax.enable_x64(False):
            kj = jnp.asarray(codes)
            want = np.asarray(jbwt._rerank(jnp.asarray(order), kj, kj, n))
        k, o = torch.from_numpy(keys), torch.from_numpy(order)
        for fn in (bwt.bwt_rerank_plain, bwt.bwt_rerank):
            rank, top = fn(k, o)
            assert rank.dtype == torch.int32 and top.shape == (1,)
            np.testing.assert_array_equal(rank.numpy(), want)
            assert int(top) == int(want.max())


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 4097, 2**20 - 1, 2**20, 2**20 + 1,
                               5_000_011, 20_000_008, 2**31 - 2])
def test_rerank_groups_follow_their_definition(n):
    """The rerank's plan: groups of 2^shift destinations cover 0 .. n - 1 in
    at most 2^GROUP_BITS groups, with the least such shift (n = 20,000,008,
    the bench text: 611 groups of 32768)."""
    shift, groups = bwt.rerank_group_shift(n), bwt.rerank_groups(n)
    assert groups == -(-n // (1 << shift)) <= 1 << bwt.GROUP_BITS
    assert shift == 0 or -(-n // (1 << (shift - 1))) > 1 << bwt.GROUP_BITS
    assert (groups - 1) << shift < n <= groups << shift
    if n == 20_000_008:
        assert (shift, groups) == (15, 611)


def test_wrappers_refuse_bad_arguments():
    r = torch.zeros(8, dtype=torch.int32)
    for args in ((r.long(), 0, 3), (r, 8, 3), (r, -1, 3), (r, 1, 0), (r, 1, 32),
                 (r[:0], 0, 1)):
        with pytest.raises(ValueError):
            bwt.bwt_sort_pairs(*args)
    with pytest.raises(ValueError):
        bwt.bwt_rerank(r.long(), r[:4])
    with pytest.raises(ValueError):
        bwt.bwt_finish(r, r, torch.tensor([0, 4, 8, 9, 10, 11, 12, 13, 14, 15]))
    with pytest.raises(ValueError):  # order not int32
        bwt.bwt_finish(r.long(), r, torch.tensor([0, 8]))
    with pytest.raises(ValueError):  # keys not the order's shape
        bwt.bwt_finish(r, r[:4], torch.tensor([0, 8]))
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        bwt._check_n(2**31 - 1)
    bwt._check_n(2**31 - 2)
    with pytest.raises(ValueError, match="at least one line"):
        bwt.bwt_from_lines_device([], device="cpu")


def test_budget_is_checked_before_the_build(monkeypatch):
    """A build the device's free memory would not hold raises MemoryError
    with the sizes, before anything is allocated."""
    monkeypatch.setattr(bwt, "device_budget", lambda dev: 1000)
    with pytest.raises(MemoryError, match="characters need"):
        bwt.bwt_from_lines_device(LINES["synth"], device="cpu")


@pytest.mark.parametrize("name", list(LINES))
def test_build_rindex_matches_jax(name, tmp_path):
    """build_rindex of the .rl_bwt written and read back equals the JAX
    build_rindex of the JAX reader's records and the port's
    build_rindex_from_sa of the same BWT, array for array; both .ri writers
    give the JAX writers' bytes."""
    lines = LINES[name]
    b, da, sa_pos, seq_lengths = native.build_bwt_native(lines)
    rlbwt.write_rlbwt(tmp_path / "x.rl_bwt", rlbwt.rlbwt_from_text(b.tobytes()))
    rl = rlbwt.read_rlbwt(tmp_path / "x.rl_bwt")
    got = build_rindex(rl)
    want = jrindex.build_rindex(jrlbwt.read_rlbwt(tmp_path / "x.rl_bwt"))
    from_sa = build_rindex_from_sa(rl, da, sa_pos, seq_lengths)
    for f in INDEX_FIELDS:
        g = getattr(got, f)
        assert g.dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(g, getattr(want, f))
        np.testing.assert_array_equal(g, getattr(from_sa, f))
    assert (got.n, got.n_seq, got.max_len) == (want.n, want.n_seq, want.max_len)
    assert (got.n, got.n_seq, got.max_len) == (from_sa.n, from_sa.n_seq, from_sa.max_len)
    assert ri.serialize_legacy(got) == jri.serialize_legacy(want)
    assert ri.serialize_encoded(got) == jri.serialize_encoded(want)


@pytest.mark.parametrize("n,widths", [(45, (1, 1)), (3012, (1, 2))])
def test_rlbwt_file_matches_jax(tmp_path, n, widths):
    """write_rlbwt's bytes are the JAX writer's, with grlBWT's field widths
    (n = 45: one byte each; n = 3012: a two-byte frequency), and read_rlbwt
    reads them back."""
    rng = np.random.default_rng(n)
    lines = random_lines(rng, [(n - 3) // 3] * 3)
    b = native.build_bwt_native(lines)[0]
    assert b.size == n
    rl = rlbwt.rlbwt_from_text(b.tobytes())
    rlbwt.write_rlbwt(tmp_path / "port.rl_bwt", rl)
    jrlbwt.write_rlbwt(tmp_path / "jax.rl_bwt", jrlbwt.rlbwt_from_text(b.tobytes()))
    data = (tmp_path / "port.rl_bwt").read_bytes()
    assert data == (tmp_path / "jax.rl_bwt").read_bytes()
    assert tuple(np.frombuffer(data[:16], np.uint64)) == widths
    back = rlbwt.read_rlbwt(tmp_path / "port.rl_bwt")
    np.testing.assert_array_equal(back.syms, rl.syms)
    np.testing.assert_array_equal(back.freqs, rl.freqs)
    assert back.freqs.dtype == np.int64 and back.syms.dtype == np.uint8


def test_rlbwt_reader_refuses_truncated_files(tmp_path):
    (tmp_path / "short").write_bytes(b"\x01" * 7)
    with pytest.raises(ValueError, match="truncated"):
        rlbwt.read_rlbwt(tmp_path / "short")
    (tmp_path / "ragged").write_bytes(np.array([1, 2], np.uint64).tobytes() + b"\x00" * 4)
    with pytest.raises(ValueError, match="not a multiple"):
        rlbwt.read_rlbwt(tmp_path / "ragged")


def test_legacy_writer_with_runs_filling_their_blocks():
    """serialize_legacy when the runs fill whole blocks of 10 (the trailing
    empty block) and when they do not, against the JAX writer."""
    seen = set()
    for seed in range(40):
        lines = synth.synth_haplotypes(60, 2, snp_rate=0.05, seed=seed)
        b = native.build_bwt_native(lines)[0]
        rl = rlbwt.rlbwt_from_text(b.tobytes())
        got = build_rindex(rl)
        full = got.n_runs % 10 == 0
        if full in seen:
            continue
        seen.add(full)
        want = jrindex.build_rindex(jrlbwt.RLBWT(rl.syms, rl.freqs))
        assert ri.serialize_legacy(got) == jri.serialize_legacy(want)
        if len(seen) == 2:
            break
    assert seen == {False, True}


def test_build_rindex_refuses_bytes_outside_the_alphabet():
    rl = rlbwt.RLBWT(np.frombuffer(b"A\nX", np.uint8).copy(), np.array([2, 1, 1]))
    with pytest.raises(ValueError, match="outside"):
        build_rindex(rl)
    with pytest.raises(ValueError, match="no endmarkers"):
        build_rindex(rlbwt.RLBWT(np.frombuffer(b"AC", np.uint8).copy(), np.array([2, 1])))
