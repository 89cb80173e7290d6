"""The benchmark's inputs, made from --seed: the pangenome's sequences, the
r-index and tag array built over them (the BWT by the program's own build
on the device, as loading an index would stand there), the k-copy index
past 2^31 rows, and the reads.

Frozen copies, each kept here so that later changes to the program cannot
move the yardstick:
- `haplotypes`: pangenome_index_tpu_torch/utils/synth.py:synth_haplotypes
  (same values for the same generator state), taking a numpy Generator;
  the repeat families (`add_repeats`) are this benchmark's own.
- `reads`: synth.py:synth_reads, vectorised. synth_reads draws a
  Binomial(read_len, error_rate) count of distinct uniform positions a read;
  here every position errs alone with probability error_rate, which is the
  same distribution (count and positions), drawn in a few array calls.
  The substituted base is uniform over ACGT, as there (a quarter of the
  errors keep the base).
- `tag_runs`: synth.py:synth_tag_array's encoding (a backbone node every
  512 bases of a sequence, the offset in the low bits, tag 0 on the
  endmarker rows), read off the build's suffix offsets instead of a psi
  walk.
- `k_copy_index`: chip_smoke.py:k_copy_index, the index of the text in
  which each sequence is repeated k times in a row.

Every sequence is stored with its reverse complement, as the reference
pipeline indexes both orientations of each haplotype path: the FMD forward
extension that MEM finding uses is exact only on such a text.
"""

from __future__ import annotations

import numpy as np

#: ACGT in byte order, and their alphabet codes ({'\n', A, C, G, N, T})
ALPHABET = np.frombuffer(b"ACGT", np.uint8)
BASE_CODES = np.array([1, 2, 3, 5], np.int32)
#: byte -> alphabet code, for the four bases (everything else is 0)
BYTE_CODE = np.zeros(256, np.int32)
BYTE_CODE[ALPHABET] = BASE_CODES
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def seed_sequence(seed: int, *stream: int) -> np.random.SeedSequence:
    """The generator state of one stream of a run: any whole number is a
    seed (taken modulo 2^64), each stream independent."""
    return np.random.SeedSequence([int(seed) % 2**64, *stream])


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_sequence(seed, *stream))


def haplotypes(base_len: int, n_haps: int, snp_rate: float,
               gen: np.random.Generator, repeats: dict | None = None) -> list[bytes]:
    """A random base sequence and n_haps copies of it, each with its own
    substitutions at snp_rate (synth_haplotypes). With `repeats`, the base
    first receives copies of a few repeat families (`add_repeats`); without,
    the values are synth_haplotypes' for the same generator state."""
    base = ALPHABET[gen.integers(0, 4, base_len)]
    if repeats:
        add_repeats(base, gen, **repeats)
    lines = []
    for _ in range(n_haps):
        hap = base.copy()
        n_mut = gen.binomial(base_len, snp_rate)
        pos = gen.choice(base_len, size=n_mut, replace=False)
        hap[pos] = ALPHABET[(np.searchsorted(ALPHABET, hap[pos])
                             + gen.integers(1, 4, n_mut)) % 4]
        lines.append(hap.tobytes())
    return lines


def add_repeats(base: np.ndarray, gen: np.random.Generator, *, share: float,
                length: int, families: int, divergence: float) -> None:
    """Overwrite `share` of the base (bytes of ACGT, in place) with copies of
    `families` random consensus sequences of `length` bases, each copy at a
    distinct slot of `length` bases and each of its bases substituted with
    probability `divergence`: interspersed repeats, so that a read's MEMs
    occur at several loci, their intervals span tag runs of several graph
    nodes and some overflow the tag query's capacity."""
    slots = base.size // length
    n_copies = min(slots, int(round(share * base.size / length)))
    consensus = ALPHABET[gen.integers(0, 4, (families, length))]
    copies = consensus[gen.integers(0, families, n_copies)]
    hit = gen.random(copies.shape) < divergence
    copies[hit] = ALPHABET[(np.searchsorted(ALPHABET, copies[hit])
                            + gen.integers(1, 4, int(hit.sum()))) % 4]
    at = gen.choice(slots, size=n_copies, replace=False)
    base[: slots * length].reshape(slots, length)[at] = copies


def reverse_complement(line: bytes) -> bytes:
    return line.translate(_COMPLEMENT)[::-1]


def sequences(cfg: dict, seed: int) -> list[bytes]:
    """The text's sequences: each haplotype, followed by its reverse
    complement where the configuration stores both strands."""
    haps = haplotypes(cfg["base_len"], cfg["haplotypes"], cfg["snp_rate"],
                      rng(seed, 0), cfg.get("repeats"))
    if cfg["strands"] == 1:
        return haps
    return [s for h in haps for s in (h, reverse_complement(h))]


def reads(lines: list[bytes], n_reads: int, read_len: int, error_rate: float,
          gen: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """n_reads substrings of read_len of uniformly drawn sequences, each base
    substituted by a uniform base with probability error_rate (synth_reads'
    distribution). Returns (codes [n_reads, read_len] int32, lengths
    [n_reads] int32)."""
    lens = np.array([len(s) for s in lines], np.int64)
    if lens.min() <= read_len:
        raise ValueError(f"reads of {read_len} need sequences longer than that")
    first = np.concatenate(([0], np.cumsum(lens)[:-1]))
    text = np.frombuffer(b"".join(lines), np.uint8)
    which = gen.integers(0, len(lines), n_reads)
    start = first[which] + gen.integers(0, lens[which] - read_len)
    out = text[start[:, None] + np.arange(read_len)]
    hit = gen.random((n_reads, read_len)) < error_rate
    out[hit] = ALPHABET[gen.integers(0, 4, int(hit.sum()))]
    return BYTE_CODE[out], np.full(n_reads, read_len, np.int32)


def tag_runs(sa_pos, n_seq: int, node_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The synthetic tag array's runs (pos_enc, lengths) over the BWT rows
    whose suffixes start at offsets `sa_pos` (a numpy array, or a tensor on
    any device, where the work stays): a row whose suffix starts at offset
    o of its sequence is tagged with node o // node_len + 1 and in-node
    offset o % node_len (the compact encoding, reverse bit 0); the n_seq
    endmarker rows are tagged 0."""
    import torch

    off = torch.as_tensor(sa_pos).long()
    enc = ((off // node_len + 1) << 11) | (off % node_len)
    enc[:n_seq] = 0
    cut = torch.nonzero(enc[1:] != enc[:-1])[:, 0] + 1
    zero = torch.zeros(1, dtype=torch.int64, device=enc.device)
    starts = torch.cat((zero, cut))
    ends = torch.cat((cut, zero + enc.numel()))
    return enc[starts].cpu().numpy(), (ends - starts).cpu().numpy()


def k_copy_index(idx, tags, k: int):
    """The r-index and tag array of the text in which each sequence of `idx`
    is repeated k times in a row (sequence i becomes the k consecutive
    sequences i * k .. i * k + k - 1), made from idx's own tables with no BWT
    build (chip_smoke.py:k_copy_index; tests/test_torch_int64.py holds that
    one against the native build of the repeated lines).

    The copies of a suffix are adjacent in the k-copy suffix order (their
    strings are equal up to the separators, which order by sequence), so row
    p of the 1-copy BWT becomes rows k * p .. k * p + k - 1, all of p's
    symbol: a run keeps its symbol with k times its length, and an endmarker
    (each its own logical run) becomes k runs of length 1. Run starts, cum
    and C scale by k (plus j endmarkers before the j-th copy of an endmarker
    run); the suffix at row k * p + j is copy j of p's. A tag run keeps its
    graph position with k times its length (TagArray.from_runs splits the
    long ones)."""
    from pangenome_index_tpu_torch.models.rindex import RIndex
    from pangenome_index_tpu_torch.models.tagarray import TagArray

    ml = int(idx.max_len)
    is_end = idx.run_sym == 0
    reps = np.where(is_end, k, 1)
    src = np.repeat(np.arange(idx.n_runs), reps)      # the 1-copy run
    j = np.arange(src.size) - np.repeat(np.cumsum(reps) - reps, reps)
    run_len = np.where(is_end[src], 1, k * idx.run_len[src])
    cum = k * idx.cum[src]
    cum[:, 0] += j
    seq, off = np.divmod(idx.samples[src], ml)
    tail_1 = np.empty(idx.n_runs, np.int64)
    tail_1[idx.last_to_run] = idx.last_sorted
    tseq, toff = np.divmod(tail_1[src], ml)
    tails = (tseq * k + np.where(is_end[src], j, k - 1)) * ml + toff
    order = np.argsort(tails, kind="stable")
    big = RIndex(run_sym=idx.run_sym[src], run_start=k * idx.run_start[src] + j,
                 run_len=run_len, cum=cum, C=k * idx.C, n=k * int(idx.n),
                 n_seq=k * int(idx.n_seq), max_len=ml,
                 samples=(seq * k + j) * ml + off, last_sorted=tails[order],
                 last_to_run=order.astype(np.int64))
    return big, TagArray.from_runs(tags.pos_enc, tags.run_lengths() * k)


def index(cfg: dict, lines: list[bytes], device) -> tuple:
    """(RIndex, TagArray) of the configuration's text: the BWT, document
    array and suffix offsets by the program's device build
    (ops/bwt.py:bwt_tensors, byte-equal to its native SA-IS build), the tag
    array read off the offsets where they are, the r-index off all three;
    where the configuration asks for copies, the k-copy index made from
    that one."""
    from pangenome_index_tpu_torch.formats.rlbwt import rlbwt_from_text
    from pangenome_index_tpu_torch.models.rindex import build_rindex_from_sa
    from pangenome_index_tpu_torch.models.tagarray import TagArray
    from pangenome_index_tpu_torch.ops.bwt import bwt_tensors

    bwt, da, sa_pos, seq_lengths = bwt_tensors(lines, device)
    tags = TagArray.from_runs(*tag_runs(sa_pos, len(lines), cfg["node_len"]))
    bwt, da, sa_pos = (t.cpu().numpy() for t in (bwt, da, sa_pos))
    idx = build_rindex_from_sa(rlbwt_from_text(bwt.tobytes()), da, sa_pos,
                               seq_lengths)
    del bwt, da, sa_pos
    k = int(cfg["copies"])
    return (idx, tags) if k == 1 else k_copy_index(idx, tags, k)
