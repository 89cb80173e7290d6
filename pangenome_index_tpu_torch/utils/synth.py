"""Synthetic pangenome generator for the bench workload and the tests.

The port's copy of pangenome_index_tpu/utils/synth.py, cut to the index, the
reads, the tag array and the synthetic graphs (same seeds, same values, same
cache files): a base "contig" plus N haplotypes (mutated copies), which
gives the run-length structure real pangenome BWTs have. The BWT and the
suffix array come from the native SA-IS build; the index arrays are cached
on disk. synth_graph_gbz and synth_multi_component_gbz make the matching
variation graphs (GBZ), one component per synthetic chromosome.
"""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np

from .. import native
from ..formats.rlbwt import rlbwt_from_text
from ..models.rindex import RIndex, build_rindex_from_sa
from ..models.tagarray import TagArray
from ..ops.mertable import mer_table_key


def synth_haplotypes(base_len: int, n_haps: int, snp_rate: float = 0.002,
                     seed: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    base = alphabet[rng.integers(0, 4, base_len)]
    lines = []
    for _ in range(n_haps):
        hap = base.copy()
        n_mut = rng.binomial(base_len, snp_rate)
        pos = rng.choice(base_len, size=n_mut, replace=False)
        hap[pos] = alphabet[(np.searchsorted(alphabet, hap[pos])
                             + rng.integers(1, 4, n_mut)) % 4]
        lines.append(hap.tobytes())
    return lines


def synth_graph_gbz(base_len: int, n_haps: int, site_rate: float = 0.002,
                    seed: int = 0, max_node_len: int = 1024,
                    first_id: int = 1, _raw: bool = False):
    """Synthetic pangenome GRAPH + matching haplotype texts: a backbone
    segmented at shared variant sites (each site a 2-allele bubble), each
    haplotype a path picking ref/alt per site. Returns (GBZ, lines) where
    lines[h] is exactly the text spelled by GBZ path 2h (forward strand), so
    `build-tags` over an r-index of `lines` exercises the full pipeline at
    scale. Node lengths are capped at max_node_len (the tag packing carries a
    10-bit in-node offset)."""
    from ..core.gbwt_build import gbz_from_graph

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    base = alphabet[rng.integers(0, 4, base_len)]
    n_sites = int(rng.binomial(base_len, site_rate))
    site_pos = np.sort(rng.choice(base_len, size=n_sites, replace=False))
    ref = base[site_pos]
    alt = alphabet[(np.searchsorted(alphabet, ref) + rng.integers(1, 4, n_sites)) % 4]
    hap_alt = rng.random((n_haps, n_sites)) < 0.5

    # backbone gaps between sites, split into <= max_node_len chunks
    gap_start = np.concatenate(([0], site_pos + 1))
    gap_end = np.concatenate((site_pos, [base_len]))
    gap_len = gap_end - gap_start
    chunks_per_gap = -(-gap_len // max_node_len)  # ceil; 0 for empty gaps

    # node ids in genomic order: gap g's chunks, then site g's (ref, alt)
    ids_per_gap = chunks_per_gap + 2                # last gap has no site
    ids_per_gap[-1] -= 2
    gap_id0 = np.concatenate(([first_id], first_id + np.cumsum(ids_per_gap)))[:-1]

    node_seqs: dict[int, bytes] = {}
    skeleton: list[np.ndarray] = []
    site_slot = np.zeros(n_sites, np.int64)       # skeleton index of site g
    ref_id = np.zeros(n_sites, np.int64)
    pos = 0
    for g in range(n_sites + 1):
        nid = int(gap_id0[g])
        s, e = int(gap_start[g]), int(gap_end[g])
        ck = int(chunks_per_gap[g])
        for c in range(ck):
            a = s + c * max_node_len
            node_seqs[nid + c] = base[a:min(a + max_node_len, e)].tobytes()
        if ck:
            skeleton.append(np.arange(nid, nid + ck, dtype=np.int64))
            pos += ck
        if g < n_sites:
            node_seqs[nid + ck] = bytes([int(ref[g])])
            node_seqs[nid + ck + 1] = bytes([int(alt[g])])
            ref_id[g] = nid + ck
            site_slot[g] = pos
            skeleton.append(np.array([nid + ck], np.int64))
            pos += 1
    skel = np.concatenate(skeleton) if skeleton else np.zeros(0, np.int64)

    paths: list[np.ndarray] = []
    lines: list[bytes] = []
    for h in range(n_haps):
        p = skel.copy()
        p[site_slot] = ref_id + hap_alt[h]
        fwd = 2 * p
        paths.append(fwd)
        paths.append((fwd ^ 1)[::-1])             # reverse orientation
        line = base.copy()
        m = hap_alt[h]
        line[site_pos[m]] = alt[m]
        lines.append(line.tobytes())
    if _raw:
        return node_seqs, paths, lines
    return gbz_from_graph(node_seqs, paths), lines


def synth_multi_component_gbz(base_len: int, n_haps: int, n_comps: int = 2,
                              site_rate: float = 0.002, seed: int = 0,
                              max_node_len: int = 1024):
    """A whole-"genome" GBZ with n_comps weakly-connected components (one per
    synthetic chromosome) + the per-component sub-GBZs carrying the SAME node
    ids - the shape `merge-tags` consumes (per-chromosome build_tags shards +
    the whole-genome graph, README.md:103-133). Returns
    (whole_gbz, [sub_gbz...], [comp_lines...])."""
    from ..core.gbwt_build import gbz_from_graph

    all_nodes: dict[int, bytes] = {}
    all_paths: list[np.ndarray] = []
    subs, comp_lines = [], []
    first_id = 1
    for c in range(n_comps):
        nodes, paths, lines = synth_graph_gbz(
            base_len, n_haps, site_rate=site_rate, seed=seed + 101 * c,
            max_node_len=max_node_len, first_id=first_id, _raw=True)
        all_nodes.update(nodes)
        all_paths.extend(paths)
        subs.append(gbz_from_graph(nodes, paths))
        comp_lines.append(lines)
        first_id = max(nodes) + 1
    return gbz_from_graph(all_nodes, all_paths), subs, comp_lines


def synth_reads(lines: list[bytes], n_reads: int, read_len: int,
                error_rate: float = 0.01, seed: int = 1) -> list[bytes]:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for _ in range(n_reads):
        line = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(line) - read_len))
        read = np.frombuffer(line[a : a + read_len], np.uint8).copy()
        n_err = rng.binomial(read_len, error_rate)
        if n_err:
            pos = rng.choice(read_len, size=n_err, replace=False)
            read[pos] = alphabet[rng.integers(0, 4, n_err)]
        reads.append(read.tobytes())
    return reads


def _rle(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if values.size == 0:
        return values, np.zeros(0, np.int64)
    boundaries = np.flatnonzero(values[1:] != values[:-1]) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [values.size]))
    return values[starts], (ends - starts).astype(np.int64)


def synth_tag_array(idx: RIndex, node_len: int = 512,
                    cache_dir: str | None = None) -> TagArray:
    """Synthetic tag array over the index's BWT rows. Every row's text
    position maps to a backbone "node" shared across haplotypes (node =
    offset // node_len + 1: synth_haplotypes mutates copies in place, so
    coordinates are shared like bubble-free backbone nodes), packed with the
    compact encoding; endmarker rows get tag 0. Runs therefore compress with
    haplotype depth, as real pangenome tags do.

    Per-row positions come from the native psi walk. Cached under cache_dir
    keyed by the index content (the seed-table cache's scheme)."""
    cache = None
    if cache_dir is not None:
        key = mer_table_key(idx, -node_len)  # content key; -node_len != any m
        cache = pathlib.Path(cache_dir) / f"synthtags_{key}.npz"
        if cache.exists():
            with np.load(cache, allow_pickle=False) as z:
                return TagArray.from_runs(z["pos_enc"], z["lengths"])
    sym = idx.run_sym.astype(np.int64)
    psi_base = idx.C[sym] + idx.cum[np.arange(idx.n_runs), sym]
    seq_len, sa_seq, sa_t = native.psi_walk_sa_native(
        idx.run_start, psi_base, idx.run_sym == 0, idx.n, idx.n_seq)
    sa_pos = seq_len[sa_seq] - 1 - sa_t
    del sa_seq, sa_t  # positions are the same on every haplotype here
    enc = sa_pos.astype(np.int64)
    np.floor_divide(enc, node_len, out=enc)
    enc += 1
    enc <<= 11
    enc |= sa_pos % node_len  # node_len is a power of two; offsets < 1024
    enc[: idx.n_seq] = 0
    del sa_pos
    vals, lens = _rle(enc)
    del enc
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, pos_enc=vals, lengths=lens)
    return TagArray.from_runs(vals, lens)


def build_synth_index(base_len: int, n_haps: int, snp_rate: float = 0.002,
                      seed: int = 0,
                      cache_dir: str | None = None) -> tuple[RIndex, list[bytes]]:
    """Build (and cache) an r-index over a synthetic pangenome."""
    key = hashlib.sha1(
        f"{base_len}-{n_haps}-{snp_rate}-{seed}-v1".encode()).hexdigest()[:16]
    cache = pathlib.Path(cache_dir) / f"synth_{key}.npz" if cache_dir else None
    lines = synth_haplotypes(base_len, n_haps, snp_rate, seed)
    if cache is not None and cache.exists():
        z = np.load(cache)
        idx = RIndex(
            run_sym=z["run_sym"], run_start=z["run_start"], run_len=z["run_len"],
            cum=z["cum"], C=z["C"], n=int(z["n"]), n_seq=int(z["n_seq"]),
            max_len=int(z["max_len"]), samples=z["samples"],
            last_sorted=z["last_sorted"], last_to_run=z["last_to_run"],
        )
        return idx, lines
    bwt, da, sa_pos, seq_lengths = native.build_bwt_native(lines)
    idx = build_rindex_from_sa(rlbwt_from_text(bwt.tobytes()), da, sa_pos,
                               seq_lengths)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(  # uncompressed: compression dominates the build at scale
            cache, run_sym=idx.run_sym, run_start=idx.run_start,
            run_len=idx.run_len, cum=idx.cum, C=idx.C, n=idx.n,
            n_seq=idx.n_seq, max_len=idx.max_len, samples=idx.samples,
            last_sorted=idx.last_sorted, last_to_run=idx.last_to_run,
        )
    return idx, lines
