"""The plain reference that decides `correct`: MEMs and tag counts of reads
worked out from the text alone, in plain PyTorch (any device), importing
nothing of the program.

1. The suffix order of the text (each sequence ended by a separator of its
   own, the separators ordered by sequence and below every base), by prefix
   doubling with torch.sort; the BWT read off it, and the occurrence counts
   of the six symbols ({'\\n', A, C, G, N, T}) before every row.
2. MEMs by the reference tool's three-step search (find_mems_function of
   the pangenome-index C++ code): backward-extend the first min_len bases of
   a start, forward-extend to the maximal end, then a fresh backward
   extension from the end finds the next start; FMD bi-intervals, the NUL
   sentinel (code 0) past the read's end. Every lane of a batch of reads
   steps through that state machine at once. The count is exact; the first
   `capacity` MEMs are kept.
3. Tag counts per kept MEM by the reference tool's compact tag query: a
   row's tag is (offset // node_len + 1, offset % node_len) of its suffix
   (0 on endmarker rows), in runs as the tag files store them (runs of 512 or
   more split into pieces of 511); the run range of the MEM's interval, the
   decode starting one run early unless the first run's number is a
   multiple of 10, and the distinct tags among the first `tag_capacity`
   runs of it; overflow where the range holds more runs.

An index of k copies of every sequence (the k-copy text) has the 1-copy
BWT with every row repeated k times, so every interval of it is k times the
1-copy one: the reference runs on the 1-copy text and scales.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SIGMA = 6
#: complement in code space: '\n'<->'\n', A<->T, C<->G, N<->N
COMP = (0, 5, 3, 2, 4, 1)
#: byte -> code for the text's bases
_CODES = {ord("A"): 1, ord("C"): 2, ord("G"): 3, ord("N"): 4, ord("T"): 5}
START_EVERY_K = 10
MAX_TAG_RUN = 511


@dataclass
class Text:
    codes: torch.Tensor     # [n] int64 symbol codes, 0 at the separators
    start: torch.Tensor     # [n_seq] first position of each sequence
    n_seq: int


@dataclass
class FMD:
    n: int
    occ: torch.Tensor       # [n + 1, 6] int64: symbols before each row
    C: torch.Tensor         # [6] int64: rows of smaller symbols
    sa: torch.Tensor        # [n] int64: text position of each row
    text: Text


def text_of(lines: list[bytes], device) -> Text:
    lut = torch.zeros(256, dtype=torch.int64)
    for b, c in _CODES.items():
        lut[b] = c
    parts, starts, pos = [], [], 0
    for line in lines:
        arr = torch.frombuffer(bytearray(line), dtype=torch.uint8).long()
        parts.append(torch.cat((lut[arr], torch.zeros(1, dtype=torch.int64))))
        starts.append(pos)
        pos += len(line) + 1
    return Text(torch.cat(parts).to(device), torch.tensor(starts, device=device),
                len(lines))


def suffix_order(text: Text) -> torch.Tensor:
    """Rows of the suffix order -> text positions, by prefix doubling."""
    dev = text.codes.device
    n = text.codes.numel()
    seq = torch.searchsorted(text.start, torch.arange(n, device=dev), right=True) - 1
    # separators rank by sequence, below every base
    rank = torch.where(text.codes == 0, seq, text.n_seq + text.codes)
    pos = torch.arange(n, device=dev)
    h = 1
    while True:
        pair = rank * (n + text.n_seq + 1) + rank[(pos + h) % n]
        keys, order = torch.sort(pair)
        new = torch.zeros(n, dtype=torch.int64, device=dev)
        new[1:] = torch.cumsum(keys[1:] != keys[:-1], 0)
        rank = torch.empty_like(new)
        rank[order] = new
        del pair, keys, new
        if int(rank.max()) == n - 1:
            return order
        h *= 2


def fmd_index(lines: list[bytes], device) -> FMD:
    text = text_of(lines, device)
    sa = suffix_order(text)
    n = sa.numel()
    bwt = text.codes[(sa - 1) % n]
    occ = torch.zeros((n + 1, SIGMA), dtype=torch.int64, device=device)
    for c in range(SIGMA):
        occ[1:, c] = torch.cumsum(bwt == c, 0)
    C = torch.zeros(SIGMA, dtype=torch.int64, device=device)
    C[1:] = torch.cumsum(occ[n], 0)[:-1]
    return FMD(n, occ, C, sa, text)


def _backward(fmd: FMD, k, kp, s, c, kpw):
    """FMD backward extension of the lanes' bi-intervals (k, kp, s) by their
    codes c: (k, kp, s) of the extended pattern, s = 0 where it occurs
    nowhere."""
    r_k = fmd.occ[k.clamp(0, fmd.n)]
    delta = fmd.occ[(k + s).clamp(0, fmd.n)] - r_k
    kp = kp + (kpw[c] * delta).sum(1)
    rk_c = r_k.gather(1, c[:, None])[:, 0]
    s = delta.gather(1, c[:, None])[:, 0]
    return rk_c + fmd.C[c], kp, s


def mems(fmd: FMD, codes: torch.Tensor, lengths: torch.Tensor, min_len: int,
         min_occ: int, capacity: int, rescan: bool = True):
    """codes [R, L] (0-padded), lengths [R] -> (count [R], slots [R,
    capacity, 4] of (start, end, bwt_start, size), 0 past the count).
    rescan=False leaves step 3 out: the next start is the MEM's end (a
    control, not the reference tool's search)."""
    dev = fmd.occ.device
    R, L = codes.shape
    codes = torch.cat((codes.long(), torch.zeros((R, 1), dtype=torch.int64,
                                                  device=codes.device)), 1).to(dev)
    lengths = lengths.long().to(dev)
    comp = torch.tensor(COMP, device=dev)
    kpw = (comp[None, :] < comp[:, None]).long()
    lanes = torch.arange(R, device=dev)
    z = torch.zeros(R, dtype=torch.int64, device=dev)
    x, j, count = z.clone(), z.clone(), z.clone()
    k, kp, s = z.clone(), z.clone(), z.clone()       # step 1 and 2's interval
    k2, s2 = z.clone(), z.clone()                    # the last that passed
    phase = z.clone()                                # 0 new start, 1-3 steps, 4 done
    slots = torch.zeros((R, capacity, 4), dtype=torch.int64, device=dev)
    full = torch.full((R,), fmd.n, dtype=torch.int64, device=dev)
    while True:
        live = phase < 4
        if not bool(live.any()):
            return count, slots
        c = codes[lanes, j.clamp(0, L)]
        c = torch.where(j >= lengths, 0, c)          # the NUL sentinel
        # one extension a lane: backward in steps 1 and 3, forward in 2
        fwd = phase == 2
        a_k = torch.where(fwd, kp, k)
        a_kp = torch.where(fwd, k, kp)
        nk, nkp, ns = _backward(fmd, a_k, a_kp, s, torch.where(fwd, comp[c], c), kpw)
        nk, nkp = torch.where(fwd, nkp, nk), torch.where(fwd, nk, nkp)
        ok = (ns >= min_occ) & (ns > 0)

        p0, p1, p2, p3 = (phase == 0), (phase == 1), (phase == 2), (phase == 3)
        # phase 0: a read too short from x is done; else step 1 from x + min_len - 1
        start1 = p0 & (lengths - x >= min_len)
        # phase 1: a miss restarts at j + 1; the last base (j == x) enters step 2
        miss1 = p1 & ~ok
        done1 = p1 & ok & (j == x)
        # phase 2: past the read or a miss ends the MEM at j and emits it
        end2 = p2 & ((j >= lengths) | ~ok)
        grow2 = p2 & (j < lengths) & ok
        # phase 3: a miss restarts at j + 1; reaching x restarts at x + 1
        back3 = p3 & (j > x)
        miss3 = back3 & ~ok
        done3 = p3 & (j <= x)

        emit = end2
        slot = count.clamp(max=capacity - 1)
        put = emit & (count < capacity)
        row = torch.stack((x, j, k2, s2), 1)
        slots[lanes[put], slot[put]] = row[put]
        count = count + emit.long()

        new_phase = phase.clone()
        new_phase[p0] = torch.where(start1[p0], 1, 4)
        new_phase[miss1 | miss3 | done3] = 0
        new_phase[done1] = 2
        new_phase[end2] = 3 if rescan else 0

        x = torch.where(miss1 | miss3, j + 1, torch.where(done3, x + 1, x))
        if not rescan:
            x = torch.where(end2, j, x)
        # the interval carried: step 1 and 3 extend theirs, step 2 its own
        keep = (p1 & ok) | grow2 | (back3 & ok)
        k = torch.where(keep, nk, k)
        kp = torch.where(keep, nkp, kp)
        s = torch.where(keep, ns, s)
        k2 = torch.where(done1 | grow2, nk, k2)
        s2 = torch.where(done1 | grow2, ns, s2)
        fresh = start1 | end2                       # (0, 0, n) before steps 1 and 3
        k = torch.where(fresh, 0, k)
        kp = torch.where(fresh, 0, kp)
        s = torch.where(fresh, full, s)
        j = torch.where(start1, x + min_len - 1, j)
        j = torch.where(p1 & ok & (j != x), j - 1, j)
        j = torch.where(done1, x + min_len, j)
        j = torch.where(grow2, j + 1, j)
        j = torch.where(back3 & ok, j - 1, j)
        phase = new_phase


def row_tags(fmd: FMD, node_len: int) -> torch.Tensor:
    """The tag of every BWT row: (offset // node_len + 1) << 11 | offset %
    node_len of its suffix, 0 where the suffix is a separator."""
    t = fmd.text
    seq = torch.searchsorted(t.start, fmd.sa, right=True) - 1
    off = fmd.sa - t.start[seq]
    enc = ((off // node_len + 1) << 11) | (off % node_len)
    return torch.where(t.codes[fmd.sa] == 0, 0, enc)


def split_runs(vals: torch.Tensor, lens: torch.Tensor):
    """Runs of MAX_TAG_RUN + 1 or more become pieces of MAX_TAG_RUN and a
    remainder, as the tag files store them."""
    pieces = (lens + MAX_TAG_RUN - 1) // MAX_TAG_RUN
    out_v = torch.repeat_interleave(vals, pieces)
    out_l = torch.full((int(pieces.sum()),), MAX_TAG_RUN, dtype=torch.int64,
                       device=lens.device)
    last = torch.cumsum(pieces, 0) - 1
    rem = lens - (pieces - 1) * MAX_TAG_RUN
    out_l[last] = rem
    return out_v, out_l


def tag_runs(fmd: FMD, node_len: int, copies: int):
    """(run values, run heads) of the tag array over the k-copy text's rows:
    the 1-copy rows' tags in runs, stored split; each such run k times as
    long in the k-copy text, stored split again."""
    enc = row_tags(fmd, node_len)
    cut = torch.nonzero(enc[1:] != enc[:-1])[:, 0] + 1
    first = torch.cat((torch.zeros(1, dtype=torch.int64, device=enc.device), cut))
    lens = torch.diff(torch.cat((first, torch.tensor([enc.numel()], device=enc.device))))
    vals, lens = split_runs(enc[first], lens)
    if copies > 1:
        vals, lens = split_runs(vals, lens * copies)
    heads = torch.cumsum(lens, 0) - lens
    return vals, heads


def tag_counts(vals: torch.Tensor, heads: torch.Tensor, count, slots,
               capacity: int, tag_capacity: int):
    """(distinct tags [R, capacity], overflow [R, capacity]) of every kept
    MEM's interval (0 / False past the count), by the compact tag query."""
    R = count.numel()
    t = vals.numel()
    valid = torch.arange(capacity, device=count.device)[None, :] < count.clamp(max=capacity)[:, None]
    lo = slots[..., 2].reshape(-1).contiguous()
    hi = (slots[..., 2] + slots[..., 3] - 1).reshape(-1).contiguous()
    first = torch.searchsorted(heads, lo, right=True)
    last = torch.searchsorted(heads, hi, right=True)
    n_runs = last - first + 1
    begin = torch.where(first % START_EVERY_K == 0, first, first - 1)
    nu = torch.zeros(R * capacity, dtype=torch.int64, device=count.device)
    seen = []
    for i in range(tag_capacity):
        w = begin + i
        ok = (i < n_runs) & (w >= 0) & (w < t)
        v = torch.where(ok, vals[w.clamp(0, t - 1)], -1)
        new = ok.clone()
        for u in seen:
            new &= v != u
        nu += new.long()
        seen.append(v)
    nu = torch.where(valid, nu.reshape(R, capacity), 0)
    ov = (n_runs > tag_capacity).reshape(R, capacity) & valid
    return nu, ov


def answers(fmd: FMD, codes, lengths, *, min_len: int, min_occ: int,
            capacity: int, tag_capacity: int, tags: tuple, copies: int,
            block: int = 16384, rescan: bool = True):
    """Per read: count [R], slots [R, capacity, 4] and tag counts (nu, ov)
    [R, capacity], on the k-copy text (intervals k times the 1-copy ones),
    in blocks of reads."""
    out = []
    for b in range(0, codes.shape[0], block):
        cnt, sl = mems(fmd, codes[b: b + block], lengths[b: b + block], min_len,
                       min_occ, capacity, rescan)
        sl[..., 2:] *= copies
        out.append((cnt, sl, *tag_counts(*tags, cnt, sl, capacity, tag_capacity)))
    return tuple(torch.cat(parts) for parts in zip(*out))
