"""The one-card tag merge: merge_rows (csrc/merge.cu).

Counterpart of pangenome_index_tpu/parallel/merge.py:make_device_merge on
one device, where its all_gather is the identity and its cross-shard scan
is zero: for rows labelled with their component (comp int32 [n], dense
labels 0..C-1), the components' per-position tags concatenated in label
order (stream int64 [t]) and their starts (offsets int64 [C + 1]),

    tag[i] = stream[offsets[c] + #{j < i : comp[j] = c}],  c = comp[i],

and 0 where c is not in [0, C) (-1: endmarker rows). The caller ensures that
each component's row count equals its stream's length, offsets being the
running sum of those lengths (core/merge.merge_tags_on_device checks it on
the host, as the JAX package does): the kernel reads a row's tag at its
place in the rows sorted by component, which is then offsets[c] plus its
rank, and no read falls outside the stream.

The kernel is a stable counting sort of the rows by component, a row's
place in it giving its stream index: one launch a pass of 8 bits of the
label (one pass up to C = 255), each tile's place among the tiles taken by
a decoupled look-back (csrc/merge.cu). The plain version computes each
row's rank in its component by a stable sort.

merge_rows_shard is one data shard's part of the cross-card merge
(parallel/merge.py): a row's stream index is offsets[c] + base[c] + its
rank within c on the shard, base[c] being the rows of c on earlier shards;
one launch counts the shard's rows of each component for the exchange that
gives base, then the same sort reads base itself.
"""

from __future__ import annotations

import torch

from .. import _build

#: keys a tile of the kernel (csrc/merge.cu: kThreads * kItems)
TILE = 2048
#: bits of the component label a pass
DIGIT_BITS = 8
#: digit values a pass, at most
RADIX = 1 << DIGIT_BITS


def merge_passes(C: int) -> list[tuple[int, int]]:
    """(shift, radix) of each pass of the kernel's sort of the keys 0..C
    (C: the rows outside every component): 8 bits a pass, the last pass's
    radix only as wide as the top digit needs."""
    passes = max(1, -(-C.bit_length() // DIGIT_BITS))
    return [(DIGIT_BITS * d, min(1 << DIGIT_BITS, (C >> (DIGIT_BITS * d)) + 1))
            for d in range(passes)]


def merge_rows_plain(comp: torch.Tensor, stream: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """tag [n] int64 by the definition: each row's rank within its
    component from a stable sort of the rows by component."""
    n, C, t = comp.numel(), offsets.numel() - 1, stream.numel()
    c = comp.long()
    inside = (c >= 0) & (c < C)
    key = torch.where(inside, c, C)
    order = torch.sort(key, stable=True).indices
    first = torch.searchsorted(key[order], torch.arange(C + 1, device=comp.device))
    rank = torch.empty(n, dtype=torch.int64, device=comp.device)
    rank[order] = torch.arange(n, device=comp.device) - first[key[order]]
    if not t:
        return torch.zeros(n, dtype=torch.int64, device=comp.device)
    at = offsets[key.clamp(max=max(C - 1, 0))] + rank
    return torch.where(inside, stream[at.clamp(0, t - 1)], 0)


def _check_inputs(name: str, comp, stream, offsets) -> None:
    if comp.dim() != 1 or stream.dim() != 1 or offsets.dim() != 1 or not offsets.numel():
        raise ValueError(f"{name}: comp [n], stream [t] and offsets [C + 1] are 1-d")
    if offsets.numel() - 1 >= 2**31 - 1:
        raise ValueError(f"{name}: {offsets.numel() - 1} components do not fit an int32 label")


def merge_rows(comp: torch.Tensor, stream: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """tag [n] int64, as merge_rows_plain; on the card one launch up to C =
    255 (past it the digit totals, the components' first places and a
    launch a pass of the sort), each counted; the plain version on the
    CPU."""
    _check_inputs("merge_rows", comp, stream, offsets)
    if comp.device.type == "cpu":
        return merge_rows_plain(comp, stream, offsets)
    C = offsets.numel() - 1
    hist = None
    if comp.numel() and len(merge_passes(C)) > 1:
        hist = _hist(comp, C)
        merge_rows.launches += 1
    tag, n_launches = _sort_and_gather(comp, stream, offsets, None, hist)
    merge_rows.launches += n_launches
    return tag


merge_rows.launches = 0


def merge_rows_shard_plain(comp: torch.Tensor, stream: torch.Tensor, offsets: torch.Tensor,
                           base_of) -> torch.Tensor:
    """One data shard's rows of the cross-card merge by the definition: the
    shard's per-component counts (bincount), base = base_of(counts) [C]
    int64 (the rows of each component on earlier shards), then each row's
    tag stream[offsets[c] + base[c] + its rank within c here], 0 where c is
    outside [0, C) or the index outside the stream."""
    n, C, t = comp.numel(), offsets.numel() - 1, stream.numel()
    c = comp.long()
    inside = (c >= 0) & (c < C)
    counts = torch.bincount(c[inside], minlength=C)[:C]
    base = base_of(counts).to(torch.int64)
    key = torch.where(inside, c, C)
    order = torch.sort(key, stable=True).indices
    first = torch.searchsorted(key[order], torch.arange(C + 1, device=comp.device))
    rank = torch.empty(n, dtype=torch.int64, device=comp.device)
    rank[order] = torch.arange(n, device=comp.device) - first[key[order]]
    if not t:
        return torch.zeros(n, dtype=torch.int64, device=comp.device)
    kc = key.clamp(max=max(C - 1, 0))
    at = offsets[kc] + base[kc] + rank
    return torch.where(inside & (at >= 0) & (at < t), stream[at.clamp(0, t - 1)], 0)


def merge_rows_shard(comp: torch.Tensor, stream: torch.Tensor, offsets: torch.Tensor,
                     base_of) -> torch.Tensor:
    """One data shard's rows of the cross-card merge (parallel/merge.py), as
    merge_rows_shard_plain. On the card: one launch counts the shard's rows
    of each component (pgt_merge_hist; past C = 255 also the sort's digit
    totals); base_of(counts) returns the rows of each component on earlier
    shards (the caller's all_gather and exclusive prefix, outside the
    kernel; on one card zeros), and nothing else runs before merge_rows'
    sort, whose last pass reads offsets and base itself. Every launch
    counted; the plain version on the CPU."""
    _check_inputs("merge_rows_shard", comp, stream, offsets)
    if comp.device.type == "cpu":
        return merge_rows_shard_plain(comp, stream, offsets, base_of)
    dev = comp.device
    C = offsets.numel() - 1
    if comp.numel() and C:
        hist = _hist(comp, C)
        merge_rows_shard.launches += 1
    else:
        hist = (torch.zeros(C, dtype=torch.int64, device=dev), None)
    base = base_of(hist[0]).to(device=dev, dtype=torch.int64)
    tag, n_launches = _sort_and_gather(comp, stream, offsets, base if C else None, hist)
    merge_rows_shard.launches += n_launches
    return tag


merge_rows_shard.launches = 0


def _hist(comp, C):
    """One launch: (counts [C] int64, the rows of each component; the sort's
    digit totals [passes, RADIX] int64 past one pass, else None)."""
    dev = comp.device
    passes = len(merge_passes(C))
    counts = torch.empty(C, dtype=torch.int64, device=dev)
    digits = torch.empty(passes * RADIX, dtype=torch.int64, device=dev) if passes > 1 else None
    _build.launch("pgt_merge_hist", _build.check("comp", comp, torch.int32, dev), comp.numel(),
                  C, counts.data_ptr(), passes if passes > 1 else 0,
                  None if digits is None else digits.data_ptr(), _build.stream(dev))
    return counts, digits


def _sort_and_gather(comp, stream, offsets, base, hist):
    """merge_rows' launches, the last pass reading stream[offsets[c] +
    base[c] + the row's rank in c] (base None: 0); hist = _hist's counts
    and digit totals, needed past one pass: (tag, the number of launches)."""
    dev = comp.device
    n, C, t = comp.numel(), offsets.numel() - 1, stream.numel()
    tag = torch.empty(n, dtype=torch.int64, device=dev)
    if not n:
        return tag, 0
    comp_p = _build.check("comp", comp, torch.int32, dev)
    stream_p = _build.check("stream", stream, torch.int64, dev) if t else None
    offsets_p = _build.check("offsets", offsets, torch.int64, dev)
    base = None if base is None else base.contiguous()  # kept until the launch is queued
    base_p = None if base is None else _build.check("base", base, torch.int64, dev)
    n_launches = 0
    tiles = -(-n // TILE)
    st = _build.stream(dev)
    passes = merge_passes(C)
    local_start = None
    if len(passes) > 1:
        # each component's first place in the sorted rows
        local_start = torch.empty(C, dtype=torch.int64, device=dev)
        _build.launch("pgt_merge_scan", hist[0].data_ptr(), local_start.data_ptr(), C, st)
        n_launches += 1
    # an earlier pass places (key, row) pairs for the next; the first reads
    # the keys off comp and the rows are its indices (null pointers)
    keys = rows = None
    for d, (shift, radix) in enumerate(passes):
        last = d == len(passes) - 1
        state = torch.empty(tiles * radix + 1, dtype=torch.int64, device=dev)
        keys_out = None if last else torch.empty(n, dtype=torch.int32, device=dev)
        rows_out = None if last else torch.empty(n, dtype=torch.int64, device=dev)
        digits_p = None if local_start is None else hist[1].data_ptr() + d * RADIX * 8
        _build.launch("pgt_merge_place", comp_p, None if keys is None else keys.data_ptr(),
                      None if rows is None else rows.data_ptr(), n, C, shift, radix, digits_p,
                      state.data_ptr(), None if last else keys_out.data_ptr(),
                      None if last else rows_out.data_ptr(), stream_p, t, offsets_p, base_p,
                      None if local_start is None else local_start.data_ptr(),
                      tag.data_ptr(), st)
        n_launches += 1
        # the inputs are dropped only once the launch that reads them is queued
        keys, rows = keys_out, rows_out
    return tag, n_launches
