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
place in it being its stream index: per pass of 8 bits of the label (one
pass up to C = 255), a tile histogram, one scan of the histograms and the
placement (csrc/merge.cu). The plain version computes each row's rank in
its component by a stable sort.
"""

from __future__ import annotations

import torch

from .. import _build

#: keys a tile of the kernel (csrc/merge.cu: kThreads * kItems)
TILE = 4096
#: bits of the component label a pass
DIGIT_BITS = 8


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


def merge_rows(comp: torch.Tensor, stream: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """tag [n] int64, as merge_rows_plain; on the card three launches a pass
    of the sort (one pass up to C = 255), each counted; the plain version on
    the CPU."""
    if comp.dim() != 1 or stream.dim() != 1 or offsets.dim() != 1 or not offsets.numel():
        raise ValueError("merge_rows: comp [n], stream [t] and offsets [C + 1] are 1-d")
    if comp.device.type == "cpu":
        return merge_rows_plain(comp, stream, offsets)
    dev = comp.device
    n, C, t = comp.numel(), offsets.numel() - 1, stream.numel()
    if C >= 2**31 - 1:
        raise ValueError(f"merge_rows: {C} components do not fit an int32 label")
    tag = torch.empty(n, dtype=torch.int64, device=dev)
    if not n:
        return tag
    comp_p = _build.check("comp", comp, torch.int32, dev)
    stream_p = _build.check("stream", stream, torch.int64, dev) if t else None
    _build.check("offsets", offsets, torch.int64, dev)
    tiles = -(-n // TILE)
    st = _build.stream(dev)
    passes = merge_passes(C)
    # an earlier pass places (key, row) pairs for the next; the first reads
    # the keys off comp and the rows are its indices (null pointers)
    keys = rows = None
    for d, (shift, radix) in enumerate(passes):
        last = d == len(passes) - 1
        counts = torch.empty(radix * tiles, dtype=torch.int64, device=dev)
        keys_p = None if keys is None else keys.data_ptr()
        rows_p = None if rows is None else rows.data_ptr()
        _build.launch("pgt_merge_count", comp_p, keys_p, n, C, shift, radix, tiles,
                      counts.data_ptr(), st)
        merge_rows.launches += 1
        _build.launch("pgt_merge_scan", counts.data_ptr(), counts.numel(), st)
        merge_rows.launches += 1
        keys_out = None if last else torch.empty(n, dtype=torch.int32, device=dev)
        rows_out = None if last else torch.empty(n, dtype=torch.int64, device=dev)
        _build.launch("pgt_merge_place", comp_p, keys_p, rows_p, n, C, shift, radix, tiles,
                      counts.data_ptr(), None if last else keys_out.data_ptr(),
                      None if last else rows_out.data_ptr(), stream_p, t, tag.data_ptr(), st)
        merge_rows.launches += 1
        # the inputs are dropped only once the launch that reads them is queued
        keys, rows = keys_out, rows_out
    return tag


merge_rows.launches = 0
