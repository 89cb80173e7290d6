"""K3: batched MEM finding (csrc/mems.cu), one thread per read, after one
pass that resolves the seed tiers of every read position.

Counterpart of pangenome_index_tpu/ops/mems.py:find_mems_impl. The per-read
algorithm is the same state machine (phases 0..5, the three steps of the
reference's find_mems_function, the bint2 bookkeeping, the NUL sentinel at
the pad column j == length) and gives the same MemResult. The TPU ran all
reads in lockstep with one-hot selects for every per-lane read; the kernel
runs each read in its own thread with its state in registers, and the plain
version below keeps the lockstep form with direct indexing.

Seed tiers follow mems.py:87-116: at a read position the dense m-mer table
row, overridden by the long-seed dictionary row where that passes; the
tier's length goes with it, 0 meaning no seed. They are resolved for every
read position before the loop (resolve_seeds: on the card one launch of its
own kernel, one thread a position), so that the MEM kernel finds a seed with
one load, which it issues an iteration ahead.

Positions (intervals, seeds, bwt_start and size) are the tables' position
dtype: int32 below n = 2^31, int64 past it, each with its instantiation of
the kernels; the read positions and the packed (start, end) stay int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .dense_rank import gather_rows_plain
from .fmd import check_kernel_tables, extend_plain, rank_args
from .tables import RIndexTables


class MemResult(NamedTuple):
    start: torch.Tensor      # [B, M]
    end: torch.Tensor        # [B, M]
    bwt_start: torch.Tensor  # [B, M]
    size: torch.Tensor       # [B, M]
    count: torch.Tensor      # [B] MEMs found (may exceed M)
    overflow: torch.Tensor   # [B] bool: count exceeded capacity M


def resolve_seeds_plain(B: int, W: int, min_occ: int, mer_table=None,
                        mer_keys=None, mer_valid=None, mer_m: int = 0,
                        sdict_vals=None, sdict_idx=None, sdict_m: int = 0):
    """Per read position (k, kp, s, tier length) as [B, W, 4] in the tables'
    dtype, or None without seed tiers."""
    if mer_table is None and sdict_vals is None:
        return None
    gather = gather_rows_plain
    ref = mer_table if mer_table is not None else sdict_vals
    seeds = torch.zeros((B, W, 4), dtype=ref.dtype, device=ref.device)
    if mer_table is not None:
        rows = gather(mer_table, mer_keys.reshape(-1)).reshape(B, W, 3)
        ok = mer_valid & (rows[..., 2] > 0)
        seeds[..., :3] = torch.where(ok[..., None], rows, 0)
        seeds[..., 3] = ok.to(seeds.dtype) * mer_m
    if sdict_vals is not None:
        lrows = gather(sdict_vals, sdict_idx.reshape(-1)).reshape(B, W, 3)
        ls = lrows[..., 2]
        use = (sdict_idx >= 0) & (ls >= max(int(min_occ), 1)) & (ls > 0)
        seeds[..., :3] = torch.where(use[..., None], lrows, seeds[..., :3])
        seeds[..., 3] = torch.where(use, sdict_m, seeds[..., 3])
    return seeds


def resolve_seeds(B: int, W: int, min_occ: int, mer_table=None, mer_keys=None,
                  mer_valid=None, mer_m: int = 0, sdict_vals=None,
                  sdict_idx=None, sdict_m: int = 0):
    """Per read position (k, kp, s, tier length) as [B, W, 4] in the tables'
    dtype, or None without seed tiers: mer_table [4^m, 3] with mer_keys /
    mer_valid [B, W], sdict_vals [D, 3] with sdict_idx [B, W] (-1 = absent);
    both tables int32, or both int64. On the card one launch, one thread a
    position, the dictionary first and the m-mer table only where it misses;
    on the CPU the plain version."""
    if mer_table is None and sdict_vals is None:
        return None
    ref = mer_table if mer_table is not None else sdict_vals
    dev, pd = ref.device, ref.dtype
    if dev.type == "cpu":
        return resolve_seeds_plain(B, W, min_occ, mer_table, mer_keys, mer_valid,
                                   mer_m, sdict_vals, sdict_idx, sdict_m)

    def per_read(name, a, dtype):
        if tuple(a.shape) != (B, W):
            raise ValueError(f"{name}: expected shape {(B, W)}, got {tuple(a.shape)}")
        return _build.check(name, a, dtype, dev)

    def table(name, a):
        if a.dim() != 2 or a.shape[1] != 3 or a.shape[0] == 0:
            raise ValueError(f"{name}: expected [rows > 0, 3]")
        return _build.check(name, a, pd, dev), a.shape[0]

    mer = (None, 0, None, None, 0)
    if mer_table is not None:
        mer = (*table("mer_table", mer_table),
               per_read("mer_keys", mer_keys, torch.int32),
               per_read("mer_valid", mer_valid, torch.bool), int(mer_m))
    sdict = (None, 0, None, 0)
    if sdict_vals is not None:
        sdict = (*table("sdict_vals", sdict_vals),
                 per_read("sdict_idx", sdict_idx, torch.int32), int(sdict_m))
    if pd not in (torch.int32, torch.int64):
        raise ValueError(f"resolve_seeds: int32 or int64 tables, not {pd}")
    seeds = torch.empty((B, W, 4), dtype=pd, device=dev)
    _build.launch("pgt_resolve_seeds64" if pd == torch.int64 else "pgt_resolve_seeds",
                  *mer, *sdict, B * W, int(min_occ),
                  seeds.data_ptr(), _build.stream(dev))
    resolve_seeds.launches += 1
    return seeds


resolve_seeds.launches = 0


def _prepare(codes, align: int = 1):
    """(codes as int8 with the NUL pad column, rows padded to a multiple of
    `align` columns; the loop's iteration bound)."""
    L = codes.shape[1]
    if L >= 0xFFFF:  # (start, end) pack into one int32, 16 bits each
        raise ValueError(f"read length {L} exceeds the 65534 engine limit")
    width = -(-(L + 1) // align) * align
    padded = torch.nn.functional.pad(codes.to(torch.int8), (0, width - L))
    return padded, 4 * (L + 1) * (L + 1) + 64


def _result(t, se, bwt, size, cnt, steps, capacity, with_stats):
    pd = t.pos_dtype
    res = MemResult((se >> 16).to(pd), (se & 0xFFFF).to(pd), bwt.to(pd),
                    size.to(pd), cnt, cnt > capacity)
    return (res, {"steps": steps}) if with_stats else res


def find_mems(t: RIndexTables, codes, lengths, min_len: int, min_occ: int,
              capacity: int = 32, with_stats: bool = False, **seed_kw):
    """codes [B, L] alphabet codes (0-padded), lengths [B]. Seed tiers as in
    the JAX engine: mer_table/mer_keys/mer_valid/mer_m and
    sdict_vals/sdict_idx/sdict_m (shapes: resolve_seeds).
    Returns MemResult, with with_stats also
    {"steps": [B] extension steps per read} - their sum is the JAX engine's
    with_stats "steps". The JAX "iters" counts lockstep iterations of the
    whole batch and has no counterpart here.

    On the card: resolve_seeds, then one launch of the kernel over the whole
    batch (int32 codes and lengths; seed tables in the tables' position
    dtype); on the CPU: the plain version."""
    if codes.device.type == "cpu":
        return find_mems_plain(t, codes, lengths, min_len, min_occ, capacity,
                               with_stats, **seed_kw)
    check_kernel_tables(t)
    dev = t.device
    pd = t.pos_dtype
    padded, max_iters = _prepare(codes, align=8)  # the kernel reads 8 codes a load
    B, W = codes.shape[0], codes.shape[1] + 1
    kind, rargs = rank_args(t)
    seeds = resolve_seeds(B, W, min_occ, **seed_kw)
    if seeds is not None and seeds.dtype != pd:
        raise ValueError(f"find_mems: seed tables of {seeds.dtype} beside tables "
                         f"of {pd} positions")
    se = torch.zeros((B, capacity), dtype=torch.int32, device=dev)
    bwt, size = torch.zeros((2, B, capacity), dtype=pd, device=dev)
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev) if with_stats else None
    _build.launch(
        f"pgt_find_mems_{kind}", *rargs,
        _build.check("C", t.C, pd, dev), padded.data_ptr(),
        _build.check("lengths", lengths, torch.int32, dev),
        None if seeds is None else seeds.data_ptr(), B, W, padded.shape[1],
        int(min_len), int(min_occ), t.n, capacity, max_iters, se.data_ptr(),
        bwt.data_ptr(), size.data_ptr(), cnt.data_ptr(),
        None if steps is None else steps.data_ptr(), _build.stream(dev))
    find_mems.launches += 1
    return _result(t, se, bwt, size, cnt, steps, capacity, with_stats)


find_mems.launches = 0


def find_mems_plain(t: RIndexTables, codes, lengths, min_len: int,
                    min_occ: int, capacity: int = 32, with_stats: bool = False,
                    **seed_kw):
    """The plain version: all reads in lockstep, one extension per active
    read per iteration, per-read table reads by direct indexing."""
    padded, max_iters = _prepare(codes)
    B, W = padded.shape
    seeds = resolve_seeds_plain(B, W, min_occ, **seed_kw)
    L = W - 1
    dev = padded.device
    M = capacity
    lane = torch.arange(B, device=dev)
    lens = lengths.long()
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    phase, x, j, k, kp, s, k2, kp2, s2, cnt, steps = (z.clone() for _ in range(11))
    se = torch.zeros((B, M), dtype=torch.int32, device=dev)
    bwt = torch.zeros((B, M), dtype=torch.int64, device=dev)
    size = torch.zeros((B, M), dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        if not bool((phase != 4).any()):
            break
        # phase 0: begin a find_mems_function call at x; phase 5: step 3
        p0 = phase == 0
        finished = p0 & ((x >= lens) | (lens - x < min_len))
        enter1 = p0 & ~finished
        enter3 = phase == 5
        phase = torch.where(finished, 4, torch.where(enter1, 1, phase))
        phase = torch.where(enter3, 3, phase)
        j = torch.where(enter1, x + min_len - 1, j)
        k = torch.where(enter1, 0, k)
        kp = torch.where(enter1, 0, kp)
        s = torch.where(enter1, t.n, s)
        if seeds is not None:
            widx = torch.where(enter1, x + min_len - 1, j).clamp(0, L)
            rk, rkp, rs, rl = seeds[lane, widx].long().unbind(1)
            okrow = (rs >= min_occ) & (rs > 0) & (rl > 0)
            can1 = enter1 & (min_len > rl) & okrow
            can3 = enter3 & (j - rl > x) & okrow
            j = torch.where(can1, x + min_len - 1 - rl,
                            torch.where(can3, j - rl, j))
            can = can1 | can3
            k = torch.where(can, rk, k)
            kp = torch.where(can, rkp, kp)
            s = torch.where(can, rs, s)

        # one extension step for every active read
        p1, p2, p3 = phase == 1, phase == 2, phase == 3
        act = p1 | p2 | p3
        c = padded[lane, j.clamp(0, L)]
        nk, nkp, ns = extend_plain(t, k, kp, s, c, forward=p2)
        fail = act & ((ns < min_occ) | (ns <= 0))

        # transitions (mems.py:213-281)
        p1_fail = p1 & fail
        p1_ok = p1 & ~fail
        p1_boundary = p1_ok & ((j == x) | (j == 0))
        p1_cont = p1_ok & ~p1_boundary
        e1 = x + min_len
        p1_to3 = p1_boundary & (e1 >= lens)
        p1_to2 = p1_boundary & ~(e1 >= lens)
        p2_fail = p2 & fail
        p2_ok = p2 & ~fail
        p2_to3 = p2_ok & (j + 1 >= lens)
        p2_cont = p2_ok & ~p2_to3
        p3_fail = p3 & fail
        p3_ok = p3 & ~fail
        p3_done = p3_ok & (j - 1 == x)
        p3_cont = p3_ok & ~p3_done

        upd2 = p1_boundary | p2_ok  # bint2 bookkeeping
        k2 = torch.where(upd2, nk, k2)
        kp2 = torch.where(upd2, nkp, kp2)
        s2 = torch.where(upd2, ns, s2)

        emit = p1_to3 | p2_fail | p2_to3
        e_val = torch.where(p1_to3, e1, torch.where(p2_fail, j, lens))
        put = emit & (cnt < M)
        rows, cols = lane[put], cnt[put]
        se[rows, cols] = (x[put].to(torch.int32) << 16) | e_val[put].to(torch.int32)
        bwt[rows, cols] = k2[put]
        size[rows, cols] = s2[put]
        cnt = cnt + emit.long()

        x_new = torch.where(p1_fail | p3_fail, j + 1,
                            torch.where(p3_done, x + 1, x))
        phase = torch.where(p1_fail | p3_fail | p3_done, 0, phase)
        phase = torch.where(p1_to2, 2, phase)
        phase = torch.where(emit, 5, phase)
        j = torch.where(p1_cont | p3_cont, j - 1, j)
        j = torch.where(p1_to2 | p1_to3, e1, j)
        j = torch.where(p2_cont, j + 1, j)
        j = torch.where(p2_to3, lens, j)
        keep_new = p1_cont | p1_to2 | p2_cont | p3_cont
        k = torch.where(keep_new, nk, k)
        kp = torch.where(keep_new, nkp, kp)
        s = torch.where(keep_new, ns, s)
        k = torch.where(emit, 0, k)  # step 3 restarts from the full interval
        kp = torch.where(emit, 0, kp)
        s = torch.where(emit, t.n, s)
        x = x_new
        steps = steps + act.long()
    return _result(t, se, bwt, size, cnt.to(torch.int32),
                   steps.to(torch.int32), capacity, with_stats)
