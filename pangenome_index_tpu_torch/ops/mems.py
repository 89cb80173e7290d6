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

import ctypes
from typing import NamedTuple

import torch

from .. import _build, spans
from . import shard_rank
from .dense_rank import gather_rows_plain
from .fmd import check_kernel_tables, extend_from_ranks, extend_plain, rank_args
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


def unpack_start_end(se, pd):
    """(start, end) in dtype pd of the packed (start << 16) | end [B, M]
    int32: both 16-bit fields unsigned, so that a start past 32767 (its top
    bit the int32's sign) decodes as itself."""
    return ((se >> 16) & 0xFFFF).to(pd), (se & 0xFFFF).to(pd)


def _result(pd, se, bwt, size, cnt, steps, capacity, with_stats):
    res = MemResult(*unpack_start_end(se, pd), bwt.to(pd), size.to(pd), cnt, cnt > capacity)
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
    dtype); on the CPU: the plain version. Spans (spans.py): mems.find, and
    inside it mems.resolve_seeds and mems.k3, each with a device interval.
    While a recording is open, the counters of the launch (count_k3)."""
    counting = spans.recording_now()
    with spans.span("mems.find", device=True):
        if codes.device.type == "cpu":
            res, stats = find_mems_plain(t, codes, lengths, min_len, min_occ, capacity,
                                         True, **seed_kw)
            kind = None
        else:
            res, stats, kind = _find_mems_card(t, codes, lengths, min_len, min_occ, capacity,
                                               with_stats or counting, seed_kw)
    if counting:
        count_k3(lengths, stats["steps"], kind)
    return (res, stats) if with_stats else res


def _find_mems_card(t, codes, lengths, min_len, min_occ, capacity, with_steps, seed_kw):
    """find_mems on the card: (MemResult, {"steps": [B] or None}, the rank
    provider's entry suffix)."""
    check_kernel_tables(t)
    dev = t.device
    pd = t.pos_dtype
    padded, max_iters = _prepare(codes, align=8)  # the kernel reads 8 codes a load
    B, W = codes.shape[0], codes.shape[1] + 1
    kind, rargs = rank_args(t)
    with spans.span("mems.resolve_seeds", device=True):
        seeds = resolve_seeds(B, W, min_occ, **seed_kw)
    if seeds is not None and seeds.dtype != pd:
        raise ValueError(f"find_mems: seed tables of {seeds.dtype} beside tables "
                         f"of {pd} positions")
    with spans.span("mems.k3", device=True):
        se = torch.zeros((B, capacity), dtype=torch.int32, device=dev)
        bwt, size = torch.zeros((2, B, capacity), dtype=pd, device=dev)
        cnt = torch.empty(B, dtype=torch.int32, device=dev)
        steps = torch.empty(B, dtype=torch.int32, device=dev) if with_steps else None
        _build.launch(
            f"pgt_find_mems_{kind}", *rargs,
            _build.check("C", t.C, pd, dev), padded.data_ptr(),
            _build.check("lengths", lengths, torch.int32, dev),
            None if seeds is None else seeds.data_ptr(), B, W, padded.shape[1],
            int(min_len), int(min_occ), t.n, capacity, max_iters, se.data_ptr(),
            bwt.data_ptr(), size.data_ptr(), cnt.data_ptr(),
            None if steps is None else steps.data_ptr(), _build.stream(dev))
        find_mems.launches += 1
    res, stats = _result(pd, se, bwt, size, cnt, steps, capacity, True)
    return res, stats, kind


find_mems.launches = 0

_resident: dict[tuple[str, int], int] = {}


def resident_lanes(kind: str, device) -> int:
    """The reads K3's instantiation for the rank provider `kind` (rank_args'
    suffix) keeps resident on the whole card at once: its blocks a
    multiprocessor by the CUDA occupancy API (pgt_find_mems_resident_<kind>),
    times its threads a block, times the multiprocessors. Asked once a kind
    and card."""
    dev = torch.device(device)
    key = (kind, dev.index if dev.index is not None else torch.cuda.current_device())
    if key not in _resident:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(key[1]):
            _build.launch(f"pgt_find_mems_resident_{kind}", ctypes.addressof(per_sm))
        sms = torch.cuda.get_device_properties(key[1]).multi_processor_count
        _resident[key] = per_sm.value * sms
    return _resident[key]


def count_k3(lengths, steps, kind: str | None) -> None:
    """The counters of one K3 launch (or its plain version) over lengths [B]
    with its steps [B] (spans.py): mems.k3.lanes, the reads; mems.k3.bases,
    the sum of their lengths; mems.k3.steps and mems.k3.max_steps, the sum
    and the largest of their extension steps (both reduced on the device
    after the call, spans.count_later); mems.k3.resident_lanes, the reads
    the engine keeps in flight at once: on the card resident_lanes of the
    instantiation `kind`, in the plain version (kind None), whose lockstep
    advances every read of the batch together, the batch's reads."""
    B = lengths.shape[0]
    spans.count("mems.k3.lanes", B)
    spans.count("mems.k3.resident_lanes",
                B if kind is None else resident_lanes(kind, lengths.device))
    spans.count_later("mems.k3.bases", lengths, "sum")
    spans.count_later("mems.k3.steps", steps, "sum")
    if B:  # an empty batch has no longest read
        spans.count_later("mems.k3.max_steps", steps, "max")


def find_mems_plain(t: RIndexTables, codes, lengths, min_len: int,
                    min_occ: int, capacity: int = 32, with_stats: bool = False,
                    rank6_fn=None, **seed_kw):
    """The plain version: all reads in lockstep, one extension per active
    read per iteration, per-read table reads by direct indexing.
    rank6_fn(pos) -> [2B, 6] overrides the tables' rank provider, as the
    JAX find_mems_impl's rank6_fn does (the model-sharded engine's; t then
    gives only C and n)."""
    padded, max_iters = _prepare(codes)
    B, W = padded.shape
    with spans.span("mems.resolve_seeds", device=True):
        seeds = resolve_seeds_plain(B, W, min_occ, **seed_kw)
    with spans.span("mems.k3", device=True):
        st = _Lockstep(padded, lengths, seeds, W - 1, min_len, min_occ, t.n, capacity)
        for _ in range(max_iters):
            if not bool((st.phase != 4).any()):
                break
            st.enter()
            p2 = st.phase == 2
            nk, nkp, ns = extend_plain(t, st.k, st.kp, st.s, st.code(), forward=p2,
                                       rank6_fn=rank6_fn)
            st.advance(nk, nkp, ns)
    return _result(t.pos_dtype, st.se, st.bwt, st.size, st.cnt.to(torch.int32),
                   st.steps.to(torch.int32), capacity, with_stats)


class _Lockstep:
    """The state of the lockstep MEM state machine (mems.py:43-283 of the
    JAX package) over B reads, every field an int64 [B] tensor but the
    buffers: phase (0 start a call at x, 1..3 the steps, 4 done, 5 step 3
    next), x, j, the interval k, kp, s, the last complete one k2, kp2, s2,
    the MEM count and steps; se [B, M] int32 ((start << 16) | end), bwt and
    size [B, M] int64. enter() and advance() are the two halves of one
    iteration, around its extension."""

    FIELDS = ("phase", "x", "j", "k", "kp", "s", "k2", "kp2", "s2", "cnt", "steps")

    def __init__(self, padded, lengths, seeds, L, min_len, min_occ, n, capacity):
        B = padded.shape[0]
        dev = padded.device
        self.padded, self.seeds = padded, seeds
        self.lens = lengths.long()
        self.min_len, self.min_occ, self.n, self.M = min_len, min_occ, n, capacity
        self.L = L
        self.lane = torch.arange(B, device=dev)
        z = torch.zeros(B, dtype=torch.int64, device=dev)
        for f in self.FIELDS:
            setattr(self, f, z.clone())
        self.se = torch.zeros((B, capacity), dtype=torch.int32, device=dev)
        self.bwt = torch.zeros((B, capacity), dtype=torch.int64, device=dev)
        self.size = torch.zeros((B, capacity), dtype=torch.int64, device=dev)

    def code(self):
        """Each read's code at j (the NUL pad at j == length)."""
        return self.padded[self.lane, self.j.clamp(0, self.L)]

    def enter(self):
        """Phase 0 begins a find_mems_function call at x, phase 5 step 3;
        both are seeded from the resolved seed tiers."""
        phase, x, j, lens, min_len = self.phase, self.x, self.j, self.lens, self.min_len
        p0 = phase == 0
        finished = p0 & ((x >= lens) | (lens - x < min_len))
        enter1 = p0 & ~finished
        enter3 = phase == 5
        phase = torch.where(finished, 4, torch.where(enter1, 1, phase))
        self.phase = torch.where(enter3, 3, phase)
        j = torch.where(enter1, x + min_len - 1, j)
        k = torch.where(enter1, 0, self.k)
        kp = torch.where(enter1, 0, self.kp)
        s = torch.where(enter1, self.n, self.s)
        if self.seeds is not None:
            widx = torch.where(enter1, x + min_len - 1, j).clamp(0, self.L)
            rk, rkp, rs, rl = self.seeds[self.lane, widx].long().unbind(1)
            okrow = (rs >= self.min_occ) & (rs > 0) & (rl > 0)
            can1 = enter1 & (min_len > rl) & okrow
            can3 = enter3 & (j - rl > x) & okrow
            j = torch.where(can1, x + min_len - 1 - rl,
                            torch.where(can3, j - rl, j))
            can = can1 | can3
            k = torch.where(can, rk, k)
            kp = torch.where(can, rkp, kp)
            s = torch.where(can, rs, s)
        self.j, self.k, self.kp, self.s = j, k, kp, s

    def advance(self, nk, nkp, ns):
        """The transitions and emissions (mems.py:213-281 of the JAX
        package) after the extension (nk, nkp, ns) of every read."""
        phase, x, j, lens, cnt = self.phase, self.x, self.j, self.lens, self.cnt
        nk, nkp, ns = nk.long(), nkp.long(), ns.long()
        p1, p2, p3 = phase == 1, phase == 2, phase == 3
        act = p1 | p2 | p3
        fail = act & ((ns < self.min_occ) | (ns <= 0))
        p1_fail = p1 & fail
        p1_ok = p1 & ~fail
        p1_boundary = p1_ok & ((j == x) | (j == 0))
        p1_cont = p1_ok & ~p1_boundary
        e1 = x + self.min_len
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
        self.k2 = torch.where(upd2, nk, self.k2)
        self.kp2 = torch.where(upd2, nkp, self.kp2)
        self.s2 = torch.where(upd2, ns, self.s2)

        emit = p1_to3 | p2_fail | p2_to3
        e_val = torch.where(p1_to3, e1, torch.where(p2_fail, j, lens))
        put = emit & (cnt < self.M)
        rows, cols = self.lane[put], cnt[put]
        self.se[rows, cols] = (x[put].to(torch.int32) << 16) | e_val[put].to(torch.int32)
        self.bwt[rows, cols] = self.k2[put]
        self.size[rows, cols] = self.s2[put]
        self.cnt = cnt + emit.long()

        self.x = torch.where(p1_fail | p3_fail, j + 1, torch.where(p3_done, x + 1, x))
        phase = torch.where(p1_fail | p3_fail | p3_done, 0, phase)
        phase = torch.where(p1_to2, 2, phase)
        self.phase = torch.where(emit, 5, phase)
        j = torch.where(p1_cont | p3_cont, j - 1, j)
        j = torch.where(p1_to2 | p1_to3, e1, j)
        j = torch.where(p2_cont, j + 1, j)
        self.j = torch.where(p2_to3, lens, j)
        keep_new = p1_cont | p1_to2 | p2_cont | p3_cont
        k = torch.where(keep_new, nk, self.k)
        kp = torch.where(keep_new, nkp, self.kp)
        s = torch.where(keep_new, ns, self.s)
        self.k = torch.where(emit, 0, k)  # step 3 restarts from the full interval
        self.kp = torch.where(emit, 0, kp)
        self.s = torch.where(emit, self.n, s)
        self.steps = self.steps + act.long()


class StepState(NamedTuple):
    """The device state of the lockstep engine (find_mems_lockstep) over B
    reads, updated in place by the step: phase, x, j, cnt, steps [B] int32;
    k, kp, s, k2, kp2, s2 [B] and bwt, size [B, M] of the position type; se
    [B, M] int32."""

    phase: torch.Tensor
    x: torch.Tensor
    j: torch.Tensor
    k: torch.Tensor
    kp: torch.Tensor
    s: torch.Tensor
    k2: torch.Tensor
    kp2: torch.Tensor
    s2: torch.Tensor
    cnt: torch.Tensor
    se: torch.Tensor
    bwt: torch.Tensor
    size: torch.Tensor
    steps: torch.Tensor


def step_state(B: int, capacity: int, dtype: torch.dtype, device) -> StepState:
    """A zeroed StepState for B reads (every read in phase 0 at x = 0)."""
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    i32 = torch.int32
    return StepState(phase=z(B, dt=i32), x=z(B, dt=i32), j=z(B, dt=i32), k=z(B), kp=z(B),
                     s=z(B), k2=z(B), kp2=z(B), s2=z(B), cnt=z(B, dt=i32),
                     se=z(B, capacity, dt=i32), bwt=z(B, capacity), size=z(B, capacity),
                     steps=z(B, dt=i32))


def query_positions(state: StepState):
    """(live [B], pos [2B]): the reads in a step (phases 1..3) and where
    the next iteration asks rank6, bk (kp in phase 2, else k) and bk + s,
    0 for the others; int64."""
    live = (state.phase >= 1) & (state.phase <= 3)
    bk = torch.where(state.phase == 2, state.kp, state.k).long()
    return live, torch.cat((torch.where(live, bk, 0), torch.where(live, bk + state.s.long(), 0)))


def _super_add(ranks, pos, super_base, super_shift):
    """ranks + the superblock base of each position's superblock (two-level
    rows), the superblock index clamped into the table."""
    sb = (pos.long() >> super_shift).clamp(0, super_base.shape[0] - 1)
    return ranks.long() + super_base[sb, :6].long()


def mem_step_plain(state: StepState, ranks, C, n: int, padded, lengths, seeds,
                   read_len: int, min_len: int, min_occ: int, super_base=None,
                   super_shift: int = 0) -> int:
    """One lockstep iteration, in place on `state`, by _Lockstep's halves:
    with ranks ([2B, 6]: rank6 at query_positions(state), summed over the
    shards, plus super_base's row of each position where the rows are
    two-level; None: enter the first iteration only), the extension of
    every active read and its transitions; then the entry into the next
    iteration. Returns the number of reads active after it."""
    B, M = state.se.shape
    st = _Lockstep(padded, lengths, seeds, read_len, min_len, min_occ, n, M)
    for f in _Lockstep.FIELDS:
        setattr(st, f, getattr(state, f).long())
    st.se, st.bwt, st.size = state.se.clone(), state.bwt.long(), state.size.long()
    if ranks is not None:
        r = ranks.long()
        if super_base is not None:
            r = _super_add(r, query_positions(state)[1], super_base, super_shift)
        forward = st.phase == 2
        nk, nkp, ns = extend_from_ranks(C.long(), st.k, st.kp, st.s, st.code(), forward,
                                        r[:B], r[B:])
        st.advance(nk, nkp, ns)
    st.enter()
    for f in _Lockstep.FIELDS:
        getattr(state, f).copy_(getattr(st, f))
    state.se.copy_(st.se)
    state.bwt.copy_(st.bwt)
    state.size.copy_(st.size)
    return int(((st.phase >= 1) & (st.phase <= 3)).sum())


def mem_step_fused_plain(state: StepState, ranks, shards: list, C, n: int, padded, lengths,
                         seeds, read_len: int, min_len: int, min_occ: int, super_base=None,
                         super_shift: int = 0, apply: bool = True) -> int:
    """The plain version of mem_step_fused: mem_step_plain on the summed
    ranks (none where not apply), then the shards' plain partials at the
    new query positions, summed, written over ranks (0 for reads that are
    not active). Returns the number of reads active after it."""
    live = mem_step_plain(state, ranks if apply else None, C, n, padded, lengths, seeds,
                          read_len, min_len, min_occ, super_base, super_shift)
    on, pos = query_positions(state)
    part = shard_rank.shards_rank6_plain(shards, pos.to(ranks.dtype))
    ranks.copy_(torch.where(torch.cat((on, on))[:, None], part.to(ranks.dtype), 0))
    return live


def mem_step_fused(state: StepState, ranks, shards: list, C, n: int, padded, lengths, seeds,
                   read_len: int, min_len: int, min_occ: int, super_base=None,
                   super_shift: int = 0, active=None, apply: bool = True) -> None:
    """One lockstep iteration fused with the rank partials of the next
    (csrc/memstep.cu), in place on `state`: with the summed ranks [2B, 6]
    of the position type (apply False: enter the first iteration only),
    the extension and transitions of every active read and the entry into
    the next iteration; then, in the same launch, each active read's
    partial rank6 at its two new query positions (query_positions) over the
    one of `shards` (1 to 16 CkptShard or RunShard of the position type,
    the shards this process holds) that owns each, written in place over
    ranks: the rank6 itself where the shards are the whole index; under a
    mesh the caller sums it over the model group. padded [B, stride] int8
    codes (stride >= L + 1 for reads of at most L = read_len codes, code 0
    past each read), lengths [B] int32, seeds [B, L + 1, 4] (resolve_seeds)
    or None, C [7] of the position type, super_base [n_super, 6 + shift]
    int64 or None. `active` (int32 [1], zeroed by the caller) receives the
    number of reads active after the launch. On the card one launch,
    counted where it is launched, or tallied in `captured` while a CUDA
    graph captures it (its replays count it); on the CPU
    mem_step_fused_plain."""
    if state.k.device.type == "cpu":
        live = mem_step_fused_plain(state, ranks, shards, C, n, padded, lengths, seeds,
                                    read_len, min_len, min_occ, super_base, super_shift, apply)
        if active is not None:
            active += live
        return
    dev = state.k.device
    pd = state.k.dtype
    B, M = state.se.shape
    W = read_len + 1
    if pd not in (torch.int32, torch.int64):
        raise ValueError(f"mem_step_fused: int32 or int64 positions, not {pd}")
    if lengths.shape != (B,) or padded.shape[0] != B or padded.shape[1] < W:
        raise ValueError("mem_step_fused: padded [B, stride >= read_len + 1] and lengths [B]")
    if seeds is not None and tuple(seeds.shape) != (B, W, 4):
        raise ValueError(f"mem_step_fused: seeds [{B}, {W}, 4]")
    if ranks is None or tuple(ranks.shape) != (2 * B, 6):
        raise ValueError(f"mem_step_fused: ranks [{2 * B}, 6] are read and written in place")

    def ptr(name, t, dt):
        return _build.check(name, t, dt, dev)

    sup = (None, 0, 0, 0)
    if super_base is not None:
        sup = (ptr("super_base", super_base, torch.int64), super_base.shape[0],
               super_base.shape[1], int(super_shift))
    _build.launch(
        "pgt_mem_step64" if pd == torch.int64 else "pgt_mem_step",
        ptr("ranks", ranks, pd), int(apply), *sup, ptr("C", C, pd),
        ptr("codes", padded, torch.int8), padded.shape[1],
        ptr("lengths", lengths, torch.int32),
        None if seeds is None else ptr("seeds", seeds, pd), B, W, int(min_len),
        int(min_occ), int(n), M,
        *(ptr(f, getattr(state, f), getattr(state, f).dtype) for f in StepState._fields),
        *shard_rank.shard_table(shards, pd, dev),
        None if active is None else ptr("active", active, torch.int32), _build.stream(dev))
    if torch.cuda.is_current_stream_capturing():
        mem_step_fused.captured += 1
    else:
        mem_step_fused.launches += 1


mem_step_fused.launches = 0
mem_step_fused.captured = 0

#: find_mems_lockstep reads the count of active reads every this many
#: iterations: the iterations of one CUDA graph on the card
ACTIVE_CHECK_EVERY = 8


def find_mems_lockstep(shards: list, C, n: int, codes, lengths, min_len: int, min_occ: int,
                       capacity: int = 32, with_stats: bool = False, super_base=None,
                       super_shift: int = 0, reduce=None, **seed_kw):
    """The lockstep MEM engine over model shards: the model-sharded engine
    of parallel/engine.py. `shards` are the ones this process holds
    (ops/shard_rank.py CkptShard or RunShard: every shard of the index
    where they all live on this device, else this rank's one); `reduce`,
    where given, sums their partials [2B, 6] in place over the other
    processes' shards (parallel/sharding.py:ShardedRank.reduce, the model
    group's all_reduce), after every step and inside the CUDA graph;
    two-level rows' superblock bases (super_base, super_shift) are added by
    the step, after the sum. C [7] of the position type on the reads'
    device, n the BWT size.

    An iteration is one mem_step_fused launch (the ranks of the last
    iteration's queries applied, the next queries' partials written in
    their place), then reduce, as the JAX find_mems_impl asks its rank6_fn
    inside its while_loop. The first launch only enters the first
    iteration. Then ACTIVE_CHECK_EVERY iterations at a time, the last of
    them counting the reads still active, until that count is 0 or
    _prepare's bound is passed (a finished read's iterations are no-ops):
    on the card captured once as a CUDA graph and replayed (every buffer
    made before the capture; a capture that fails raises), on the CPU run
    eagerly with the plain step. Every rank of a model group sees the same
    reads and ranks, so all leave at the same replay. Returns MemResult
    (with_stats: and {"steps": [B], "iters": iterations}), equal to
    find_mems and to find_mems_plain on the same reads."""
    dev = codes.device
    pd = C.dtype
    padded, max_iters = _prepare(codes, align=8)
    B, W = codes.shape[0], codes.shape[1] + 1
    seeds = resolve_seeds(B, W, min_occ, **seed_kw)
    if seeds is not None and seeds.dtype != pd:
        raise ValueError(f"find_mems_lockstep: seed tables of {seeds.dtype} beside "
                         f"positions of {pd}")
    lens = lengths.to(torch.int32).contiguous()
    state = step_state(B, capacity, pd, dev)
    iters = 0
    if B:
        ranks = torch.zeros((2 * B, 6), dtype=pd, device=dev)
        active = torch.zeros(1, dtype=torch.int32, device=dev)
        args = (state, ranks, shards, C, n, padded, lens, seeds, codes.shape[1], min_len,
                min_occ, super_base, super_shift)

        def step(**kw):
            mem_step_fused(*args, **kw)
            if reduce is not None:
                reduce(ranks)

        def iterations():
            for i in range(ACTIVE_CHECK_EVERY):
                last = i == ACTIVE_CHECK_EVERY - 1
                if last:
                    active.zero_()
                step(active=active if last else None)

        step(apply=False)  # under a mesh on the card, also the communicator's warm-up
        run = iterations
        if dev.type == "cuda":
            run = _graph_of(iterations, dev)
        while iters < max_iters:
            run()
            iters += ACTIVE_CHECK_EVERY
            if int(active) == 0:
                break
    res = MemResult(*unpack_start_end(state.se, pd), state.bwt,
                    state.size, state.cnt, state.cnt > capacity)
    return (res, {"steps": state.steps, "iters": iters}) if with_stats else res


def _graph_of(iterations, dev):
    """iterations() captured once as a CUDA graph on a side stream
    (thread-local capture mode, so that other threads' CUDA calls, such as
    NCCL's watchdog, do not break it); returns a function that replays it
    on the current stream and adds to mem_step_fused.launches the launches
    the capture recorded."""
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    before = mem_step_fused.captured
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            iterations()
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    per_replay = mem_step_fused.captured - before

    def replay():
        graph.replay()
        mem_step_fused.launches += per_replay

    return replay
