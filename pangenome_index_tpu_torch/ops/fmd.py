"""K2: batched bidirectional FMD extension (csrc/fmd.cu).

Counterpart of pangenome_index_tpu/ops/fmd.py:extend. Per lane, with
r = rank6 at the backward interval start bk and at bk + s:
    delta = r(bk + s) - r(bk);  s' = delta[c];  k' = r(bk)[c] + C[c]
    kp' = bkp + exclusive-prefix(delta[COMP_CODE])[comp(c)]
Forward lanes swap k/kp and complement the code; failed lanes (s' <= 0)
return (0, 0, 0). The rank provider is the table's, in ops/rank.py:rank6's
order: checkpoint rows, ultra rows, dense records, bucketed runs. The kernel
reads the checkpoint rows in their bit-plane form (tables.ckpt_planes), at
int32 positions or, past 2^31, at int64 over two-level rows (with
tables.super_S); ultra rows at int32 positions; dense records and bucketed
runs at either.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.alphabet import COMP_CODE
from .dense_rank import dense_args
from .rank import bucket_args, ultra_args
from .rank import rank6 as rank6_plain
from .tables import MAX_SUPER, RIndexTables


def extend_plain(t: RIndexTables, k, kp, s, code, forward=None, rank6_fn=None):
    """Plain extension; the 6-wide selects are one-hot, as in the JAX code,
    so codes outside 0..5 behave alike. rank6_fn(pos) -> [B, 6] overrides
    the tables' rank provider (the model-sharded engine's, as the JAX
    extend's rank6_fn); it is asked for (bk, bk + s) as one batch of 2B
    positions."""
    dev = k.device
    if forward is None:
        forward = torch.zeros(k.shape, dtype=torch.bool, device=dev)
    bk = torch.where(forward, kp, k)
    rank = rank6_fn or (lambda pos: rank6_plain(t, pos))
    both = rank(torch.cat((bk, bk + s)))  # one batch for both ends
    return extend_from_ranks(t.C, k, kp, s, code, forward, both[: k.shape[0]],
                             both[k.shape[0]:])


def extend_from_ranks(C, k, kp, s, code, forward, r_k, r_ks):
    """The extension of (k, kp, s) by `code` given rank6 at the backward
    interval's ends: r_k at bk, r_ks at bk + s ([B, 6] each; bk = kp on
    forward lanes, k on the others). C: the index's [7] prefix counts."""
    dev = k.device
    sym6 = torch.arange(6, device=dev)[None, :]
    comp = torch.as_tensor(COMP_CODE, dtype=torch.int64, device=dev)
    code = code.long()
    oh_code = sym6 == code[:, None]
    comp_val = torch.where(oh_code, comp[None, :], 0).sum(dim=1)
    ext_code = torch.where(forward, comp_val, code)
    comp_ext = torch.where(forward, code, comp_val)
    oh = sym6 == ext_code[:, None]
    bkp = torch.where(forward, k, kp)
    delta = r_ks - r_k
    pdelta = delta[:, comp]
    excl = torch.cumsum(pdelta, dim=1) - pdelta
    nkp = bkp + torch.where(sym6 == comp_ext[:, None], excl, 0).sum(dim=1)
    ns = torch.where(oh, delta, 0).sum(dim=1)
    nk = torch.where(oh, r_k + C[None, :6], 0).sum(dim=1)
    ok = ns > 0
    nk, nkp, ns = (torch.where(ok, a, 0).to(k.dtype) for a in (nk, nkp, ns))
    return (torch.where(forward, nkp, nk), torch.where(forward, nk, nkp), ns)


def check_kernel_tables(t: RIndexTables) -> None:
    """The kernels take checkpoint rows at int32 positions (single-level
    rows, n < 2^31) or int64 positions (two-level rows past 2^31, or
    single-level), ultra rows at int32 positions, and dense records (int32
    lines beside records of the position dtype) and bucketed runs at
    either; base tables (no bucket_lo) they refuse."""
    if t.pos_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the CUDA kernels take int32 or int64 positions, "
                         f"not {t.pos_dtype}")
    if t.ckpt is None:
        if t.rank_table is None and t.rec is None and t.bucket_lo is None:
            raise ValueError("tables carry neither checkpoint rows, ultra rows, "
                             "dense records nor bucket_lo: no rank table the "
                             "kernels read")
        rank_args(t)  # checks the provider's tables
        return
    if t.ckpt_planes is None:
        raise ValueError("checkpoint tables lack ckpt_planes "
                         "(ops/tables.py:derive_rank_planes)")
    if t.pos_dtype == torch.int32:
        if t.ckpt_super is not None:
            raise ValueError("two-level checkpoint rows take int64 positions "
                             "(rindex_to_device(..., dtype=torch.int64))")
        return
    if t.super_S is None:
        raise ValueError("int64 checkpoint tables lack super_S "
                         "(ops/tables.py:derive_super_S)")
    if t.super_S.shape[0] > MAX_SUPER:
        raise ValueError(f"{t.super_S.shape[0]} superblocks: the kernels take "
                         f"at most {MAX_SUPER} (2^{t.super_shift} positions each)")


def rank_args(t: RIndexTables) -> tuple[str, tuple]:
    """(entry point suffix, leading C arguments) of the table's rank
    provider, in ops/rank.py:rank6's order: "ckpt" (int32 positions),
    "ckpt64" (int64 positions, with the superblock bases), "ultra", "dense"
    (the lines and records; int32) or "dense64" (int64), "bucketed" (int32)
    or "bucketed64" (int64)."""
    dev = t.device
    if t.ckpt is not None:
        planes = (_build.check("ckpt_planes", t.ckpt_planes, torch.int32, dev),
                  t.ckpt_planes.shape[0])
        if t.pos_dtype == torch.int32:
            return "ckpt", planes
        return "ckpt64", (*planes, _build.check("super_S", t.super_S, torch.int64, dev),
                          t.super_S.shape[0], t.super_shift)
    if t.rank_table is not None:
        return "ultra", ultra_args(t)
    if t.rec is not None:
        return ("dense" if t.pos_dtype == torch.int32 else "dense64"), dense_args(t)
    if t.bucket_lo is None:
        raise ValueError("base tables (no bucket_lo): the kernels rank through "
                         "bucketed runs only")
    return ("bucketed" if t.pos_dtype == torch.int32 else "bucketed64"), bucket_args(t)


def extend(t: RIndexTables, k, kp, s, code, forward=None):
    """k, kp, s: [B] in the tables' position dtype, code: [B] (int32 on the
    card); forward: bool [B] or None (all backward). Returns the extended
    (k, kp, s)."""
    if k.device.type == "cpu":
        return extend_plain(t, k, kp, s, code, forward)
    check_kernel_tables(t)
    dev = t.device
    pd = t.pos_dtype
    B = k.shape[0]
    kind, rargs = rank_args(t)
    out = [torch.empty(B, dtype=pd, device=dev) for _ in range(3)]
    fwd = None if forward is None else \
        _build.check("forward", forward, torch.bool, dev)
    _build.launch(f"pgt_extend_{kind}", *rargs,
                  _build.check("C", t.C, pd, dev),
                  _build.check("k", k, pd, dev),
                  _build.check("kp", kp, pd, dev),
                  _build.check("s", s, pd, dev),
                  _build.check("code", code, torch.int32, dev), fwd, B,
                  *(o.data_ptr() for o in out), _build.stream(dev))
    extend.launches += 1
    return tuple(out)


extend.launches = 0
