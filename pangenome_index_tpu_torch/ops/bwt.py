"""The multi-string BWT built on the device by prefix doubling
(csrc/bwt.cu).

The counterpart of pangenome_index_tpu/ops/bwt.py (_rerank,
_doubling_round, rotation_order_device, bwt_from_lines_device), with its
contract: the text is the lines, each followed by a separator; a symbol's
key is its byte + L, line i's separator has key i (distinct separators,
ordered by line, as the oracle and grlBWT order the endmarkers); the
rotations of the whole text are sorted, and the BWT, the document array and
the suffix positions are read off the order.

The rounds: rank = the dense rank of the keys (a sort at k = 0), then for
k = 1, 2, 4, ... the dense rank of (rank[i], rank[(i + k) mod n]) until the
ranks are distinct. Only the rank array after each round is fixed (the JAX
sort is not stable and ties rank equal); here each round is

  bwt_sort_pairs  the pair keys, rank[i] << bits | rank[(i + k) mod n] (at
                  k = 0 the key alone), with payload i, sorted by the
                  kernels' onesweep LSD radix sort over their significant
                  bits (one up-front pass that forms the keys and counts
                  every pass's digits, then one launch a digit pass);
  bwt_rerank      bumps where adjacent sorted keys differ, their inclusive
                  scan stored to rank[order[j]] through pairs grouped by
                  destination (two launches), and the largest rank, whose
                  4 bytes the host reads (the round's one sync);

and the build ends with bwt_finish, which reads the BWT symbol, line and
offset of every row off the rotation order: the payload of the last
round's sort (the round whose largest rank is n - 1, so every adjacent
sorted key differs and payload j is the rotation of rank j), kept by
rotation_rank; no inverse of the ranks is formed. Each wrapper launches its
kernels for CUDA tensors (and counts each C entry point it calls in
`launches`: one a call for the sort, two for the rerank and the finish) and
runs its plain PyTorch version (torch.sort, cumsum, scatter, gathers) for
CPU tensors. No fallback: a card
build that fails raises; a text of n >= 2^31 - 1 is refused (the int64 form
is not written); a build the card's free memory would not hold raises
MemoryError before it allocates.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils.alphabet import NENDMARKER
from .mertable import device_budget

#: keys a tile of the sort and the rerank (csrc/bwt.cu:kTile)
TILE = 4096
#: the widest digit a radix pass sorts by (csrc/bwt.cu:kMaxDigitBits)
MAX_DIGIT_BITS = 8
#: device bytes a character of the text costs the build at its peak (the
#: symbol keys and the rank 4 + 4, a round's new rank 4, the sort's two
#: key and payload buffers 24, its look-back words 8 a tile and digit, half
#: a byte; the rerank's grouped pairs, 8, take the key buffer the sort
#: frees; the kept payload of one round, 4, is dropped before the next
#: round's sort; the finish's keys, order, symbols and outputs, 4 + 4 + 1 +
#: 17, fit in the same), rounded up
BYTES_PER_CHAR = 37
#: the rerank's store goes out in at most 2^GROUP_BITS destination groups
#: (csrc/bwt.cu:kGroupBits)
GROUP_BITS = 10


def _check_n(n: int) -> None:
    if n >= 2**31 - 1:
        raise ValueError("n >= 2^31 - 1: the port's BWT kernels take int32 "
                         "ranks (the int64 form is not written)")


def sort_passes(k: int, bits: int) -> int:
    """Radix passes of a round: the key's significant bits (2 bits, or bits
    at k = 0) in passes of at most MAX_DIGIT_BITS."""
    return -(-(bits * (2 if k else 1)) // MAX_DIGIT_BITS)


def digit_bits(k: int, bits: int) -> int:
    """The digit width of a round's passes: the narrowest that sorts the
    key's significant bits in sort_passes(k, bits) passes (the last digit
    may be partial)."""
    return -(-(bits * (2 if k else 1)) // sort_passes(k, bits))


def rerank_group_shift(n: int) -> int:
    """log2 of the destinations a group of the rerank's partitioned store
    holds: the least shift that cuts 0 .. n - 1 into at most 2^GROUP_BITS
    groups."""
    return max((n - 1).bit_length() - GROUP_BITS, 0)


def rerank_groups(n: int) -> int:
    """The rerank's destination groups over 0 .. n - 1."""
    return ((n - 1) >> rerank_group_shift(n)) + 1


def pair_keys(rank: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """The int64 sort keys of round k, unsorted: rank[i] << bits |
    rank[(i + k) mod n] (k = 0: rank[i])."""
    keys = rank.long()
    if k:
        keys = (keys << bits) | torch.roll(rank, -k).long()  # rank[(i + k) mod n]
    return keys


def bwt_sort_pairs_plain(rank: torch.Tensor, k: int, bits: int):
    """(keys [n] int64 sorted, order [n] int32 their payload i): the pair
    keys of round k (rank < 2^bits), stably sorted."""
    keys, order = torch.sort(pair_keys(rank, k, bits), stable=True)
    return keys, order.to(torch.int32)


def bwt_rerank_plain(keys: torch.Tensor, order: torch.Tensor):
    """(rank [n] int32, top [1] int32): rank[order[j]] = the number of
    adjacent key changes up to j, top the largest."""
    bumps = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    bumps[1:] = torch.cumsum((keys[1:] != keys[:-1]).to(torch.int32), 0)
    rank = torch.empty_like(bumps).scatter_(0, order.long(), bumps)
    return rank, bumps[-1:].clone()


def bwt_finish_plain(order: torch.Tensor, keys: torch.Tensor,
                     line_starts: torch.Tensor):
    """order [n] int32 the rotation order (a permutation of 0 .. n - 1),
    keys [n] int32 the symbol keys, line_starts [L + 1] int64 (the last is
    n) -> (bwt [n] uint8, da [n] int64, sa_pos [n] int64): row j's BWT byte
    (that of the key before order[j], cyclically; the endmarker for a
    separator), the line holding order[j] and its offset there."""
    n, L = order.shape[0], line_starts.shape[0] - 1
    o = order.long()
    prev = keys[(o - 1) % n].long()
    bwt = torch.where(prev >= L, prev - L, NENDMARKER).to(torch.uint8)
    da = torch.searchsorted(line_starts, o, right=True) - 1
    return bwt, da, o - line_starts[da]


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def bwt_sort_pairs(rank: torch.Tensor, k: int, bits: int):
    """bwt_sort_pairs_plain; on the card the kernels' onesweep radix sort
    (sort_passes(k, bits) passes of digit_bits(k, bits) bits), the plain
    version on the CPU."""
    n = rank.shape[0]
    _need(rank.dim() == 1 and rank.dtype == torch.int32 and 1 <= n < 2**31 - 1
          and 0 <= k < n and 1 <= bits <= 31,
          "bwt_sort_pairs: rank must be int32 [n], 1 <= n < 2^31 - 1, "
          "0 <= k < n, 1 <= bits <= 31")
    if rank.device.type == "cpu":
        return bwt_sort_pairs_plain(rank, k, bits)
    dev = rank.device
    passes, dbits = sort_passes(k, bits), digit_bits(k, bits)
    keys = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    vals = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    hist = torch.empty(passes << dbits, dtype=torch.int32, device=dev)
    state = torch.empty((-(-n // TILE) << dbits) + passes, dtype=torch.int64, device=dev)
    _build.launch("pgt_bwt_sort_pairs", _build.check("rank", rank, torch.int32, dev),
                  n, k, bits, passes, dbits, keys[0].data_ptr(), vals[0].data_ptr(),
                  keys[1].data_ptr(), vals[1].data_ptr(), hist.data_ptr(),
                  state.data_ptr(), _build.stream(dev))
    bwt_sort_pairs.launches += 1
    last = (passes - 1) & 1
    return keys[last], vals[last]


bwt_sort_pairs.launches = 0


def bwt_rerank(keys: torch.Tensor, order: torch.Tensor):
    """bwt_rerank_plain; on the card two launches, each counted in
    `launches` (the bumps, their scan by decoupled look-back and the pairs
    (order[j], scan[j]) stored grouped by destination; then each group's
    slice of rank filled in shared memory and stored whole), the plain
    version on the CPU.
    order must be a permutation of 0 .. n - 1, as the sort's payload is."""
    n = keys.shape[0]
    _need(keys.dim() == 1 and keys.dtype == torch.int64 and order.shape == keys.shape
          and order.dtype == torch.int32 and 1 <= n < 2**31 - 1,
          "bwt_rerank: keys must be int64 [n] and order int32 [n], 1 <= n < 2^31 - 1")
    if keys.device.type == "cpu":
        return bwt_rerank_plain(keys, order)
    dev = keys.device
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    top = torch.empty(1, dtype=torch.int32, device=dev)
    pairs = torch.empty(n, dtype=torch.int64, device=dev)
    # the look-back words, the ticket, a 128-byte line a group's cursor
    state = torch.empty(-(-n // TILE) + 1 + 16 * rerank_groups(n), dtype=torch.int64,
                        device=dev)
    shift = rerank_group_shift(n)
    _build.launch("pgt_bwt_rerank_group", _build.check("keys", keys, torch.int64, dev),
                  _build.check("order", order, torch.int32, dev), n, shift,
                  pairs.data_ptr(), top.data_ptr(), state.data_ptr(), _build.stream(dev))
    bwt_rerank.launches += 1
    _build.launch("pgt_bwt_rerank_scatter", pairs.data_ptr(), n, shift, rank.data_ptr(),
                  _build.stream(dev))
    bwt_rerank.launches += 1
    return rank, top


bwt_rerank.launches = 0


def bwt_finish(order: torch.Tensor, keys: torch.Tensor, line_starts: torch.Tensor):
    """bwt_finish_plain; on the card two launches, each counted in
    `launches` (every key's BWT byte into an n-byte array, read coalesced;
    then per row order[j] read coalesced, its byte gathered from that array,
    its line found among the line starts and the three outputs written),
    the plain version on the CPU.
    order must be a permutation of 0 .. n - 1, as the last round's sort
    payload is."""
    n, L = order.shape[0], line_starts.shape[0] - 1
    _need(order.dim() == 1 and order.dtype == torch.int32 and keys.shape == order.shape
          and keys.dtype == torch.int32 and line_starts.dtype == torch.int64
          and 1 <= L <= n < 2**31 - 1,
          "bwt_finish: order and keys must be int32 [n] and line_starts int64 "
          "[L + 1], 1 <= L <= n < 2^31 - 1")
    if order.device.type == "cpu":
        return bwt_finish_plain(order, keys, line_starts)
    dev = order.device
    sym = torch.empty(n, dtype=torch.uint8, device=dev)
    bwt = torch.empty(n, dtype=torch.uint8, device=dev)
    da = torch.empty(n, dtype=torch.int64, device=dev)
    sa_pos = torch.empty(n, dtype=torch.int64, device=dev)
    _build.launch("pgt_bwt_finish_symbols", _build.check("keys", keys, torch.int32, dev),
                  n, L, sym.data_ptr(), _build.stream(dev))
    bwt_finish.launches += 1
    _build.launch("pgt_bwt_finish_read_off", _build.check("order", order, torch.int32, dev),
                  sym.data_ptr(), n,
                  _build.check("line_starts", line_starts, torch.int64, dev), L,
                  bwt.data_ptr(), da.data_ptr(), sa_pos.data_ptr(), _build.stream(dev))
    bwt_finish.launches += 1
    return bwt, da, sa_pos


bwt_finish.launches = 0


def doubling_round(rank: torch.Tensor, k: int, bits: int):
    """(rank [n] int32, top [1] int32, order [n] int32) after round k (k =
    0: the dense rank of the keys `rank`) through the wrappers; bits: the
    bit length of the largest value of `rank`. order is the round's sort
    payload: once top reads n - 1 it is the rotation order."""
    keys, order = bwt_sort_pairs(rank, k, bits)
    rank, top = bwt_rerank(keys, order)
    return rank, top, order


def doubling_round_plain(rank: torch.Tensor, k: int, bits: int):
    """doubling_round through the plain versions (torch.sort), on any device."""
    keys, order = bwt_sort_pairs_plain(rank, k, bits)
    return (*bwt_rerank_plain(keys, order), order)


def rotation_rank(keys: torch.Tensor, top_key: int, round_fn=doubling_round):
    """The rounds of the JAX loop on keys [n] int32 (top_key: their largest
    value): the initial sort, then k = 1, 2, 4, ... while k < n, stopping
    once the ranks are distinct. Returns (rank [n] int32, its largest
    value, the last round's sort payload: the rotation order where that
    value is n - 1). Only the last round's payload is kept: each is dropped
    before the next round's sort."""
    n = keys.shape[0]
    rank, top, order = round_fn(keys, 0, max(1, top_key.bit_length()))
    top = int(top)
    k = 1
    while k < n:
        order = None  # before the round's sort: the peak of BYTES_PER_CHAR
        rank, top, order = round_fn(rank, k, max(1, top.bit_length()))
        top = int(top)  # the round's 4-byte read
        if top == n - 1:
            break
        k *= 2
    return rank, top, order


def _keys_tensor(keys: np.ndarray, device) -> tuple[torch.Tensor, int]:
    keys = np.ascontiguousarray(keys)
    _check_n(keys.size)
    _need(keys.size >= 1 and int(keys.min()) >= 0 and int(keys.max()) < 2**31,
          "rotation keys must be at least one, each in [0, 2^31)")
    return torch.from_numpy(keys.astype(np.int32)).to(device), int(keys.max())


def rotation_order_device(keys: np.ndarray, device="cuda") -> np.ndarray:
    """Permutation sorting all rotations of `keys` (host in, host out), the
    rounds on `device`. Where the rotations are not all distinct (a periodic
    text) the order is the stable argsort of the last ranks, as the JAX
    function's."""
    keys_t, top_key = _keys_tensor(keys, device)
    n = keys_t.shape[0]
    rank, top, order = rotation_rank(keys_t, top_key)
    if top != n - 1:
        return bwt_sort_pairs(rank, 0, max(1, top.bit_length()))[1].cpu().numpy()
    return order.cpu().numpy()


def rotation_order_plain(keys: np.ndarray) -> np.ndarray:
    """rotation_order_device through the plain rounds (torch.sort) on the
    CPU."""
    keys_t, top_key = _keys_tensor(keys, "cpu")
    rank = rotation_rank(keys_t, top_key, doubling_round_plain)[0]
    return torch.argsort(rank, stable=True).to(torch.int32).numpy()


def text_keys(lines: list[bytes]):
    """(keys [n] int32: a byte + L, line i's separator i; line_starts [L + 1]
    int64; seq_lengths [L] int64 incl. the separator; the largest key)."""
    L = len(lines)
    _need(L >= 1, "the BWT build takes at least one line")
    seq_lengths = np.array([len(l) + 1 for l in lines], np.int64)
    line_starts = np.zeros(L + 1, np.int64)
    np.cumsum(seq_lengths, out=line_starts[1:])
    _check_n(int(line_starts[-1]))
    text = np.frombuffer(b"\0".join(lines) + b"\0", np.uint8)
    keys = text.astype(np.int32)
    keys += L
    keys[line_starts[1:] - 1] = np.arange(L, dtype=np.int32)
    return keys, line_starts, seq_lengths, int(keys.max())


def bwt_tensors(lines: list[bytes], device="cuda"):
    """The BWT build on `device`, its results left there: (bwt uint8 [n],
    da int64 [n], sa_pos int64 [n] as tensors on `device`, seq_lengths
    int64 [L] on the host)."""
    keys, line_starts, seq_lengths, top_key = text_keys(lines)
    n = keys.size
    dev = torch.device(device)
    budget = device_budget(dev)
    if budget is not None and BYTES_PER_CHAR * n > budget:
        raise MemoryError(f"device BWT build: {n} characters need "
                          f"{BYTES_PER_CHAR * n} bytes, the device has {budget} free")
    keys_t = torch.from_numpy(keys).to(dev)
    rank, top, order = rotation_rank(keys_t, top_key)
    if top != n - 1:  # distinct separators make every rotation distinct
        raise RuntimeError(f"BWT rounds ended with {top + 1} distinct ranks "
                           f"of {n}")
    del rank
    bwt, da, sa_pos = bwt_finish(order, keys_t, torch.from_numpy(line_starts).to(dev))
    return bwt, da, sa_pos, seq_lengths


def bwt_from_lines_device(lines: list[bytes], device="cuda"):
    """Multi-string BWT of the lines (each taken as '\\n'-terminated), built
    on `device`: (bwt uint8 [n], da int64 [n], sa_pos int64 [n],
    seq_lengths int64 [L]), the JAX function's arrays."""
    bwt, da, sa_pos, seq_lengths = bwt_tensors(lines, device)
    return bwt.cpu().numpy(), da.cpu().numpy(), sa_pos.cpu().numpy(), seq_lengths
