"""Spans and counters inside the serving path, on one clock with the device.

A span is a named interval of the program: `with span("mems.k3", device=True):`.
Recording is off by default. `with recording(device) as rec:` switches it on
for a block; each span opened inside it is kept in `rec.spans` as a `Span`:
its name, the call id of the `serve.run` it belongs to, its parent, its host
interval (`time.perf_counter_ns`) and, for a span that enqueues device work
(`device=True`), its device interval: a pair of CUDA events recorded on the
current stream, drawn from a pool the recorder owns. `count(name, n)` adds
to `rec.counters[name]`; `count_later(name, tensor, how)` adds the tensor's
sum, or keeps its served call's maximum, reduced on its device when
`rec.counters` is read, so that a count the device makes costs a call no
synchronize.

One clock: when recording starts on a card, the recorder takes one
calibration pair (a synchronize, `perf_counter_ns`, then an event), and every
event's time is mapped onto the host clock through it, so a span's device
interval lies on the same axis as every host interval. The events are
resolved when `rec.spans` is read, never inside a call. On the CPU a span's
device interval is its host interval.

Whenever a torch.profiler session is active, each span also opens
`torch.profiler.record_function(name)`: the spans then appear in the
profiler's trace as user annotations, on the clock of its kernel and copy
records.

With recording off and no profiler running, a span costs the recording flag
and the profiler's flag: it allocates nothing, records no event, opens no
`record_function` and synchronizes nothing. A span given `into` always times
its host interval and writes it to `into[key]` in seconds, recording or not:
the `seconds` the serving functions return are those spans' intervals.

One recording at a time in a process; spans are not meant to be opened from
several threads at once.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
#: the recorder of the open `recording` block, or None
_active: Recorder | None = None


@dataclass
class Span:
    """One recorded span. Intervals are (start, end) in nanoseconds of the
    host's perf_counter; `device` is None for a span without device work."""

    name: str
    call: int | None          # the id of the serve.run call it belongs to
    parent: int | None        # index of the enclosing span in rec.spans
    host: tuple[int, int]
    device: tuple[float, float] | None = None


class Recorder:
    """The spans and counters of one `recording` block."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._counters: dict[str, int] = {}
        self._later: list[tuple[str, torch.Tensor, str, int | None]] = []
        self._peaks: dict[tuple[str, int | None], int] = {}  # (max counter, call) -> max
        self._spans: list[Span] = []
        self._open: list[int] = []       # indices of the spans open now
        self._pending: list[tuple[Span, object, object]] = []
        self._pool: list = []            # events free for reuse
        self._calls = 0
        self._origin = None
        if self.cuda:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter_ns()
            self._origin = (t0, self._event())

    def _event(self):
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _enter(self, name: str, new_call: bool) -> int:
        parent = self._open[-1] if self._open else None
        if new_call:
            call = self._calls
            self._calls += 1
        else:
            call = self._spans[parent].call if parent is not None else None
        self._spans.append(Span(name, call, parent, (0, 0)))
        self._open.append(len(self._spans) - 1)
        return self._open[-1]

    def _exit(self, i: int, t0: int, t1: int, device: bool, start) -> None:
        self._open.pop()
        s = self._spans[i]
        s.host = (t0, t1)
        if not device:
            return
        if self.cuda:
            self._pending.append((s, start, self._event()))
        else:
            s.device = (float(t0), float(t1))

    @property
    def spans(self) -> list[Span]:
        """The spans recorded so far, in the order they were opened, their
        device intervals resolved (this waits for the device)."""
        if self._pending:
            t_origin, origin = self._origin
            for s, e0, e1 in self._pending:
                e1.synchronize()
                s.device = (t_origin + 1e6 * origin.elapsed_time(e0),
                            t_origin + 1e6 * origin.elapsed_time(e1))
                self._pool += (e0, e1)
            self._pending.clear()
        return self._spans

    @property
    def counters(self) -> dict[str, int]:
        """The counters so far, those of count_later reduced on their device
        now (this waits for the device): a "sum" counter adds each tensor's
        sum, a "max" counter holds the sum over the served calls of each
        call's largest value."""
        for name, t, how, call in self._later:
            v = int(getattr(t, how)())
            if how == "sum":
                self._counters[name] = self._counters.get(name, 0) + v
                continue
            peak = self._peaks.get((name, call))
            if peak is None or v > peak:  # the call's maximum rose by v - peak
                self._counters[name] = self._counters.get(name, 0) + v - (peak or 0)
                self._peaks[name, call] = v
        self._later.clear()
        return self._counters


class _Span:
    __slots__ = ("name", "device", "new_call", "into", "key", "rec", "index",
                 "t0", "start", "annotation")

    def __init__(self, name, device, new_call, into, key, rec):
        self.name, self.device, self.new_call = name, device, new_call
        self.into, self.key, self.rec = into, key, rec
        self.index = self.start = self.annotation = None

    def __enter__(self):
        if _profiling():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        rec = self.rec
        if rec is not None:
            self.index = rec._enter(self.name, self.new_call)
            if self.device and rec.cuda:
                self.start = rec._event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            rec._exit(self.index, self.t0, t1, self.device, self.start)
        if self.into is not None:
            self.into[self.key] = (t1 - self.t0) * 1e-9
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, *, device: bool = False, call: bool = False, into: dict | None = None,
         key: str | None = None):
    """A context manager for the span `name`. device: the block enqueues
    device work (the span records a device interval); call: the span is the
    root of a served call and gets a new call id; into, key: write the
    block's host seconds to into[key] whether or not recording is on."""
    rec = _active
    if rec is None and into is None and not _profiling():
        return _NULL
    return _Span(name, device, call, into, key, rec)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the open recording, if any."""
    rec = _active
    if rec is not None:
        rec._counters[name] = rec._counters.get(name, 0) + n


def count_later(name: str, tensor: torch.Tensor, how: str) -> None:
    """Count `tensor`'s values in the counter `name` of the open recording,
    if any: how "sum" adds their sum; how "max" keeps the largest value that
    the served call open now (its call id; None outside a call) counts,
    however many tensors it counts, and the counter holds the sum of the
    calls' maxima, so that it changes over one call by that call's maximum.
    The recorder keeps the tensor and reduces it on its device when
    `rec.counters` is read, after the call, so the call neither waits for
    the tensor nor launches the reduction."""
    rec = _active
    if rec is not None:
        if how not in ("sum", "max"):
            raise ValueError(f"count_later: how is 'sum' or 'max', not {how!r}")
        call = rec._spans[rec._open[-1]].call if rec._open else None
        rec._later.append((name, tensor, how, call))


def recording_now() -> bool:
    """Whether a `recording` block is open: a counter that costs something
    to take is taken only then."""
    return _active is not None


@contextlib.contextmanager
def recording(device="cpu"):
    """Record every span and counter of the block on `device`'s clock (see
    the module's docstring); yields the Recorder."""
    global _active
    if _active is not None:
        raise RuntimeError("spans: a recording is already open")
    rec = Recorder(device)
    _active = rec
    try:
        yield rec
    finally:
        _active = None
