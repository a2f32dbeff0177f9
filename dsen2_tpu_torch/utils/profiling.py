"""Tracing and profiling: the program's spans and counters, and the hooks
around them.

The counterpart of dsen2_tpu/utils/profiling.py. The reference's only
observability is wall-clock prints (training/supres_train.py:165,177-178);
`Timer` keeps that habit and `block_and_time` times a call on the card
(torch.cuda.synchronize where jax waits with block_until_ready). Beyond it
the port names its own work, in one recorder:

- Spans. `with span("engine.band", k=3):` marks a stretch of the host's work
  at a layer boundary. Spans are off by default: `span()` then tests one
  flag and returns a shared null context. Inside `spans_on()` (or `trace()`)
  each span, as it closes, appends a `Span` record to an in-memory list,
  which `take_spans()` empties. Times are `time.time_ns()`, the clock of
  torch.profiler's events, so spans and the device trace line up. A span's
  parent is the span open in the current context (a contextvar); a span
  opened under none starts a request, whose id its descendants share. Work
  handed to another thread keeps its ids when it runs under
  `contextvars.copy_context().run` (the engine's stager and drain, fit's
  batch producer). `record(name, start_ns)` closes a span over a stretch
  that no single block holds, from a `now()` mark to here: it is a child of
  the current span and holds its siblings by time only; `traced(name)`
  makes each call of a function one span.
- Counters. `count(name, n)` adds to one process-wide registry, always on;
  `counters()` reads it. Readers take differences.
- `trace(log_dir)`, the operator's way in: spans on, torch.profiler
  recording the device's activity, and one Chrome trace holding both.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import functools
import itertools
import json
import os
import socket
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "Timer", "block_and_time", "span", "traced", "now", "record", "spans_on", "take_spans",
    "Span", "count", "counters", "trace", "device_s_by_span",
]


class Span(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    span_id: int
    parent_id: Optional[int]
    request_id: int
    native_thread_id: int  # the kernel's id of the thread (host ops' rows)
    thread_ident: int  # its pthread id (CUPTI's name for the thread)
    attrs: dict


class _Null:
    """A span's context while spans are off. Its __enter__ and __exit__ are
    one C function that returns "" (falsy, so exceptions pass): a with
    statement on it costs no Python call."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_on = False
# Spans as plain tuples (a Span is made only when taken, off the timed
# path); list.append is atomic, so threads append without a lock.
_spans: List[tuple] = []
_ids = itertools.count(1)
_local = threading.local()
# (span id, request id) of the span open in this context, or None.
_current: contextvars.ContextVar = contextvars.ContextVar("dsen2_span", default=None)
_NULL = _Null()


def _thread() -> Tuple[int, int]:
    """(native id, pthread id) of the calling thread, read once a thread:
    the native id is a system call, which is slow in some sandboxes."""
    try:
        return _local.ids
    except AttributeError:
        _local.ids = (threading.get_native_id(), threading.get_ident())
        return _local.ids


class _Open:
    """An open span: sets the current span on entry, records itself on exit."""

    __slots__ = ("name", "attrs", "ids", "token", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> None:
        sid = next(_ids)
        cur = _current.get()
        self.ids = (sid, None, sid) if cur is None else (sid, cur[0], cur[1])
        self.token = _current.set((sid, self.ids[2]))
        self.start = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _current.reset(self.token)
        sid, parent, request = self.ids
        _spans.append((self.start, end, self.name, sid, parent, request, *_thread(),
                       self.attrs))


def span(name: str, **attrs):
    """A context manager that records the enclosed stretch as a span named
    `name` with `attrs`, while spans are on; a shared null context while
    they are off."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


def traced(name: str):
    """A function decorator: each call is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def now() -> Optional[int]:
    """A mark for record(): the clock while spans are on, else None."""
    return time.time_ns() if _on else None


def record(name: str, start_ns: Optional[int], **attrs) -> None:
    """Record a span from the mark `start_ns` (now()) to here, as a child of
    the current span. Nothing while spans are off or without a mark."""
    if not _on or start_ns is None:
        return
    sid = next(_ids)
    cur = _current.get()
    parent, request = (None, sid) if cur is None else cur
    _spans.append((start_ns, time.time_ns(), name, sid, parent, request, *_thread(), attrs))


@contextlib.contextmanager
def spans_on() -> Iterator[None]:
    """Record spans inside the block; the state before it comes back after.
    The spans stay in memory until take_spans()."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def take_spans() -> List[Span]:
    """The spans recorded so far, in the order they closed; empties the list."""
    taken = _spans[:]
    del _spans[: len(taken)]
    return [Span._make(t) for t in taken]


_counts: Dict[str, float] = {}
_count_lock = threading.Lock()


def count(name: str, n: float = 1) -> None:
    """Add n to the counter `name` (always on; threads may count at once)."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, float]:
    """A copy of every counter's total since the process started."""
    with _count_lock:
        return dict(_counts)


class Timer:
    """Wall-clock timer matching the reference's 'Elapsed time: ...' habit."""

    def __init__(self, label: str = "", verbose: bool = True):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"Elapsed time: {self.elapsed}.")


def _cupti_thread(ident: int) -> int:
    """The id CUPTI gives the thread of pthread id `ident` (kineto's
    device_resource_id of a runtime call): its low 32 bits, signed."""
    return ((ident & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def device_s_by_span(events, spans) -> Dict[str, Dict[str, float]]:
    """Device seconds of the profiler's `events` (torch.profiler's kineto
    events), {span name: {device op name: seconds}}: each device op goes to
    the innermost of `spans` open on the thread whose runtime call launched
    it, at that call's start ("(no span)" outside every span). A device op
    finds its launch by CUPTI's correlation id."""
    launches = {}  # correlation id -> (thread, start ns) of the runtime call
    device = []
    for e in events:
        if e.device_type().name == "CUDA":
            device.append(e)
        elif e.name().startswith("cu"):  # a cuda*/cu* API call, not CUPTI's overhead
            launches[e.correlation_id()] = (e.device_resource_id(), e.start_ns())
    by_thread: Dict[int, List[Span]] = {}
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        by_thread.setdefault(_cupti_thread(s.thread_ident), []).append(s)
    starts = {t: [s.start_ns for s in ss] for t, ss in by_thread.items()}
    out: Dict[str, Dict[str, float]] = {}
    for e in device:
        launch = launches.get(e.linked_correlation_id() or e.correlation_id())
        name = "(no span)"
        if launch is not None:
            tid, t = launch
            ss = by_thread.get(tid, [])
            # The innermost span holding t starts last among those not ended.
            for k in range(bisect.bisect_right(starts.get(tid, []), t) - 1, -1, -1):
                if ss[k].end_ns >= t:
                    name = ss[k].name
                    break
        ops = out.setdefault(name, {})
        ops[e.name()] = ops.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) / 1e9
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[dict]:
    """Capture the enclosed region into `log_dir` as one Chrome trace
    (Perfetto, chrome://tracing or TensorBoard open it): where CUDA is
    present the device's activity and the runtime calls that launched it,
    else the host's ops, and the program's spans, all on one clock. Host ops
    are not recorded on the card: recording each aten op makes a step of
    many small launches wait for the profiler. Spans are on inside.

    Yields a dict that holds, after the block, "path" (the trace written),
    "spans" (the block's spans) and "device_s_by_span" (the device's
    seconds by the span that launched each op, and by op: device_s_by_span)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    result: dict = {}
    first = len(_spans)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with spans_on():
            yield result
        if cuda:
            torch.cuda.synchronize()
    mine = [Span._make(t) for t in _spans[first:]]
    if not _on:
        del _spans[first:]
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)
    for s in mine:
        # The row of the thread's own events: its runtime calls on the card
        # (CUPTI's thread id, unsigned), its host ops otherwise.
        row = abs(_cupti_thread(s.thread_ident)) if cuda else s.native_thread_id
        doc["traceEvents"].append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": os.getpid(),
            "tid": row, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                     "request_id": s.request_id, **s.attrs}})
    with open(path, "w") as fh:
        json.dump(doc, fh)
    result.update(path=path, spans=mine,
                  device_s_by_span=device_s_by_span(prof.profiler.kineto_results.events(), mine))


def _wait() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def block_and_time(fn, *args, repeats: int = 1, **kwargs):
    """Run fn, waiting for the card after each repeat; returns (result,
    best_seconds). Correct timing on an asynchronous device: the clock stops
    after torch.cuda.synchronize, not when the launches are queued."""
    result = fn(*args, **kwargs)
    _wait()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _wait()
        best = min(best, time.perf_counter() - t0)
    return result, best
