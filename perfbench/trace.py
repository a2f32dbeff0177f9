"""The traced run's instruments: named host spans, the profiler's device
trace, CUDA-event timing of kernel B1's calls, and their reduction.

A `--trace 0` run gets a Tracer that does nothing. A `--trace 1` run wraps
the measured window in torch.profiler recording device activity alone
(kernels, copies, sets, and the CUDA runtime calls that launch them): host
ops are not recorded, because recording every aten op makes a step of many
small ops wait for the host, and the window would then measure the
profiler. Each request and each entry-point call is a span named
"perfbench.<what>", taken on the host clock in the profiler's own time base
(nanoseconds of the real-time clock). Every call of kernel B1 (the residual
blocks, s2net.fused_resblock_chain) lies between two CUDA events on the
stream it runs on. The idle share follows chip_smoke.device_profile: 1 -
the union of the device's activity intervals / the window's wall.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "perfbench."
# Host events of the CUDA runtime and driver APIs (cudaLaunchKernel,
# cuLaunchKernelEx, cudaMemcpyAsync, ...).
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass
class TraceData:
    """What the profiler saw in the window, in seconds from its start."""

    device: List[Tuple[float, float, str]]  # device activity, sorted by start
    spans: List[Tuple[float, float, str]]  # our record_function spans
    host_ops: List[Tuple[float, float, str]]  # runtime calls (host ops on the CPU)
    kernel_s: Dict[str, float]  # device seconds of each device op, by name
    window: Tuple[float, float]  # the window span

    def busy_s(self, lo: float, hi: float) -> float:
        """Union of device activity inside [lo, hi]."""
        busy, end = 0.0, lo
        for a, b, _ in self.device:
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        return busy

    def spans_named(self, prefix: str) -> List[Tuple[float, float, str]]:
        return [s for s in self.spans if s[2].startswith(prefix)]

    def edge_idle_s(self, lo: float, hi: float) -> Optional[float]:
        """Idle time of [lo, hi] before its first and after its last device
        activity; None if the device did nothing in it."""
        inside = [(a, b) for a, b, _ in self.device if b > lo and a < hi]
        if not inside:
            return None
        first = max(lo, min(a for a, _ in inside))
        last = min(hi, max(b for _, b in inside))
        return (first - lo) + (hi - last)

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Device idle time inside the window, summed by what the host was
        doing at each gap's middle: the innermost runtime call (or host op)
        in progress, else the innermost span; the `top` largest."""
        lo, hi = self.window
        marks = sorted(self.host_ops, key=lambda s: (s[0], -s[1]))
        starts = [m[0] for m in marks]
        by: Dict[str, float] = {}
        end = lo
        for a, b, _ in self.device + [(hi, hi, "")]:
            g0, g1 = max(end, lo), min(a, hi)
            if g1 > g0:
                mid = (g0 + g1) / 2
                name = None
                # The innermost call holding mid is the latest-starting one
                # not yet ended; calls are short, so look back a bounded
                # way, then fall back to the (few, long) spans.
                k = bisect.bisect_right(starts, mid) - 1
                for j in range(k, max(-1, k - 256), -1):
                    if marks[j][1] >= mid:
                        name = marks[j][2]
                        break
                if name is None:
                    inside = [sp for sp in self.spans if sp[0] <= mid <= sp[1]]
                    name = max(inside)[2] if inside else "host: outside any op or span"
                by[name] = by.get(name, 0.0) + (g1 - g0)
            end = max(end, b)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """Spans, the profiler and B1's CUDA events; inert when not enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.cuda = enabled and torch.cuda.is_available()
        self._prof = None
        self._window: List[int] = []
        self._spans: List[Tuple[int, int, str]] = []
        self._b1: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._restore = []
        self.event_kinds: Dict[str, int] = {}

    @contextlib.contextmanager
    def _span(self, name: str):
        a = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((a, time.time_ns(), SPAN + name))

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def spans_around(self, *targets):
        """Inside the block, every call of each (module, name) function is
        a span of that name."""
        saved = []
        if self.enabled:
            for mod, name in targets:
                fn = getattr(mod, name)

                def wrapped(*a, _fn=fn, _name=name, **kw):
                    with self.span(_name):
                        return _fn(*a, **kw)

                saved.append((mod, name, fn))
                setattr(mod, name, wrapped)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def time_b1(self) -> None:
        """Wrap s2net's reference to kernel B1 so that each call is a span
        and, on the card, lies between two CUDA events."""
        if not self.enabled:
            return
        from dsen2_tpu_torch.models import s2net

        fn = s2net.fused_resblock_chain

        def timed(x, *a, **kw):
            with self.span("B1"):
                if not (self.cuda and x.is_cuda):
                    return fn(x, *a, **kw)
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(x, *a, **kw)
                e.record()
                self._b1.append((s, e))
                return out

        s2net.fused_resblock_chain = timed
        self._restore.append((s2net, "fused_resblock_chain", fn))

    def b1_device_s(self) -> Optional[float]:
        """Seconds between the events around B1's calls, summed; None if
        none was timed."""
        if not self._b1:
            return None
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self._b1) / 1e3

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self._b1.clear()  # calls and spans of set-up are not the window's
        self._spans.clear()
        # On a machine without a card (the tests) the host ops stand in.
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = [time.time_ns()]

    def stop(self) -> None:
        if self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._window.append(time.time_ns())
        self._prof.__exit__(None, None, None)

    def close(self) -> None:
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore.clear()

    def data(self) -> Optional[TraceData]:
        """The window's trace, reduced from the profiler's raw events (the
        profiler's own event tree takes minutes on a window of a million
        events); None without a profile. Device activity is every device
        event but annotations projected onto the device's timeline."""
        if self._prof is None:
            return None
        raw = self._prof.profiler.kineto_results.events()
        dev, host = [], []
        kinds: Dict[str, int] = {}
        for e in raw:
            name = e.name()
            a, b = e.start_ns(), e.end_ns()
            if e.device_type().name == "CUDA":
                annotation = getattr(e, "is_user_annotation", lambda: False)()
                kind = "annotation on device" if annotation or name.startswith(SPAN) else "device"
                if kind == "device":
                    dev.append((a, b, name))
            else:
                kind = "runtime" if RUNTIME.match(name) else "host"
                host.append((a, b, name))
            kinds[kind] = kinds.get(kind, 0) + 1
        self.event_kinds = kinds
        base = self._window[0]
        sec = lambda ns: (ns - base) / 1e9  # noqa: E731
        kern: Dict[str, float] = {}
        out_dev = []
        for a, b, name in dev:
            kern[name] = kern.get(name, 0.0) + (b - a) / 1e9
            out_dev.append((sec(a), sec(b), name))
        out_dev.sort()
        return TraceData(device=out_dev,
                         spans=[(sec(a), sec(b), n) for a, b, n in self._spans],
                         host_ops=[(sec(a), sec(b), n) for a, b, n in host],
                         kernel_s=kern, window=(0.0, sec(self._window[1])))
