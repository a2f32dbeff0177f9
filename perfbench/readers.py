"""Helpers the metric readers in perfbench/metrics/ share. Each reader gets
the run's context: records (one dict per request), setup_s, window_s (the
sum of the requests' times, harness.request_s); host_records and
host_window_s (the untraced requests and the sum of their times: all of
them in a --trace 0 run); traced_records (the
requests the profiler recorded); host_counts and traced_counts (the
generator's counts from shapes for each); window_peak_bytes; trace (a
trace.TraceData of the traced stretch in a --trace 1 run, else None) and
b1_device_s (B1's calls in the traced stretch)."""

from __future__ import annotations

import re

from perfbench import counts

# The kernels cuDNN runs for a convolution, forward, data gradient and
# weight gradient (sm90_xmma_{fprop,dgrad,wgrad}_..._cudnn and its helpers),
# by name: the trace holds device activity alone.
CONV_KERNEL = re.compile(r"cudnn|xmma|implicit_gemm", re.IGNORECASE)


def of_kind(records, kind: str):
    return [r for r in records if r.get("kind") == kind]


def rate(ctx, kind: str, key: str):
    """All the work of the window's requests of `kind` over all their time."""
    recs = [r for r in of_kind(ctx.records, kind) if key in r]
    if not recs or ctx.window_s <= 0:
        return None
    return sum(r[key] for r in recs) / ctx.window_s


def mean_part(ctx, kind: str, part: str):
    """Mean seconds of one part of the untraced requests of `kind`."""
    vals = [r["parts"][part] for r in of_kind(ctx.host_records, kind)
            if part in r.get("parts", {})]
    return sum(vals) / len(vals) if vals else None


def host_wall_per_request(ctx, kind: str):
    """Seconds per request of the untraced stretch of the window."""
    n = len(of_kind(ctx.host_records, kind))
    return ctx.host_window_s / n if n and ctx.host_window_s > 0 else None


def traced_share(ctx, kind: str, device_s: float):
    """`device_s` seconds of the traced stretch, per traced request, as a
    share of an untraced request's time, in %."""
    n, wall = len(of_kind(ctx.traced_records, kind)), host_wall_per_request(ctx, kind)
    if not n or wall is None:
        return None
    return 100.0 * device_s / n / wall


def idle_share(ctx, kind: str):
    """1 - the device's busy seconds per traced request (the union of its
    activity intervals, from the trace) / the seconds of an untraced
    request, in %."""
    t = ctx.trace
    if t is None or not t.device:
        return None
    lo, hi = t.window
    busy = traced_share(ctx, kind, t.busy_s(lo, hi))
    return None if busy is None else 100.0 - busy


def mfu(ctx, kind: str):
    """Model FLOPs of the untraced requests over their time, as a share of
    the bf16 dense peak, in %."""
    flops = ctx.host_counts.get("model_flops")
    wall = host_wall_per_request(ctx, kind)
    if not flops or wall is None or ctx.trace is None or not ctx.trace.device:
        return None  # no card, no share of its peak
    return 100.0 * flops / ctx.host_window_s / counts.PEAK_BF16_FLOPS


def train_steps(ctx):
    """Training steps of the traced requests."""
    return ctx.traced_counts.get("train_steps") or None


def conv_device_s(ctx):
    """Device seconds of cuDNN's convolution kernels in the traced stretch."""
    t = ctx.trace
    if t is None or not t.device:
        return None
    conv = sum(v for k, v in t.kernel_s.items() if CONV_KERNEL.search(k))
    return conv or None
