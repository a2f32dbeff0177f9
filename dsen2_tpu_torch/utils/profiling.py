"""Tracing / profiling hooks.

The counterpart of dsen2_tpu/utils/profiling.py. The reference's only
observability is wall-clock prints (training/supres_train.py:165,177-178);
this module keeps that capability (Timer) and adds profiler integration:
`trace()` wraps torch.profiler so any region can be captured as a Chrome /
Perfetto trace directory, and `annotate()` names regions inside a trace (and
in NVTX, where CUDA is present). `block_and_time` waits for the card with
torch.cuda.synchronize where jax waits with block_until_ready.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch

__all__ = ["Timer", "trace", "annotate", "block_and_time"]


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


@contextlib.contextmanager
def trace(log_dir: str, host_only: bool = False) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into log_dir
    (a Chrome trace JSON, viewable in Perfetto or TensorBoard). The device
    is traced too where CUDA is present, unless host_only."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and not host_only:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region for traces: with annotate('recompose'): ..."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


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
