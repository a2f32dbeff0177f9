"""The benchmark's runner: one cell of BENCHMARK.json, run once.

Everything that belongs to one cell is found by name: the cell's entry in
BENCHMARK.json names its configuration (perfbench/configs/<file>) and its
traffic (perfbench/traffic/<traffic>.json, whose "generator" names the
code in perfbench/generators/), its limits are perfbench/limits/<cell>.json
and each metric it reports is read by perfbench/metrics/<metric>.py.

A run: set-up (the generator's inputs, weights and warm-up; setup_s is the
time from the process's start to the first request), then requests in a
closed loop until `seconds` have passed (the request in flight at the
deadline runs to its end and counts), then the program's state is freed and
the generator's check compares what the window produced with the plain
reference. The result is one JSON line on standard output.

A request's time is its wall less the benchmark's own work inside it
(`harness_s`: copying out what the check compares); what the benchmark
does between requests (reading a written file back, deleting it) is in no
request. The window's time is the sum of its requests' times.

A `--trace 1` run splits its window: the requests that start in its first
half run untraced, and the host-clock metrics (shares of the peak, the
parts of a request, the wall of a request) are read from them; the profiler
records the rest, from which the device-trace metrics are read. Tracing
costs the host about a microsecond a launch, which slows a step of
thousands of small launches, so a host-clock number read under it would
measure the profiler.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
import traceback
import types
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")

# Top-level module names a run must not have loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "dsen2_tpu")


def cache_env(root: str = ROOT) -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout (build/ is ignored by git), before torch is imported."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (dsen2_tpu_torch is not dsen2_tpu)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def request_s(rec: dict) -> float:
    """A request's time: its wall less the benchmark's own work inside it."""
    return rec["end"] - rec["start"] - rec.get("harness_s", 0.0)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: str = ROOT, manifest: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files resolved."""
    m = manifest or load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(root, "perfbench", "limits", name + ".json"))["limits"]
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    e2e_names = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if (name in x["workloads"] if "workloads" in x else x["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer)


def load_metric(name: str):
    """The reader read(ctx) -> float | None of perfbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, precision: Optional[str] = None) -> dict:
    """Run `cell` once and return its result object (not yet printed)."""
    import torch

    from perfbench import generators
    from perfbench.trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(trace)
    gen = generators.load(cell.traffic["generator"])(cell.config, cell.traffic, seed, device,
                                                     tracer, precision=precision)
    t_import = time.perf_counter() - t_start
    gen.setup()
    print(f"perfbench: set-up {time.perf_counter() - t_start:.2f} s: imports and card "
          f"{t_import:.2f} s, then {getattr(gen, 'setup_parts', {})}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_first = time.perf_counter()
    deadline = t_first + seconds
    split = t_first + seconds / 2 if trace else float("inf")
    records = []
    n_host = None  # requests before the profiler started
    failed = 0
    while time.perf_counter() < deadline:
        if n_host is None and time.perf_counter() >= split:
            n_host = len(records)
            t0 = time.perf_counter()
            tracer.start()
            # The profiler's start (seconds on the card) takes no request's time.
            deadline += time.perf_counter() - t0
            print(f"perfbench: profiler started in {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
        try:
            records.append(gen.request(len(records)))
        except Exception:  # noqa: BLE001 - counted, reported, and fails the run
            failed += 1
            print(f"perfbench: request {len(records)} failed:\n{traceback.format_exc()}",
                  file=sys.stderr)
            break
    # Every request returns with its work done (host arrays, a written
    # file, an epoch's losses read back), so the window ends with the last.
    t_end = records[-1]["end"] if records else time.perf_counter()
    t0 = time.perf_counter()
    tracer.stop()
    if trace:
        print(f"perfbench: profiler stopped in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if cuda:
        torch.cuda.synchronize()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    memory_peak = max(peak, window_peak)
    b1_s = tracer.b1_device_s() if cuda else None

    print(f"perfbench: {len(records)} requests in {t_end - t_first:.3f} s"
          + ("" if n_host is None else f" (the last {len(records) - n_host} traced)") + ", each "
          f"{[round(request_s(r), 3) for r in records]} s, the benchmark's work in them "
          f"{[round(r.get('harness_s', 0.0), 4) for r in records]} s and between them "
          f"{[round(b['start'] - a['end'], 4) for a, b in zip(records, records[1:])]} s",
          file=sys.stderr)
    t0 = time.perf_counter()
    data = tracer.data() if trace else None
    if data is not None:
        lo, hi = data.window
        first = data.device[0][0] if data.device else float("nan")
        last = max((b for _, b, _ in data.device), default=float("nan"))
        print(f"perfbench: trace reduced in {time.perf_counter() - t0:.1f} s; events by kind "
              f"{tracer.event_kinds}; window {lo:.3f}..{hi:.3f} s, device activity "
              f"{first:.3f}..{last:.3f} s; device s by kernel (top 30):", file=sys.stderr)
        for name, sec in data.device_ops(30):
            print(f"  {sec:.4f} {name[:160]}", file=sys.stderr)
    host = records if n_host is None else records[:n_host]
    traced = [] if n_host is None else records[n_host:]
    ctx = types.SimpleNamespace(
        records=records, setup_s=t_first - t_start, window_s=sum(map(request_s, records)),
        host_records=host, host_window_s=sum(map(request_s, host)),
        traced_records=traced if data is not None else [],
        window_peak_bytes=window_peak if cuda else None, host_counts=gen.counts(host),
        traced_counts=gen.counts(traced), trace=data, b1_device_s=b1_s,
        traffic=cell.traffic, config=cell.config)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for entry in wanted:
        value = load_metric(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    gen.free()
    readings = gen.check()
    checks = {}
    correct = failed == 0 and bool(records)
    for name, limit in cell.limits.items():
        value = readings.get(name, float("inf"))
        finite = value is not None and math.isfinite(value)
        correct = correct and finite and value <= limit
        # JSON has no infinity: a reading that could not be taken shows as 1e308.
        checks[name] = {"value": value if finite else 1e308, "limit": limit}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(records) + failed, "failed": failed,
              "metrics": metrics, "device": device_info}
    if data is not None:
        lo, hi = data.window
        device_info["busy_s"] = data.busy_s(lo, hi)
        device_info["window_s"] = hi - lo
        result["breakdown"] = {"device_ops": data.device_ops(), "idle_gaps": data.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell of dsen2_tpu_torch once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), have {have}; "
              "no result", file=sys.stderr)
        return 2
    from perfbench import frozen

    print(f"perfbench: {args.workload} seed {args.seed} on {frozen.smi()} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
