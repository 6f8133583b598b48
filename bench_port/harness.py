"""What every cell of the benchmark shares: finding cells, configurations,
traffic and metric readers by name, the device's description, spans, the
profiler window and its reduction, and the result line.

A cell is ``workloads/<cell>.json``: its configuration (``configs/``), its
traffic (``traffic/``), its chips, the driver module (``drivers/``) that
runs it, the stage's arguments and the size of its correctness sample. A
per-layer metric is ``metrics/<metric>.py``, a ``read(record)`` that
returns a number or None. ``BENCHMARK.json`` at the checkout's root says
which metrics each cell reports.
"""

import contextlib
import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that nothing of a run may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "svecalign_tpu")


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fp:
        return json.load(fp)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's file with its configuration and traffic loaded beside it."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell {name!r}: {path} does not exist")
    cell = load_json(path)
    cell["name"] = name
    cell["config_data"] = load_json(HERE / "configs" / f"{cell['config']}.json")
    cell["traffic_data"] = load_traffic(cell["traffic"])
    return cell


def load_traffic(name: str) -> dict:
    """``traffic/<name>.json``; a file that names a ``base`` mix takes every
    parameter of that mix and sets only the ones it holds itself."""
    data = load_json(HERE / "traffic" / f"{name}.json")
    base = data.pop("base", None)
    return {**load_traffic(base), **data} if base else data


def load_driver(name: str):
    return importlib.import_module(f"bench_port.drivers.{name}")


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read``; metric names hold dots, so the
    file is loaded by path."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) entries of ``bench`` that ``cell`` reports: an
    entry with ``workloads`` where it lists the cell, one without it where
    the cell reports the end-to-end metric it moves (per-layer) or always
    (end-to-end)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def forbidden_loaded() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def device_info(chips: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": memory_peak_bytes}


@dataclass
class Check:
    """One number compared, beside its limit: ``value <= limit`` passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Record:
    """What a run leaves for the metric readers."""
    cell: dict
    seed: int
    chips: int
    window_s: float = 0.0
    e2e: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    items: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    trace: Optional["TraceSummary"] = None
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = field(default_factory=list)


class Spans:
    """Harness spans around the calls into each layer: ``record_function``
    ranges while the profiler runs (they name the idle gaps of the trace),
    nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: List[float]  # per device used
    device_time: Dict[str, float]  # seconds by operation name, all devices
    idle_by_span: Dict[str, float]  # idle device seconds by the innermost harness span

    def idle_share(self, device: int) -> float:
        return 1.0 - self.busy_s[device] / self.window_s


def _union(intervals: List[Tuple[int, int]]):
    """Merged intervals of ``intervals`` (sorted in place)."""
    intervals.sort()
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class ProfiledWindow:
    """torch.profiler over a window (CPU and CUDA activity), reduced to the
    device's busy time per card, operation time by name and the idle
    gaps by harness span. The window's length is the host clock's from
    entry to exit."""

    def __init__(self, chips: int):
        self.chips = chips
        self.summary: Optional[TraceSummary] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function("bench.window")
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        for d in range(self.chips):
            torch.cuda.synchronize(d)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = self._reduce(self.prof.profiler.kineto_results.events())
        return False

    def _reduce(self, events) -> TraceSummary:
        from torch.autograd import DeviceType

        per_dev: Dict[int, List[Tuple[int, int]]] = {}
        by_name: Dict[str, float] = {}
        spans, window = [], None
        for ev in events:
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                # kernels, copies and sets; the device's copies of the
                # harness's spans are not work
                if name.startswith("bench."):
                    continue
                s = ev.start_ns()
                per_dev.setdefault(ev.device_index(), []).append((s, s + ev.duration_ns()))
                by_name[name] = by_name.get(name, 0.0) + ev.duration_ns() * 1e-9
            elif name == "bench.window":
                window = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
            elif name.startswith("bench."):
                spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name[6:]))
        t0, t1 = window
        busy, idle = [], {}
        for d in range(self.chips):
            merged = _union([(max(s, t0), min(e, t1)) for s, e in per_dev.get(d, [])
                             if min(e, t1) > max(s, t0)])
            busy.append(sum(e - s for s, e in merged) * 1e-9)
            if d == 0:
                edges = [t0] + [x for iv in merged for x in iv] + [t1]
                gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                        if edges[i + 1] > edges[i]]
                idle = _label_gaps(gaps, spans)
        return TraceSummary((t1 - t0) * 1e-9, busy, by_name, idle)


def _label_gaps(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost harness span around each gap's middle
    (the shortest span that covers it), "outside spans" where none does."""
    spans = sorted(spans)
    out: Dict[str, float] = {}
    j = 0
    active: List[Tuple[int, int, str]] = []
    for gs, ge in sorted(gaps):
        mid = (gs + ge) // 2
        while j < len(spans) and spans[j][0] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] >= mid]
        label = min(active, key=lambda s: s[1] - s[0])[2] if active else "outside spans"
        out[label] = out.get(label, 0.0) + (ge - gs) * 1e-9
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries, names cut to 160 characters (kernels'
    template arguments run to thousands)."""
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def result_line(correct: bool, record: Record, metrics: dict, device: dict,
                breakdown: Optional[dict]) -> str:
    line = {"correct": correct, "attempted": record.attempted, "failed": record.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked"] = {c.name: {"value": c.value, "limit": c.limit} for c in record.checks}
    return json.dumps(line)
