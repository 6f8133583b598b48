"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. The cell's driver (``drivers/``) makes the
inputs and weights from the seed, sets up and warms every shape the
cell uses, measures for ``--seconds`` (finishing the document or call in
flight), then checks what the timed path produced against the plain
reference (``reference/``). ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window. The
last line of standard output is one JSON object; the numbers compared
for ``correct`` are the last lines of standard error. Without a CUDA
device, or with fewer than the cell's chips, the run exits 2 and prints
no result.
"""

import time

T_START = time.perf_counter()  # set-up runs from here: the process's first statement

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent / ".cache"


def _fixed_caches() -> None:
    """Every compile cache of a run at a fixed path inside the checkout, so
    only a cell's first run there builds; no library loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             faults=(), require_card: bool = True):
    """One run of cell ``name`` (or of a cell given as a dict, as
    ``harness.load_cell`` returns it): returns (correct, record, metrics).
    ``faults`` break the timed path on purpose (the tests' negative checks);
    ``require_card`` False skips the look for a card (those tests only)."""
    from bench_port import harness

    cell = harness.load_cell(name) if isinstance(name, str) else name
    bench = harness.benchmark()
    e2e, per_layer = harness.cell_metrics(bench, cell["name"])
    chips = int(cell["chips"])
    if require_card:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoCard(f"cell {name} needs {chips} CUDA device(s); this machine has {have}")
    record = harness.Record(cell=cell, seed=int(seed) % (2**63), chips=chips)
    driver = harness.load_driver(cell["driver"])
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        driver.run(record, Path(tmp), seconds, bool(trace), t_start, faults)
    bad = harness.forbidden_loaded()
    if bad:
        raise ForbiddenModules("modules of JAX or the JAX package were loaded: " + ", ".join(bad))
    if trace:
        metrics = {}
        for m in per_layer:
            value = harness.load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": record.e2e[m["name"]], "unit": m["unit"]} for m in e2e}
    correct = (record.failed == 0 and bool(record.checks)
               and all(c.ok for c in record.checks))
    return correct, record, metrics


class NoCard(RuntimeError):
    pass


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    args = parse_args(argv)
    _fixed_caches()
    from bench_port import harness

    out = sys.stdout
    try:
        with contextlib.redirect_stdout(sys.stderr):
            correct, record, metrics = run_cell(args.workload, args.seed, args.seconds,
                                                bool(args.trace), T_START)
            device = harness.device_info(record.chips, record.counters["memory_peak_bytes"])
            breakdown = None
            if args.trace:
                tr = record.trace
                device["busy_s"] = sum(tr.busy_s) / len(tr.busy_s)
                device["window_s"] = tr.window_s
                breakdown = {"device_ops": harness.top(tr.device_time),
                             "idle_gaps": harness.top(tr.idle_by_span)}
    except (NoCard, ForbiddenModules, FileNotFoundError) as exc:
        print(f"bench_port: {exc}", file=sys.stderr)
        return 2
    for c in record.checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(harness.result_line(correct, record, metrics, device, breakdown), file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
