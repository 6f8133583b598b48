"""The four DP and walk kernels' share of their roofline, in percent: the
sum over their launches of each launch's least time
(``counts/dp_bounds.py``, from the shapes that the harness records at
each wrapper call) over their device time by name in the trace."""

from bench_port.counts.dp_bounds import KERNEL_NAMES, launch_bound_s


def read(record):
    trace = record.trace
    if trace is None or not record.launches:
        return None
    names = tuple(KERNEL_NAMES.values())
    spent = sum(t for name, t in trace.device_time.items() if any(k in name for k in names))
    if spent <= 0:
        return None
    bound = sum(launch_bound_s(kind, shape) for kind, shape in record.launches)
    return 100.0 * bound / spent
