"""The TDT loop's share of its roofline, in percent: the least time of
the iterations each batch needs (its longest row's points: a batch runs
until its last row is done) over the rows' points, each iteration reading
the prediction network's and the joint's weights once and each live row's
projected frame (``counts/parakeet_counts.py``), over the device seconds
of the program's ``asr.tdt_loop`` spans (one a program launch). The
iterations a program runs after every row of its batch is done count as
waste. It is also the roofline share of any kernel written for the loop.
None where the program has no such span."""

from bench_port.counts.parakeet_counts import loop_bound_s


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    spent = sum(s.device_s for s in trace.spans("asr.tdt_loop") if s.device_s is not None)
    if spent <= 0 or not record.items:
        return None
    cfg = record.cell["config_data"]
    batch = int(record.cell["asr_options"]["batch"])
    iterations = rows = 0
    for call in record.items:
        points = [t.points for t in call["transcripts"]]
        for lo in range(0, len(points), batch):
            iterations += max(points[lo:lo + batch])
            rows += sum(points[lo:lo + batch])
    return 100.0 * loop_bound_s(cfg, iterations, rows) / spent
