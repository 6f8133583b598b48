"""The share of the traced window in which no operation ran on the card,
in percent (as ``embed.device_idle_pct``, for the aligner's cell)."""


def read(record):
    trace = record.trace
    if trace is None:
        return None
    return 100.0 * sum(trace.idle_share(d) for d in range(record.chips)) / record.chips
