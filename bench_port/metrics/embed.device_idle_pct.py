"""The share of the traced window in which no operation ran on a card
(1 - union of its kernel, copy and set intervals / window), the mean
over the cell's cards, in percent."""


def read(record):
    trace = record.trace
    if trace is None:
        return None
    return 100.0 * sum(trace.idle_share(d) for d in range(record.chips)) / record.chips
