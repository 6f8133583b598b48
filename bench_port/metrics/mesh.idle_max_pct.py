"""The idle share of the idlest card of the traced window, in percent:
where the mesh's split, peer copies and merge leave a card waiting."""


def read(record):
    trace = record.trace
    if trace is None or record.chips < 2:
        return None
    return 100.0 * max(trace.idle_share(d) for d in range(record.chips))
