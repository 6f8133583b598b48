"""The batched pyramid's phases, ms a pair: the sum of
``vecalign.batch.phase_seconds`` (``SVECALIGN_ALIGN_PROFILE=1``, traced
run; the device synchronised at each phase's end) over the pairs the
window aligned."""


def read(record):
    if not record.counters.get("pairs") or "pyramid_s" not in record.counters:
        return None
    return 1e3 * record.counters["pyramid_s"] / record.counters["pairs"]
