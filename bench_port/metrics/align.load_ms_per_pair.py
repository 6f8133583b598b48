"""Stage 5.4's load phase (segment and ``.embed`` reads, id maps), ms a
pair: the ``load`` seconds that the CLI's batched path returns from each
call, over the pairs the window aligned."""


def read(record):
    if not record.counters.get("pairs") or "load_s" not in record.counters:
        return None
    return 1e3 * record.counters["load_s"] / record.counters["pairs"]
