"""The rel-key attention kernel's share of its roofline, in percent: the
sum over its launches of each launch's least time
(``counts/attention_bound.py``, from the launch's rows, bucket and valid
lengths) over the kernel's device time by name in the trace."""

from bench_port.counts.attention_bound import attention_bound_s, sonar_launches


def read(record):
    trace = record.trace
    if trace is None or record.cell["config_data"]["embed_model_type"] != "sonar":
        return None
    spent = sum(t for name, t in trace.device_time.items() if "relkey_attention" in name)
    if spent <= 0:
        return None
    cfg = record.cell["config_data"]
    rows = int(record.cell["stage_args"][record.cell["stage_args"].index("--batch_size") + 1])
    rows = -(-rows // record.chips) * record.chips
    bound = 0.0
    for doc, _ in record.items:
        lengths = [e - s for s, e in doc.windows]
        for B, T, lens in sonar_launches(cfg, rows, lengths):
            bound += attention_bound_s(B, T, cfg["n_heads"], lens)[0]
    return 100.0 * bound / spent
