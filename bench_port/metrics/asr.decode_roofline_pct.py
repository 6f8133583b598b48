"""The decode steps' share of their roofline, in percent: the sum over
every step after the prefill of each step's least time (its least bytes
at HBM bandwidth or its operations at the bf16 peak, counting only the
rows still decoding: ``counts/whisper_counts.py``) over the device
seconds of the program's ``asr.step`` spans. Every clip of the cell
decodes exactly its budget, so a batch of rows with budgets b runs
max(b) - 1 steps. None where the program has no such span."""

from bench_port.counts.whisper_counts import batch_steps, decode_step_bound_s


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    spent = sum(s.device_s for s in trace.spans("asr.step") if s.device_s is not None)
    if spent <= 0 or not record.items:
        return None
    cfg = record.cell["config_data"]
    batch = int(record.cell["asr_options"]["batch"])
    bound = 0.0
    for call in record.items:
        budgets = call["budgets"]
        for lo in range(0, len(budgets), batch):
            for live, length in batch_steps(budgets[lo:lo + batch]):
                bound += decode_step_bound_s(cfg, live, length)
    return 100.0 * bound / spent
