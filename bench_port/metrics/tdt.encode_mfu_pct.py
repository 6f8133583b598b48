"""Parakeet's encoder operations over its device seconds and the bf16
peak, in percent: every clip of every finished call counted at its valid
frames (``counts/parakeet_counts.py``; a batch's padding to its bucket is
counted as waste), over the device seconds of the program's
``asr.encode`` spans (one a batch; the program's tracer,
``SVECALIGN_ASR_PROFILE=1``). None where the program has no such span."""

from bench_port.counts.parakeet_counts import encoder_flops
from bench_port.counts.peaks import BF16_FLOPS


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    spent = sum(s.device_s for s in trace.spans("asr.encode") if s.device_s is not None)
    if spent <= 0 or not record.items:
        return None
    cfg = record.cell["config_data"]
    flops = sum(encoder_flops(cfg, n) for call in record.items for n in call["lens"])
    return 100.0 * flops / (spent * BF16_FLOPS)
