"""Whisper's encoder operations over its device seconds and the bf16 peak,
in percent: every clip of every finished call counted at 1500 positions
(``counts/whisper_counts.py``; clips are padded to 30 s), over the device
seconds of the program's ``asr.encode`` spans (one a batch; the
program's tracer, ``SVECALIGN_ASR_PROFILE=1``). None where the program
has no such span."""

from bench_port.counts.peaks import BF16_FLOPS
from bench_port.counts.whisper_counts import encoder_flops


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    spent = sum(s.device_s for s in trace.spans("asr.encode") if s.device_s is not None)
    if spent <= 0 or not record.items:
        return None
    clips = sum(len(call["clips"]) for call in record.items)
    return 100.0 * clips * encoder_flops(record.cell["config_data"]) / (spent * BF16_FLOPS)
