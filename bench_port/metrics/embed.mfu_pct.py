"""The encoder's model operations over the traced window's wall time and
the bf16 peak of the cell's cards, in percent. Every window of every
finished document is counted at its own length
(``counts/encoder_flops.py``)."""

from bench_port.counts.encoder_flops import WINDOW_FLOPS
from bench_port.counts.peaks import BF16_FLOPS


def read(record):
    if not record.items or not record.window_s:
        return None
    cfg = record.cell["config_data"]
    count = WINDOW_FLOPS[cfg["embed_model_type"]]
    flops = sum(count(cfg, e - s) for doc, _ in record.items for s, e in doc.windows)
    return 100.0 * flops / (record.window_s * BF16_FLOPS * record.chips)
