"""The decode's share of the ASR's device seconds, in percent: the device
seconds of the program's ``asr.decode`` spans (prefill, steps and the
ids' pull) over those of ``asr.mel``, ``asr.encode``, ``asr.cross_kv``
and ``asr.decode``. None where the program has no such span."""


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    totals = trace.totals()
    parts = {n: totals[n].device_s for n in ("asr.mel", "asr.encode", "asr.cross_kv",
                                             "asr.decode") if n in totals}
    whole = sum(parts.values())
    if "asr.decode" not in parts or whole <= 0:
        return None
    return 100.0 * parts["asr.decode"] / whole
