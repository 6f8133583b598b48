"""The TDT loop's share of the ASR's device seconds, in percent: the
device seconds of the program's ``asr.decode`` spans (the loop's programs,
the state's set-up and the ids' pull) over those of ``asr.mel``,
``asr.encode`` and ``asr.decode``. None where the program has no
``asr.tdt_loop`` span (a transcriber without the loop)."""


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    totals = trace.totals()
    if "asr.tdt_loop" not in totals:
        return None
    parts = {n: totals[n].device_s for n in ("asr.mel", "asr.encode", "asr.decode")
             if n in totals}
    whole = sum(parts.values())
    if "asr.decode" not in parts or whole <= 0:
        return None
    return 100.0 * parts["asr.decode"] / whole
