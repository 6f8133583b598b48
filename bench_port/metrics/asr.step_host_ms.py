"""The mean host milliseconds of one decode step: the host seconds of the
program's ``asr.step`` spans (the step's launches: every layer's, the
filters and the argmax) over their count. Against a step's device time it
says whether the decode is bound by launches. None where the program has
no such span."""


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    total = trace.totals().get("asr.step")
    if total is None or not total.count:
        return None
    return 1e3 * total.host_s / total.count
