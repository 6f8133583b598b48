"""Row groups of SpeechLASER's conv extractor per replayed chunk (a
shard, on a mesh) in the traced window: the program tracer's counter
``embed.extractor_groups`` over its ``embed.replays``, both counted while
tracing is on (``svecalign_tpu_torch/utils/trace.py``). 1 where every
chunk runs its convs in one call; above 1 where the extractor splits a
chunk's rows into groups (``models/laser_encoder.py::extractor_groups``).
None where the program has no such counter or replayed no chunk."""


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.traced_counts()
    groups, replays = counts.get("embed.extractor_groups", 0), counts.get("embed.replays", 0)
    if not groups or not replays:
        return None
    return groups / replays
