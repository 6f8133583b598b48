"""LayerNorm kernel launches per replayed chunk (a shard, on a mesh) in
the traced window: the program tracer's counter ``norm.launches`` over
its ``embed.replays``, both counted while tracing is on
(``svecalign_tpu_torch/utils/trace.py``; a launch captured into a chunk's
CUDA graph counts at each replay). Every LayerNorm of the speech
encoders' forward on a card is one launch
(``models/w2v_bert.py::FlaxLayerNorm``): 64 on a 600 s SpeechLASER chunk
(7 extractor norms in each of two row groups, ``post_extract_norm``, 48
layer norms, ``encoder_norm``), 57 on a shard of one group, 145 on a
SONAR chunk (``fp_layer_norm`` and six a conformer layer); fewer means a
norm ran the plain arithmetic. None where the program has no such
counter or replayed no chunk."""


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.traced_counts()
    launches, replays = counts.get("norm.launches", 0), counts.get("embed.replays", 0)
    if not launches or not replays:
        return None
    return launches / replays
