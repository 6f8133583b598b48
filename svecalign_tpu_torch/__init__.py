"""svecalign_tpu_torch: the PyTorch and CUDA port of svecalign_tpu.

The JAX package ``svecalign_tpu`` stays the reference; this package runs
the same stages with PyTorch on an NVIDIA H100, with every TPU kernel of a
ported stage replaced by a CUDA kernel written by hand (``csrc/``).

Ported so far:
- stage 5.4, the coarse-to-fine aligner, per document pair and in
  buckets (``seg_align/align.py`` -> ``vecalign/vecalign.py`` /
  ``vecalign/batch.py`` -> ``vecalign/pyramid.py``);
- stage 5.3, the embed stage with the SpeechLASER and SONAR encoders
  (``seg_align/embed.py`` -> ``models/``);
- stages 6.5 (``postprocess/embed_align.py``), 6.6 and 6.7, mining
  (``postprocess/prep_index.py``, ``score_align.py`` -> ``ops/topk.py``);
- stage 4.1, VAD segmentation (``preprocess/segment.py`` ->
  ``models/vad.py``: the energy VAD, and the Silero v4 graph with one
  ``nn.LSTM`` over the file), stage 4.2, untranslated-segment detection
  (``preprocess/detect_untranslate_segs.py``), and its alignment filter,
  stage 6.2 (``postprocess/filter_untrans_align.py``), both on a batched
  fbank (``utils/audio_utils.py`` -> ``ops/fbank.py``);
- the host stages 5.1, 5.2, 6.1, 6.3, 6.4 and 6.8-6.10, and the audit
  tool ``analysis/dump_alignments.py``;
- WAV and Ogg/Vorbis audio (``utils/audio_io.py``; Vorbis through the
  port's own libvorbis binding, ``csrc/ogg_io.cpp``).
- the one-command pipeline over all 16 stages (``pipeline.py``) with its
  fused handoff: ``--fused`` keeps each document's rows on the card from
  stage 5.3 to stages 5.4, 6.6 and 6.7 (``utils/embed_cache.py``);
- several cards in one process (``parallel/mesh.py``): data-parallel
  encoding in stages 5.3 and 6.5, the data-parallel aligner
  (``--data_parallel``) and the sharded kNN index (``--sharded_index``);
- the encoder trainer (``train.py`` -> ``models/training.py``), data- and
  tensor-parallel over the mesh;
- the audit stage's ASR, which the JAX package only tried to import:
  Whisper's batched greedy decoding (``analysis/dump_alignments.py --asr``
  -> ``analysis/asr.py`` -> ``models/whisper.py``).
On a card the encoders' chunk forwards and Whisper's encoder and decode
steps are CUDA graphs, captured once per shape and replayed, through one
program cache (``utils/programs.py``), which on the CPU runs them eagerly.
Every stage CLI of the JAX package has its counterpart here. It imports
neither ``jax`` nor ``svecalign_tpu``.

Subpackages
-----------
- ``ops``      : cost products (torch), the dense and banded DPs, fbank,
                 window assembly, rel-key attention, the kNN search, and
                 the CUDA kernel wrappers with their build
- ``models``   : the SONAR and SpeechLASER encoders and their shared
                 host wrapper (``encode_common.py``), Whisper, the
                 trainer's model and steps, the JAX-parameter loader,
                 and the VADs
- ``vecalign`` : coarse-to-fine driver, traceback, deletion knob, scorer
- ``preprocess``: the stage-4.1 and 4.2 CLIs
- ``seg_align``: the stage-5.1 to 5.4 CLIs
- ``postprocess``: the stage-6 CLIs
- ``analysis`` : the alignment audit dump (clips and HTML pages) and
                 its ASR (``asr.py``)
- ``parallel`` : the device mesh, placement and per-shard runs
- ``utils``    : file/audio/embedding/index IO, sharding and worker
                 processes, the tracer, the program cache, the
                 device/fp32 setup and the fused pipeline's row cache
"""

__version__ = "0.1.0"
