"""svecalign_tpu_torch: the PyTorch and CUDA port of svecalign_tpu.

The JAX package ``svecalign_tpu`` stays the reference; this package runs
the same stages with PyTorch on an NVIDIA H100, with every TPU kernel of a
ported stage replaced by a CUDA kernel written by hand (``csrc/``).

Ported so far:
- stage 5.4, the coarse-to-fine aligner, per document pair
  (``seg_align/align.py`` -> ``vecalign/vecalign.py`` ->
  ``vecalign/pyramid.py``);
- stage 5.3, the embed stage with the SONAR speech encoder
  (``seg_align/embed.py`` -> ``models/sonar_encoder.py`` ->
  ``models/w2v_bert.py``).
It imports neither ``jax`` nor ``svecalign_tpu``.

Subpackages
-----------
- ``ops``      : cost products (torch), the dense and banded DPs, fbank,
                 window assembly, rel-key attention, and the CUDA kernel
                 wrappers (banded DP, rel-key attention) with their build
- ``models``   : the SONAR encoder (w2v-BERT trunk, pooler), the span
                 encode loop and the JAX-parameter loader
- ``vecalign`` : coarse-to-fine driver, traceback, deletion knob, scorer
- ``seg_align``: the stage-5.4 and stage-5.3 CLIs
- ``utils``    : file/audio/embedding IO, sharding and the device/fp32 setup
"""

__version__ = "0.1.0"
