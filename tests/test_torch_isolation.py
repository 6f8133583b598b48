"""The port imports neither JAX nor the JAX package: in a fresh
interpreter, import every module of svecalign_tpu_torch and chip_smoke,
then look at sys.modules."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, sys
import svecalign_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    svecalign_tpu_torch.__path__, "svecalign_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
        check=True, timeout=120,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "svecalign_tpu_torch.ops.dp_cuda" in res["imported"]
    assert "svecalign_tpu_torch.seg_align.align" in res["imported"]
    for name in ("ops.attention_cuda", "models.sonar_encoder", "seg_align.embed",
                 "ops.dense_dp_cuda", "ops.traceback_cuda", "vecalign.batch",
                 "models.laser_encoder", "postprocess.filter_by_cost",
                 "postprocess.concat_aligns", "postprocess.filter_by_dur",
                 "postprocess.embed_align", "ops.topk", "utils.index_utils",
                 "postprocess.prep_index", "postprocess.score_align", "postprocess.prep_tsv",
                 "postprocess.remove_overlaps", "postprocess.sort_tsv",
                 "seg_align.concat_segs", "seg_align.detect_untranslate_concats",
                 "preprocess.segment", "preprocess.detect_untranslate_segs",
                 "postprocess.filter_untrans_align", "models.vad", "analysis.dump_alignments",
                 "utils.audio_utils", "utils.mp_utils", "ops.fbank", "utils.audio_io",
                 "utils.embed_cache", "pipeline", "parallel.mesh"):
        assert f"svecalign_tpu_torch.{name}" in res["imported"]
    mods = res["modules"]
    assert not [m for m in mods if m == "jax" or m.startswith("jax.") or m == "jaxlib"]
    # mind the prefix: svecalign_tpu_torch starts with "svecalign_tpu"
    assert not [m for m in mods if m == "svecalign_tpu" or m.startswith("svecalign_tpu.")]
    # and nothing of the JAX package's C++ backend (native/)
    assert not [m for m in mods if m == "native" or m.startswith("native.")]
