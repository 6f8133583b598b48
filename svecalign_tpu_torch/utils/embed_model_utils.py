"""Embedding-model plumbing of the embed stage.

Port of the JAX package's ``utils/embed_model_utils.py``: the same CLI
flags (``add_embed_args``), the memoised model loader and the per-file
embed-and-write. Segments are sliced in memory, or gathered on the device
from one upload of the waveform (``--window_assembly device``).

Both models are ported. SpeechLASER (``--embed_model_type speech_laser``,
the default) writes stopes ``.embed`` files: a standard ``.npy`` of fp16
(default) or fp32 rows. SONAR (``--embed_model_type sonar``) writes
headerless raw fp16 or fp32 rows of ``pool_dim`` values. One row per
segment line either way.
"""

import argparse
import os
from pathlib import Path
from typing import List, Tuple

import numpy as np

from svecalign_tpu_torch.utils import embed_cache, trace
from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE, load_waveform
from svecalign_tpu_torch.utils.embedding_utils import write_np_embeddings, write_stopes_embedding
from svecalign_tpu_torch.utils.log_utils import logging

EMBED_MODEL_TYPES = ["speech_laser", "sonar"]

logger = logging.getLogger(__name__)


def add_embed_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--embed_model_type", choices=EMBED_MODEL_TYPES,
                        default="speech_laser")
    parser.add_argument("--embed_fp32", action="store_true", default=False,
                        help="whether to save the embeddings in fp32. default is fp16.")
    # SpeechLASER setups
    parser.add_argument("--sl_ckpt_dir", type=str, default=None,
                        help="the dir to all speech laser models (.npz converted weights).")
    parser.add_argument("--sl_ckpt_name", type=str, default=None,
                        help="which SpeechLASER weights to use, e.g. `english.npz`.")
    parser.add_argument("--max_tokens", type=int, default=150 * SAMPLE_RATE,
                        help="in number of SAMPLES")
    # SONAR setups
    parser.add_argument("--sonar_name", type=str, default=None,
                        help="path to SONAR-style .npz weights (or a name tag).")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="number of audios per batch.")
    parser.add_argument("--n_proc", type=int, default=1)
    parser.add_argument("--compile_sonar", action="store_true", default=False,
                        help="accepted for CLI parity; on a card the port replays one "
                             "CUDA graph per chunk shape either way.")
    parser.add_argument("--upload_precision", type=str, default="int16",
                        choices=["int16", "fp32"],
                        help="waveform host->device upload precision: int16 "
                             "halves the bytes (~3e-5 input noise); fp32 is "
                             "the exact path for parity runs.")
    parser.add_argument("--window_assembly", type=str, default="device",
                        choices=["device", "host"],
                        help="how overlap-window batches are built: 'device' "
                             "uploads each waveform once and gathers the "
                             "(heavily overlapping) windows on the device; "
                             "'host' slices and stages every padded window "
                             "batch on the host. With --upload_precision fp32 "
                             "both modes are bit-identical; with int16 they "
                             "differ by ~one quantization step.")
    return parser


# one model per argument tuple: in-process runs of the stage reuse it, so
# that stages 5.3 and 6.5 of one pipeline share one model (and its replicas)
_model_memo = {}


def _mesh_key(mesh):
    return None if mesh is None else (tuple(map(str, mesh.devices.flat)), mesh.devices.shape)


def load_embed_model(
    embed_model_type: str,
    sl_ckpt_dir=None,
    sl_ckpt_name=None,
    max_tokens=None,
    sonar_name=None,
    sonar_fp16: bool = False,
    compile_sonar: bool = False,
    batch_size: int = 16,
    upload_precision: str = "int16",
    device="cuda",
    mesh=None,
):
    """The stage's model, built once per argument tuple. ``mesh``: the
    devices of data-parallel encoding (``parallel/mesh.py``); None takes
    the encoders' default, every local card when there is more than one."""
    key = (embed_model_type, sl_ckpt_dir, sl_ckpt_name, max_tokens,
           sonar_name, sonar_fp16, compile_sonar, batch_size,
           upload_precision, str(device), _mesh_key(mesh))
    if key in _model_memo:
        logger.info(f"Reusing the loaded {embed_model_type} model")
        return _model_memo[key]
    same_weights = next((m for k, m in _model_memo.items() if k[:-1] == key[:-1]), None)
    if same_weights is not None:
        # the same arguments on other devices: replicate the loaded weights
        logger.info(f"Placing the loaded {embed_model_type} model over {mesh}")
        _model_memo[key] = same_weights.with_mesh(mesh)
        return _model_memo[key]
    model = _build_embed_model(
        embed_model_type, sl_ckpt_dir, sl_ckpt_name, max_tokens, sonar_name,
        sonar_fp16, compile_sonar, batch_size, upload_precision, device, mesh,
    )
    _model_memo[key] = model
    return model


def _build_embed_model(
    embed_model_type: str,
    sl_ckpt_dir=None,
    sl_ckpt_name=None,
    max_tokens=None,
    sonar_name=None,
    sonar_fp16: bool = False,
    compile_sonar: bool = False,
    batch_size: int = 16,
    upload_precision: str = "int16",
    device="cuda",
    mesh=None,
):
    if embed_model_type == "speech_laser":
        from svecalign_tpu_torch.models.laser_encoder import SpeechLaserModel

        ckpt = None
        if sl_ckpt_dir and sl_ckpt_name:
            candidate = Path(sl_ckpt_dir) / sl_ckpt_name
            if candidate.exists():
                ckpt = str(candidate)
            else:
                logger.warning(f"{candidate} not found; using random weights.")
        return SpeechLaserModel(
            ckpt_path=ckpt, max_tokens=max_tokens or 150 * SAMPLE_RATE,
            upload_dtype=upload_precision, device=device, mesh=mesh,
        )
    if embed_model_type == "sonar":
        from svecalign_tpu_torch.models.sonar_encoder import SonarSpeechModel

        ckpt = sonar_name if sonar_name and Path(sonar_name).exists() else None
        return SonarSpeechModel(
            ckpt_path=ckpt, batch_size=batch_size,
            upload_dtype=upload_precision, device=device, mesh=mesh,
        )
    raise NotImplementedError(f"Unsupported model {embed_model_type}")


def slice_segments(wave_path: str, segments: List[Tuple[int, int]]) -> List[np.ndarray]:
    """Read the audio once and slice each (start, end) frame span."""
    waveform = load_waveform(wave_path, sr=SAMPLE_RATE)
    if waveform.ndim == 2:
        waveform = waveform[:, 0]
    return [waveform[s:e] for s, e in segments]


def embed_segments_to_file(
    embed_model,
    embed_model_type: str,
    wave_path: str,
    segments: List[Tuple[int, int]],
    out_path: str,
    fp16: bool = True,
    cache_key: str = None,
    window_assembly: str = "device",
    waveform: np.ndarray = None,
    final_path: str = None,
) -> np.ndarray:
    """Embed all segments of one audio and write the .embed file, one row
    per segment, fp16 (``fp16``) or fp32: a stopes ``.npy`` for
    SpeechLASER, headerless raw rows for SONAR.

    ``cache_key``: while the fused handoff is on (``utils/embed_cache.py``),
    also keep the fp16 rows on the device under this key, normally the
    FINAL .embed path (``out_path`` is the tmp file). Only fp16 files are
    cached, so that the cached rows equal the file's.

    ``window_assembly="device"``: upload the waveform once and gather the
    overlap windows on the device (``encode_spans``); "host" slices and
    stages the windows on the host (``encode``). ``waveform``: the audio,
    when the caller has read it already. ``final_path``: rename the
    written file to it. The write and rename are the span ``embed.write``
    (``utils/trace.py``).
    """
    fused = embed_cache.enabled and cache_key is not None and fp16
    if window_assembly == "device":
        if waveform is None:
            waveform = load_waveform(wave_path, sr=SAMPLE_RATE)
        emb = embed_model.encode_spans(waveform, segments, keep_device=fused, fp16_pull=fp16)
    else:
        emb = embed_model.encode(slice_segments(wave_path, segments), keep_device=fused,
                                 fp16_pull=fp16)
    if fused:
        emb, dev = emb
        embed_cache.put(cache_key, emb.shape[0], dev)
    with trace.EMBED.span("embed.write", getattr(embed_model, "device", None), host_only=True):
        if embed_model_type == "speech_laser":
            write_stopes_embedding(emb, out_path, fp16=fp16)
        else:
            write_np_embeddings(emb, out_path, fp16=fp16)
        if final_path is not None:
            os.replace(out_path, final_path)
    return emb
