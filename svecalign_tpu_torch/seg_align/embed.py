"""Stage 5.3 -- embed every concatenated segment of every audio file.

Port of the JAX package's ``seg_align/embed.py``. For each audio: read its
concat-segment windows, embed them in bucketed batches on the card, write
``OUT/{lang}/{stem}.embed``: fp16 rows (fp32 with ``--embed_fp32``), a
stopes ``.npy`` for SpeechLASER (the default), headerless raw rows for
SONAR. Sharding (``--rank/--n_shard`` over the sorted inputs),
skip-existing and the atomic rename (``{stem}.tmp.embed`` -> ``{stem}.embed``)
behave as in JAX. While the fused handoff is on (``pipeline --fused``,
``utils/embed_cache.py``) each file's fp16 rows also stay on the card,
keyed by the final ``.embed`` path, for stages 5.4, 6.6 and 6.7.

CLI: ``python -m svecalign_tpu_torch.seg_align.embed METADATA OUT_DIR
--concat_dir C --lang L [--use_tgt] [--rank/--n_shard]
[--embed_model_type speech_laser|sonar] [--sl_ckpt_dir D --sl_ckpt_name W.npz]
[--max_tokens 2400000] [--sonar_name W.npz] [--batch_size 16]
[--upload_precision int16|fp32] [--window_assembly device|host]
[--embed_fp32] [--device {cuda,cpu}]``

The flags are the JAX CLI's plus ``--device``: the stage runs on the card
unless ``--device cpu`` is given, and raises without a card.
On a card the encoder's forward replays one CUDA graph per chunk shape,
captured at the shape's first chunk (``models/encode_common.py``).
``SVECALIGN_EMBED_PROFILE=1`` logs per-file phase times; a replayed
forward is one phase, ``trunk_s`` (the eager forward, on the CPU, splits
it into ``frontend_s``: SONAR's fbank or LASER's conv extractor;
``trunk_s``; ``pooler_s``: the attention pooler or the masked max pool).
"""

import argparse
import os
import time
from pathlib import Path

from svecalign_tpu_torch.models import encode_common
from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE, load_waveform
from svecalign_tpu_torch.utils.embed_model_utils import (
    add_embed_args,
    embed_segments_to_file,
    load_embed_model,
)
from svecalign_tpu_torch.utils.file_utils import read_metadata, read_segments
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.mp_utils import get_shard_range
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str,
                        help="the output dir. will save as *.embed.")
    parser.add_argument("--concat_dir", type=str, required=True,
                        help="will apply embedding to all segments files (*.txt) here.")
    parser.add_argument("--lang", type=str, required=True,
                        help="language. read from `concat_dir/lang`, output to `out_dir/lang`.")
    parser.add_argument("--use_tgt", action="store_true", default=False,
                        help="whether to read target side.")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--n_shard", type=int, default=1)
    add_embed_args(parser)
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run on the card (default) or on the CPU.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    device = resolve_device(args.device)

    all_pairs = read_metadata(args.metadata)
    all_inputs = sorted({pair[1] if args.use_tgt else pair[0] for pair in all_pairs})
    start, end = get_shard_range(len(all_inputs), args.n_shard, args.rank)
    all_inputs = all_inputs[start:end]

    concat_dir = Path(args.concat_dir) / args.lang
    out_dir = Path(args.out_dir) / args.lang
    out_dir.mkdir(parents=True, exist_ok=True)

    logger.info(f"Embed model = {args.embed_model_type}")
    embed_model = load_embed_model(
        args.embed_model_type,
        sl_ckpt_dir=args.sl_ckpt_dir,
        sl_ckpt_name=args.sl_ckpt_name,
        max_tokens=args.max_tokens,
        sonar_name=args.sonar_name,
        batch_size=args.batch_size or 16,
        upload_precision=args.upload_precision,
        device=device,
    )
    logger.info(f"Embed with {'fp32' if args.embed_fp32 else 'fp16'}")
    profiling = os.environ.get("SVECALIGN_EMBED_PROFILE", "") not in ("", "0")

    for audio_file in my_tqdm(all_inputs):
        audio_stem = Path(audio_file).stem
        seg_file = concat_dir / f"{audio_stem}.txt"
        if not seg_file.exists():
            logger.warning(f"{seg_file} not exists! Skip.")
            continue
        all_segments = read_segments(seg_file)
        if len(all_segments) == 0:
            logger.warning(f"encountered empty segment file {seg_file}, "
                           f"corresponding audio file is {audio_file}")
            continue
        embed_out_path = out_dir / f"{audio_stem}.embed"
        if embed_out_path.exists():
            continue  # skip processed inputs
        tmp_out_path = out_dir / f"{audio_stem}.tmp.embed"

        if profiling:
            encode_common.start_encode_profile()
        prof = encode_common.encode_profile
        t0 = time.perf_counter()
        waveform = None
        if args.window_assembly == "device":
            waveform = load_waveform(audio_file, sr=SAMPLE_RATE)
        t1 = time.perf_counter()
        embed_segments_to_file(
            embed_model, args.embed_model_type, audio_file, all_segments,
            str(tmp_out_path), fp16=not args.embed_fp32,
            # fused pipeline: keep the rows on the device under the FINAL path
            cache_key=str(embed_out_path),
            window_assembly=args.window_assembly, waveform=waveform,
        )
        tmp_out_path.replace(embed_out_path)
        if prof is not None:
            prof["read_s"] = prof.get("read_s", 0.0) + t1 - t0
            prof["file_s"] = prof.get("file_s", 0.0) + time.perf_counter() - t0
        if profiling:
            logger.info(f"profile {audio_stem}: " + " ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in prof.items()))
    logger.info("Finished!")


if __name__ == "__main__":
    main()
