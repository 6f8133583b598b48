"""Stage 4.1 — VAD segmentation of each audio file.

Port of the JAX package's ``preprocess/segment.py``; its files are the
JAX CLI's, byte for byte. Writes ``"start end"`` frame lines at 16 kHz per
file to ``OUT/{lang}/{stem}.txt`` with skip-existing and an atomic tmp
rename; an empty placeholder file marks no-speech audio. (Reference
svecalign/preprocess/segment.py, torch.hub silero replaced by
``models/vad.py``.)

``--vad_model energy`` (the default) is host numpy. ``--vad_model
silero_jax`` (the name kept for CLI parity) runs the silero v4 graph on
``--device``. As every stage of the port, it runs on the card unless
``--device cpu`` is given, and raises without one.

CLI: ``python -m svecalign_tpu_torch.preprocess.segment METADATA OUT_DIR
--lang L [--use_tgt] [--rank R --n_shard N] [--vad_model silero_jax|energy]
[--vad_ckpt PATH] [--threshold 0.5] [--device {cuda,cpu}]``
"""

import argparse
from pathlib import Path
from typing import List, Optional

from svecalign_tpu_torch.models.vad import EnergyVAD, SileroV4VAD, get_speech_timestamps
from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE, load_waveform
from svecalign_tpu_torch.utils.file_utils import check_exist, read_metadata
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.mp_utils import get_shard_range
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str, help="base output directory.")
    parser.add_argument("--lang", type=str, required=True,
                        help="output segments to `out_dir/lang`")
    parser.add_argument("--use_tgt", default=False, action="store_true",
                        help="whether to read target side.")
    parser.add_argument("--rank", type=int, default=0,
                        help="which shard this job will process. range: [0, n_shard).")
    parser.add_argument("--n_shard", type=int, default=1,
                        help="number of shards in total.")
    parser.add_argument("--cache_dir", type=str, default=None,
                        help="accepted for CLI parity (torch.hub cache in the reference).")
    parser.add_argument("--vad_version", type=str, default="silero_jax",
                        help="accepted for CLI parity; selects the local model family.")
    parser.add_argument("--vad_model", type=str, default="energy",
                        choices=["silero_jax", "energy"],
                        help="probability model: the silero v4 graph (needs --vad_ckpt, "
                             "converted via tools/convert_torch_ckpt.py silero) or the "
                             "weight-free energy VAD.")
    parser.add_argument("--vad_ckpt", type=str, default=None,
                        help=".npz silero v4 weights (geometry derived from tensor shapes).")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="where the silero graph runs (the energy VAD is host numpy)")
    return parser.parse_args(argv)


def build_vad(vad_model: str, vad_ckpt: Optional[str], device="cuda"):
    if vad_model == "energy":
        return EnergyVAD()
    return SileroV4VAD(ckpt_path=vad_ckpt, device=device)


def vad(
    file_paths: List[str],
    output_dir: Path,
    vad_model: str = "energy",
    vad_ckpt: Optional[str] = None,
    threshold: float = 0.5,
    device="cuda",
) -> None:
    model = build_vad(vad_model, vad_ckpt, device)

    for in_path in my_tqdm(file_paths):
        in_path = Path(in_path)
        if not check_exist(in_path):
            raise FileNotFoundError(in_path)

        tmp_out_path = output_dir / f"{in_path.stem}.tmp.txt"
        if tmp_out_path.exists():
            tmp_out_path.unlink()

        out_path = output_dir / f"{in_path.stem}.txt"
        if out_path.exists():
            continue  # skip processed inputs

        waveform = load_waveform(in_path.as_posix(), sr=SAMPLE_RATE)
        if waveform.ndim == 2:
            waveform = waveform[:, 0]
        speech_timestamps = get_speech_timestamps(waveform, model, threshold=threshold)

        if len(speech_timestamps) == 0:
            logger.info(f"{in_path} has none speech parts.")
            with open(tmp_out_path, mode="w"):
                pass  # empty placeholder
        else:
            with open(tmp_out_path, mode="w") as fp:
                for activity in speech_timestamps:
                    fp.write(f"{activity['start']} {activity['end']}\n")
        tmp_out_path.replace(out_path)


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    resolve_device(args.device)  # the stage runs on the card unless asked for the CPU

    all_pairs = read_metadata(args.metadata)
    all_inputs = sorted({pair[1] if args.use_tgt else pair[0] for pair in all_pairs})

    start, end = get_shard_range(len(all_inputs), nshard=args.n_shard, rank=args.rank)
    all_inputs = all_inputs[start:end]
    logger.info(f"{len(all_inputs)} total || Example of inputs: {all_inputs[:3]}")

    output_dir = Path(args.out_dir) / args.lang
    output_dir.mkdir(parents=True, exist_ok=True)

    vad(
        file_paths=all_inputs,
        output_dir=output_dir,
        vad_model=args.vad_model,
        vad_ckpt=args.vad_ckpt,
        threshold=args.threshold,
        device=args.device,
    )
    logger.info("Finished!")


if __name__ == "__main__":
    main()
