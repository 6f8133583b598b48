"""Human-audit tooling: dump aligned spans as audio + paginated HTML tables.

Port of the JAX package's ``analysis/dump_alignments.py``, host only; its
clips and pages are the JAX tool's, byte for byte.

Slices each aligned (src, tgt) span pair to ogg files and emits HTML pages
(100 rows each) with embedded ``<audio>`` players so a bilingual listener
can spot-check mining quality. (Reference analysis/dump_alignments.py:
141-239 — same outputs, native audio encode instead of soundfile.)

``--asr`` transcribes both sides of every dumped alignment with the port's
own Whisper (``models/whisper.py``, ``analysis/asr.py``; no ``whisper``
package): it loads openai's checkpoint file ``<whisper_root>/<whisper_size>.pt``
(``--whisper_root`` defaults to openai's download root,
``$XDG_CACHE_HOME/whisper`` or ``~/.cache/whisper``) onto ``--device`` and
raises, naming the path, where there is none: nothing is downloaded. Both
sides of a pair are one call, in batches, greedy, each side in its
language (``--src_lang`` / ``--tgt_lang``, required with ``--asr``: no
language detection). ``--asr_model parakeet-tdt`` transcribes with the
port's Parakeet-TDT instead (``models/parakeet.py``, ``analysis/tdt.py``):
it loads NVIDIA's ``.nemo`` archive ``--parakeet_ckpt`` onto ``--device``
and raises, naming the path, where there is none; the languages are then
the model's to detect. The pages show the token ids: no vocabulary file is
in the repository to turn them into text.

CLI: ``python -m svecalign_tpu_torch.analysis.dump_alignments METADATA OUT_DIR
--align_dir A --seg_dir D --src_lang S --tgt_lang T [--max_rows N]
[--asr [--asr_model whisper|parakeet-tdt] --whisper_size SIZE --whisper_root DIR
--parakeet_ckpt FILE.nemo --device cuda|cpu]
[--rows_per_page 100]``
"""

import argparse
import html
import os
from pathlib import Path
from typing import List, Optional, Tuple

from svecalign_tpu_torch.analysis import asr, tdt
from svecalign_tpu_torch.models import parakeet, whisper
from svecalign_tpu_torch.utils.audio_utils import Segment
from svecalign_tpu_torch.utils.file_utils import (
    alignments_to_timestamps,
    read_alignments,
    read_alignments_with_score,
    read_metadata,
    read_segments,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    # batch interface: metadata + directories (like every other stage)
    parser.add_argument("metadata", type=str, nargs="?", default=None,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir_pos", type=str, nargs="?", default=None,
                        help="output dir for wavs + html.")
    parser.add_argument("--align_dir", type=str, default=None)
    parser.add_argument("--seg_dir", type=str, default=None)
    parser.add_argument("--src_lang", type=str, default=None)
    parser.add_argument("--tgt_lang", type=str, default=None)
    # per-pair interface (reference analysis/README.md flag surface)
    parser.add_argument("--align_path", type=str, default=None)
    parser.add_argument("--src_segs", type=str, default=None)
    parser.add_argument("--src_wav", type=str, default=None)
    parser.add_argument("--tgt_segs", type=str, default=None)
    parser.add_argument("--tgt_wav", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--asr", dest="with_asr", action="store_true", default=False,
                        help="transcribe both sides with the port's ASR (token ids).")
    parser.add_argument("--asr_model", type=str, default="whisper", choices=ASR_MODELS,
                        help="the ASR of --asr")
    parser.add_argument("--whisper_size", type=str, default="medium",
                        help="the checkpoint <whisper_root>/<whisper_size>.pt")
    parser.add_argument("--whisper_root", type=str, default=None,
                        help="directory of openai's checkpoints (default: openai's "
                             "download root)")
    parser.add_argument("--parakeet_ckpt", type=str, default=None,
                        help="NVIDIA's .nemo archive of Parakeet-TDT (--asr_model "
                             "parakeet-tdt)")
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="where --asr runs its model")
    # shared knobs
    parser.add_argument("--max_rows", type=int, default=None,
                        help="cap the number of dumped alignments per pair.")
    parser.add_argument("--rows_per_page", type=int, default=100)
    return parser.parse_args(argv)


ASR_MODELS = ("whisper", "parakeet-tdt")
_ASR = {}  # checkpoint path and device -> transcriber: one load per process


def default_whisper_root() -> str:
    """openai's download root: ``$XDG_CACHE_HOME/whisper`` or
    ``~/.cache/whisper``."""
    cache = os.getenv("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "whisper")


def _transcribe(sides, size: str, root: Optional[str], device, asr_model: str = "whisper",
                parakeet_ckpt: Optional[str] = None) -> List[List[str]]:
    """Each side's clips (``(audio path, spans, lang)``) as strings of
    token ids of ``asr_model``, both sides in one call."""
    if asr_model not in ASR_MODELS:
        raise ValueError(f"--asr_model must be one of {ASR_MODELS}, got {asr_model!r}")
    if asr_model == "whisper":
        path = Path(root or default_whisper_root()) / f"{size}.pt"
    elif parakeet_ckpt is None:
        raise ValueError("--asr_model parakeet-tdt needs --parakeet_ckpt (NVIDIA's .nemo "
                         "archive; nothing is downloaded)")
    else:
        path = Path(parakeet_ckpt)
    dev = resolve_device(device)
    key = (asr_model, str(path), str(dev))
    if key not in _ASR:
        _ASR.clear()  # one model at a time
        if asr_model == "whisper":
            _ASR[key] = asr.Transcriber(whisper.load_checkpoint(path, dev))
        else:
            _ASR[key] = tdt.TdtTranscriber(parakeet.load_nemo(path, dev))
        logger.info(f"ASR: {asr_model} from {path} on {dev}; transcripts are token ids (no "
                    f"vocabulary file is in the repository)")
    return [[" ".join(map(str, t.tokens)) for t in side]
            for side in asr.transcribe_sides(_ASR[key], sides)]


def write_single_html(
    rows: List[dict], out_path: Path, page: int, n_pages: int
) -> None:
    nav = " | ".join(
        f'<a href="page{p}.html">{p}</a>' if p != page else f"<b>{p}</b>"
        for p in range(n_pages)
    )
    parts = [
        "<html><head><meta charset='utf-8'><style>",
        "table{border-collapse:collapse}td,th{border:1px solid #999;padding:4px}",
        "</style></head><body>",
        f"<p>pages: {nav}</p>",
        "<table><tr><th>#</th><th>score</th><th>src</th><th>tgt</th></tr>",
    ]
    for r in rows:
        src_cell = f"<audio controls src='{r['src_audio']}'></audio>"
        tgt_cell = f"<audio controls src='{r['tgt_audio']}'></audio>"
        if r.get("src_text"):
            src_cell += f"<br>{html.escape(r['src_text'])}"
        if r.get("tgt_text"):
            tgt_cell += f"<br>{html.escape(r['tgt_text'])}"
        parts.append(
            f"<tr><td>{r['idx']}</td><td>{r['score']}</td>"
            f"<td>{src_cell}</td><td>{tgt_cell}</td></tr>"
        )
    parts.append(f"</table><p>pages: {nav}</p></body></html>")
    out_path.write_text("\n".join(parts))


def dump(
    align_path: Path,
    src_segs: List[Tuple[int, int]],
    tgt_segs: List[Tuple[int, int]],
    src_audio: str,
    tgt_audio: str,
    out_dir: Path,
    max_rows: Optional[int],
    rows_per_page: int,
    with_asr: bool,
    whisper_size: str = "medium",
    whisper_root: Optional[str] = None,
    src_lang: Optional[str] = None,
    tgt_lang: Optional[str] = None,
    device="cuda",
    asr_model: str = "whisper",
    parakeet_ckpt: Optional[str] = None,
) -> None:
    if with_asr and not (src_lang and tgt_lang):
        raise ValueError("--asr needs --src_lang and --tgt_lang (no language detection)")
    try:
        scored = read_alignments_with_score(align_path)
        aligns = [(s, t) for s, t, _ in scored]
        scores = [f"{c:.4f}" for _, _, c in scored]
    except ValueError:  # no score column
        aligns = read_alignments(align_path)
        scores = ["-"] * len(aligns)

    # deletions (an empty side) have no audio to dump
    keep = [i for i, (s, t) in enumerate(aligns) if s and t]
    aligns = [aligns[i] for i in keep]
    scores = [scores[i] for i in keep]

    src_times, tgt_times, n = alignments_to_timestamps(
        aligns, src_segs, tgt_segs, ignore_empty=False
    )
    if max_rows is not None:
        n = min(n, max_rows)

    wav_dir = out_dir / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    for i in my_tqdm(range(n)):
        src_file = wav_dir / f"{i}.src.ogg"
        tgt_file = wav_dir / f"{i}.tgt.ogg"
        Segment(src_times[i][0], src_times[i][1], src_audio).save(str(src_file))
        Segment(tgt_times[i][0], tgt_times[i][1], tgt_audio).save(str(tgt_file))
        rows.append(
            dict(
                idx=i,
                score=scores[i],
                src_audio=src_file.relative_to(out_dir).as_posix(),
                tgt_audio=tgt_file.relative_to(out_dir).as_posix(),
            )
        )

    if with_asr and n:
        src_texts, tgt_texts = _transcribe(
            [(src_audio, src_times[:n], src_lang), (tgt_audio, tgt_times[:n], tgt_lang)],
            whisper_size, whisper_root, device, asr_model, parakeet_ckpt)
        for r, s, t in zip(rows, src_texts, tgt_texts):
            r["src_text"] = s
            r["tgt_text"] = t

    n_pages = -(-len(rows) // rows_per_page)
    for page in range(n_pages):
        write_single_html(
            rows[page * rows_per_page : (page + 1) * rows_per_page],
            out_dir / f"page{page}.html",
            page,
            n_pages,
        )
    logger.info(f"Wrote {len(rows)} rows over {n_pages} HTML pages to {out_dir}")


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)

    if args.align_path:  # per-pair interface
        dump(
            Path(args.align_path),
            read_segments(args.src_segs),
            read_segments(args.tgt_segs),
            args.src_wav,
            args.tgt_wav,
            Path(args.out_dir or args.out_dir_pos or "./dump_out"),
            args.max_rows,
            args.rows_per_page,
            args.with_asr,
            args.whisper_size,
            args.whisper_root,
            args.src_lang,
            args.tgt_lang,
            args.device,
            args.asr_model,
            args.parakeet_ckpt,
        )
        logger.info("Finished!")
        return

    if not (args.metadata and (args.out_dir_pos or args.out_dir)):
        raise SystemExit("either --align_path (per-pair) or METADATA OUT_DIR --align_dir "
                         "--seg_dir (batch) must be given")
    args.out_dir = args.out_dir_pos or args.out_dir
    all_pairs = read_metadata(args.metadata)
    src_lang, tgt_lang = args.src_lang, args.tgt_lang
    align_dir = Path(args.align_dir) / f"{src_lang}-{tgt_lang}"
    seg_dir = Path(args.seg_dir)

    for src_audio, tgt_audio in all_pairs:
        src_stem = Path(src_audio).stem
        tgt_stem = Path(tgt_audio).stem
        align_path = align_dir / f"{src_stem}-{tgt_stem}.txt"
        if not align_path.exists():
            logger.warning(f"{align_path} not exist. Skip.")
            continue
        dump(
            align_path,
            read_segments(seg_dir / src_lang / f"{src_stem}.txt"),
            read_segments(seg_dir / tgt_lang / f"{tgt_stem}.txt"),
            src_audio,
            tgt_audio,
            Path(args.out_dir) / f"{src_stem}-{tgt_stem}",
            args.max_rows,
            args.rows_per_page,
            args.with_asr,
            args.whisper_size,
            args.whisper_root,
            src_lang,
            tgt_lang,
            args.device,
            args.asr_model,
            args.parakeet_ckpt,
        )
    logger.info("Finished!")


if __name__ == "__main__":
    main()
