"""Stage 6.6 -- build the k-NN index per language.

Port of the JAX package's ``postprocess/prep_index.py``:

1. sample ``--sample_ratio`` of the embedding-pointer tsv files (seeded
   Random(42), as the reference) and concatenate their embeddings into
   ``sample.embed``;
2. pick an index type by corpus size and train it (k-means for IVF on the
   device; Flat training is a no-op and writes an empty index);
3. populate: L2-normalize and add ALL embeddings.

Outputs ``${type}.train.idx`` and ``${type}.populate.idx`` in the faiss
binary formats, byte-identical to the JAX CLI's. (Reference
svecalign/postprocess/prep_index.py, faiss-gpu replaced by
:mod:`svecalign_tpu_torch.ops.topk`.) In a fused pipeline run
(``utils/embed_cache.py`` enabled) a Flat corpus is also gathered from the
rows the embed stages left on the card (``FlatIndex.set_device_corpus``),
and the live index is handed to stage 6.7; the files stay as they are.

CLI: ``python -m svecalign_tpu_torch.postprocess.prep_index METADATA OUT_DIR
--data_dir D --src_lang S --tgt_lang T [--use_tgt] [--sample_ratio 0.5]
[--embed_fp16] [--embed_stopes] [--index_type Flat|IVF{nlist}]
[--device {cuda,cpu}]``
"""

import argparse
import random
from collections import defaultdict
from pathlib import Path
from time import perf_counter
from typing import List, Tuple

import numpy as np

from svecalign_tpu_torch.ops.topk import FlatIndex, IVFIndex, normalize_l2
from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils.embedding_utils import (
    load_sent_embeddings,
    write_stopes_embedding,
)
from svecalign_tpu_torch.utils.file_utils import delete_if_exist, read_metadata
from svecalign_tpu_torch.utils.index_utils import (
    determine_index_type,
    write_flat_index,
    write_ivf_index,
)
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)

phase_seconds = {}
"""Host wall seconds of the last run by phase: ``sample`` (read the
sampled files, write sample.embed), ``train``, ``populate`` (read and
add every row), ``write`` (the populated index file)."""


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str,
                        help="dir to store the sampled embeddings, and indices.")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="the dir for embedding tsvs.")
    parser.add_argument("--use_tgt", action="store_true", default=False)
    parser.add_argument("--sample_ratio", type=float, default=0.5,
                        help="percentage of embedding files used for training indexes.")
    parser.add_argument("--embed_fp16", action="store_true", default=False,
                        help="whether the embeddings are saved in fp16.")
    parser.add_argument("--embed_stopes", action="store_true", default=False,
                        help="whether the input embeddings are .npy (stopes flavor).")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--index_type", type=str, default=None,
                        help="override the size-based index type selection "
                             "(Flat or IVF{nlist}); default picks by corpus "
                             "size like stopes determine_faiss_index_type.")
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run on the card (default) or on the CPU.")
    return parser.parse_args(argv)


def find_embed_files(
    meta: List[Tuple[str, str]], data_dir: Path, use_tgt: bool
) -> List[Path]:
    res = []
    for src_aud, tgt_aud in meta:
        src_id = Path(src_aud).stem
        tgt_id = Path(tgt_aud).stem
        src_tsv = data_dir / f"{src_id}-{tgt_id}.src.tsv"
        tgt_tsv = data_dir / f"{src_id}-{tgt_id}.tgt.tsv"
        if src_tsv.exists() and tgt_tsv.exists():
            res.append(tgt_tsv if use_tgt else src_tsv)
        elif not src_tsv.exists() and not tgt_tsv.exists():
            logger.warning(f"{src_tsv} and {tgt_tsv} do not exist")
        else:
            raise FileNotFoundError(
                f"{src_tsv}: {src_tsv.exists()} | {tgt_tsv}: {tgt_tsv.exists()}")
    logger.info(f"Kept {len(res)}/{len(meta)} files")
    return res


def parse_embed_tsv_entries(tsv_path: Path):
    """The raw [(embed_path, row_id), ...] of a pointer tsv in line order."""
    entries = []
    with open(tsv_path) as fp:
        for line in fp:
            path, _id = line.strip().split("\t")
            entries.append((path, int(_id)))
    return entries


def load_embed_from_entries(
    entries, fp16_embed: bool, use_stopes: bool
) -> np.ndarray:
    """Resolve pointer entries [(embed_path, row_id), ...] into an
    (N, dim) float32 matrix preserving entry order."""
    info_dict = defaultdict(list)
    for ii, (path, _id) in enumerate(entries):
        info_dict[path].append((ii, _id))

    true_ids = []
    embeds = []
    for embed_path, rows in info_dict.items():
        embed = load_sent_embeddings(
            embed_path, fp16_embed=fp16_embed, use_stopes=use_stopes, stopes_mode="memory"
        )
        for true_id, embed_id in rows:
            true_ids.append(true_id)
            embeds.append(embed[embed_id])

    order = np.argsort(true_ids)
    return np.stack(embeds)[order]


def load_embed_from_tsv(
    tsv_path: Path, fp16_embed: bool, use_stopes: bool
) -> np.ndarray:
    """Resolve an embed-pointer tsv (``embed_path \\t row_id`` per line)
    into an (N, dim) float32 matrix preserving line order."""
    return load_embed_from_entries(
        parse_embed_tsv_entries(tsv_path),
        fp16_embed=fp16_embed, use_stopes=use_stopes,
    )


def dump_embedding_to_file(
    embed_paths: List[Path], out_path: Path, fp16_embed: bool, use_stopes: bool
) -> Tuple[int, Path]:
    """Concatenate the sampled files' embeddings into one training file."""
    delete_if_exist(out_path, verbose=True)
    arrays = []
    n_lines = 0
    for path in my_tqdm(embed_paths):
        arr = load_embed_from_tsv(path, fp16_embed=fp16_embed, use_stopes=use_stopes)
        arrays.append(arr)
        n_lines += arr.shape[0]
    combined = np.concatenate(arrays, axis=0)
    write_stopes_embedding(combined, str(out_path), fp16=fp16_embed)
    logger.info(combined.shape)
    return n_lines, out_path.resolve()


def main(argv=None):
    args = parse_args(argv)
    logger.info(args)
    device = resolve_device(args.device)
    phase_seconds.clear()

    all_pairs = read_metadata(args.metadata)

    src_lang, tgt_lang = args.src_lang, args.tgt_lang
    data_dir = Path(args.data_dir) / f"{src_lang}-{tgt_lang}"

    out_dir = Path(args.out_dir) / f"{src_lang}-{tgt_lang}"
    out_dir = out_dir / (tgt_lang if args.use_tgt else src_lang)
    out_dir.mkdir(parents=True, exist_ok=True)

    # 0. valid inputs, in metadata order
    embed_paths = find_embed_files(all_pairs, data_dir, args.use_tgt)
    del all_pairs
    if not embed_paths:
        # every pair was filtered out upstream: nothing to index
        logger.warning("no embedding tsvs found; skipping index build")
        return

    # 1. sample training files (seeded, as the reference: prep_index.py:220)
    t0 = perf_counter()
    sample_size = max(int(args.sample_ratio * len(embed_paths)), 1)
    logger.info(f"Will sample {sample_size}/{len(embed_paths)} files.")
    training_samples = random.Random(42).sample(embed_paths, k=sample_size)
    logger.info(f"Examples: {training_samples[:5]}")

    n_samples, sample_embed_path = dump_embedding_to_file(
        training_samples,
        out_path=out_dir / "sample.embed",
        fp16_embed=args.embed_fp16,
        use_stopes=args.embed_stopes,
    )
    logger.info(f"Sampled {n_samples} embeddings.")

    n_embed_tot = 0
    for _path in embed_paths:
        with open(_path) as fp:
            n_embed_tot += sum(1 for _ in fp)
    logger.info(f"#embeddings: {n_embed_tot}")
    phase_seconds["sample"] = perf_counter() - t0

    # 2. train
    t0 = perf_counter()
    index_type = args.index_type or determine_index_type(n_embed_tot)
    logger.info(f"Training index type {index_type}...")

    train_vecs = normalize_l2(
        load_sent_embeddings(
            str(sample_embed_path), fp16_embed=args.embed_fp16, use_stopes=True
        )
    )
    train_path = out_dir / f"{index_type}.train.idx"
    if index_type == "Flat":
        write_flat_index(np.zeros((0, train_vecs.shape[1]), np.float32), train_path)
        index = FlatIndex(dim=train_vecs.shape[1], device=device)
    else:
        nlist = int(index_type[len("IVF"):])
        index = IVFIndex(dim=train_vecs.shape[1], nlist=nlist, device=device)
        index.train(train_vecs)
        write_ivf_index(index, train_path)
    logger.info(f"Dumped index to {train_path}")
    phase_seconds["train"] = perf_counter() - t0

    # 3. populate
    t0 = perf_counter()
    for path in my_tqdm(embed_paths):
        embed = load_embed_from_tsv(path, fp16_embed=args.embed_fp16,
                                    use_stopes=args.embed_stopes)
        index.add(normalize_l2(embed))
    phase_seconds["populate"] = perf_counter() - t0

    t0 = perf_counter()
    populate_path = out_dir / f"{index_type}.populate.idx"
    if index_type == "Flat":
        write_flat_index(index.corpus, populate_path)
    else:
        write_ivf_index(index, populate_path)
    phase_seconds["write"] = perf_counter() - t0

    # fused pipeline: assemble the same corpus on the card from the rows
    # the embed stages left there (the file above stays the durable copy)
    # and hand the live index to score_align
    if embed_cache.enabled:
        if index_type == "Flat" and index.ntotal:
            entries = []
            for path in embed_paths:
                entries.extend(parse_embed_tsv_entries(path))
            gathered = embed_cache.gather_rows_device(entries, pad_multiple=FlatIndex.BLOCK)
            if gathered is not None:
                index.set_device_corpus(*gathered)
                logger.info(f"Device-resident corpus installed ({gathered[1]} rows, no upload)")
            else:
                logger.info("Embed cache incomplete; corpus uploads lazily")
        embed_cache.register_index(populate_path, index)
    logger.info("Finished!")


if __name__ == "__main__":
    main()
