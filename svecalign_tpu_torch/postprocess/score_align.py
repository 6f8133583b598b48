"""Stage 6.7 -- margin-score alignments with the per-language k-NN indexes.

Port of the JAX package's ``postprocess/score_align.py``. For each pair:
load the src/tgt embeddings from the pointer tsvs, L2-normalize, search
(k = 16) each side against the OTHER language's index on the device, and
score ``margin = cos(x, y) / ((avg_kNN_xy + avg_kNN_yx) / 2)`` (ratio; or
the distance variant). L2^2 -> cosine is ``cos = (2 - L2^2) / 2``. The
queries of many pairs are batched into chunks of ``CHUNK_ROWS`` rows, one
search per direction and chunk; margins are row-wise, so they do not
depend on the batching. The margin arithmetic is numpy fp32 on the host,
as in JAX, and reaches the writer as an ``np.float32`` array: its
``f"{x}"`` digits are the file format. (Reference
svecalign/postprocess/score_align.py, faiss replaced by
:mod:`svecalign_tpu_torch.ops.topk`.)

In a fused pipeline run (``utils/embed_cache.py`` enabled) each chunk's
queries are gathered on the card from the rows the embed stages left
there, and normalization, both searches and the margins run there
(:func:`compute_margin_device`); only the (n,) margins come back. A chunk
with any row not cached takes the file path, as in JAX.

``--sharded_index`` shards whatever index was loaded, Flat or IVF, over
the local devices' mesh (``ops/topk.py``'s ``ShardedFlatIndex`` and
``ShardedIVFIndex``, faiss's fp16-shard in the reference); a Flat corpus
the fused pipeline left on the card is split there, device to device.
``--gpu_type`` is accepted and ignored, as in JAX.

CLI: ``python -m svecalign_tpu_torch.postprocess.score_align METADATA
OUT_DIR --embed_dir E --align_dir A --src_lang S --tgt_lang T --index_dir I
[--num_probe 128] [--embed_fp16] [--embed_stopes] [--margin ratio] [--k 16]
[--query_upload fp32|fp16] [--corpus_quant fp16|int8] [--device {cuda,cpu}]``
"""

import argparse
from pathlib import Path
from time import perf_counter
from typing import List, Tuple

import numpy as np
import torch

from svecalign_tpu_torch.ops.topk import (
    FlatIndex,
    IVFIndex,
    ShardedFlatIndex,
    ShardedIVFIndex,
    normalize_l2,
    normalize_rows_device,
)
from svecalign_tpu_torch.parallel.mesh import make_mesh
from svecalign_tpu_torch.postprocess.prep_index import (
    load_embed_from_entries,
    parse_embed_tsv_entries,
)
from svecalign_tpu_torch.utils import embed_cache
from svecalign_tpu_torch.utils.file_utils import read_alignments, read_metadata
from svecalign_tpu_torch.utils.index_utils import load_index
from svecalign_tpu_torch.utils.log_utils import logging, my_tqdm
from svecalign_tpu_torch.utils.torch_setup import DEVICES, resolve_device

logger = logging.getLogger(__name__)

# queries of many pairs per search: margins are row-wise, so scores do not
# change, but each chunk costs ONE search per direction instead of one per pair
CHUNK_ROWS = 65536

phase_seconds = {}
"""Host wall seconds of the last run by phase: ``index_load`` (read both
index files), ``query_load`` (pointer tsvs and embedding rows),
``search`` (both directions and the margins; results are pulled to the
host, so the device is done), ``write`` (the scored alignment files)."""


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("metadata", type=str,
                        help="the meta file that each line contains paired audio paths")
    parser.add_argument("out_dir", type=str,
                        help="dir to store the margin-scored alignments.")
    parser.add_argument("--embed_dir", type=str, required=True,
                        help="the dir for embedding tsvs.")
    parser.add_argument("--align_dir", type=str, required=True,
                        help="the dir for concatenated alignments.")
    parser.add_argument("--src_lang", type=str, required=True)
    parser.add_argument("--tgt_lang", type=str, required=True)
    parser.add_argument("--index_dir", type=str, required=True,
                        help="where the indexes are saved.")
    parser.add_argument("--num_probe", type=int, default=128)
    parser.add_argument("--gpu_type", type=str, default="fp16-shard",
                        help="accepted for CLI parity; ignored.")
    parser.add_argument("--embed_fp16", action="store_true", default=False)
    parser.add_argument("--embed_stopes", action="store_true", default=False)
    parser.add_argument("--margin", type=str, default="ratio",
                        help="Margin for xSIM calculation: ratio or distance.")
    parser.add_argument("--k", type=int, default=16, help="number of nearest neighbors.")
    parser.add_argument("--query_upload", type=str, default="fp32",
                        choices=["fp32", "fp16"],
                        help="query upload precision: fp16 halves the bytes "
                             "(~1e-3 relative margin noise); fp32 is exact.")
    parser.add_argument("--sharded_index", action="store_true", default=False,
                        help="shard the loaded index (Flat or IVF) row-wise over the "
                             "local devices (faiss fp16-shard).")
    parser.add_argument("--corpus_quant", type=str, default="fp16",
                        choices=["fp16", "int8"],
                        help="device-corpus precision for Flat indexes: int8 "
                             "halves fp16's memory and searches with a bf16 "
                             "GEMM (~1e-3 relative margin noise); fp16 is "
                             "exact. IVF keeps fp16.")
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run on the card (default) or on the CPU.")
    return parser.parse_args(argv)


def find_valid_metas(meta: List[Tuple[str, str]], embed_dir: Path) -> List[str]:
    res = []
    for src_aud, tgt_aud in meta:
        src_id = Path(src_aud).stem
        tgt_id = Path(tgt_aud).stem
        src_tsv = embed_dir / f"{src_id}-{tgt_id}.src.tsv"
        tgt_tsv = embed_dir / f"{src_id}-{tgt_id}.tgt.tsv"
        if src_tsv.exists() and tgt_tsv.exists():
            res.append(f"{src_id}-{tgt_id}")
        elif not src_tsv.exists() and not tgt_tsv.exists():
            logger.warning(f"{src_tsv} and {tgt_tsv} not exist")
        else:
            raise FileNotFoundError(
                f"{src_tsv}: {src_tsv.exists()} | {tgt_tsv}: {tgt_tsv.exists()}")
    logger.info(f"Kept {len(res)}/{len(meta)}")
    return res


def write_to_output(
    align_dir: Path, align_ids: List[str], margin_scores: np.ndarray, out_dir: Path
) -> None:
    """One ``src:tgt:margin`` line per alignment; ``margin_scores`` must be
    an ``np.float32`` array, whose ``f"{x}"`` digits are the format."""
    margin_id = 0
    for ali_id in align_ids:
        alignments = read_alignments(align_dir / f"{ali_id}.txt")
        with open(out_dir / f"{ali_id}.txt", mode="w") as fp:
            for src, tgt in alignments:
                fp.write(f"{src}:{tgt}:{margin_scores[margin_id]}\n")
                margin_id += 1
    if margin_id != margin_scores.shape[0]:
        raise ValueError(f"{margin_id} alignments for {margin_scores.shape[0]} margins")


def l2_sq_to_cosine(x: np.ndarray) -> np.ndarray:
    """cos = (2 - L2^2) / 2 for unit vectors (reference score_align.py:118-121)."""
    return (2.0 - x) / 2.0


def compute_margin(
    idx_x, idx_y, x: np.ndarray, y: np.ndarray, k: int, margin: str
) -> np.ndarray:
    """Margin scores for row-paired (x_i, y_i); both sides search the other
    language's index. Vectorized version of reference score_align.py:124-161."""
    num_x, dim_x = x.shape
    num_y, dim_y = y.shape
    if num_x != num_y or dim_x != dim_y:
        raise ValueError(f"unpaired rows: {x.shape} {y.shape}")

    x = normalize_l2(x)
    y = normalize_l2(y)

    l2_xy, _ = idx_y.search(x, k)  # (num_x, k)
    l2_yx, _ = idx_x.search(y, k)

    avg_xy = l2_sq_to_cosine(l2_xy.mean(axis=1))
    avg_yx = l2_sq_to_cosine(l2_yx.mean(axis=1))

    a = np.einsum("nd,nd->n", x, y)
    b = (avg_xy + avg_yx) / 2.0
    if margin == "ratio":
        return (a / b).astype(np.float32)
    if margin == "distance":
        return (a - b).astype(np.float32)
    raise ValueError(f"Wrong margin type: {margin}")


def compute_margin_device(idx_x, idx_y, qx: torch.Tensor, qy: torch.Tensor, n: int, k: int,
                          margin: str) -> np.ndarray:
    """Fused-pipeline margins: ``qx``/``qy`` are (n_padded, dim) fp16 rows
    on the card, straight from the embed cache's gather. Normalization,
    both kNN searches and the margin formula run there; only the first
    ``n`` fp32 margins come back. Equals :func:`compute_margin` up to the
    fp32 summation order."""
    if margin not in ("ratio", "distance"):
        raise ValueError(f"Wrong margin type: {margin}")
    qx = normalize_rows_device(qx)
    qy = normalize_rows_device(qy)
    # Flat leaves its results on the card; IVF returns them on the host
    l2_xy = torch.as_tensor(idx_y.search_device_queries(qx, k)[0], device=qx.device)
    l2_yx = torch.as_tensor(idx_x.search_device_queries(qy, k)[0], device=qx.device)
    avg_xy = (2.0 - l2_xy.mean(dim=1)) / 2.0
    avg_yx = (2.0 - l2_yx.mean(dim=1)) / 2.0
    a = torch.sum(qx * qy, dim=1)
    b = (avg_xy + avg_yx) / 2.0
    m = a / b if margin == "ratio" else a - b
    return m[:n].cpu().numpy().astype(np.float32)


def shard_index(index, mesh, corpus_quant: str):
    """The ``--sharded_index`` tier of a loaded index: Flat and IVF
    corpora row-sharded over ``mesh``; int8 applies to Flat only."""
    if isinstance(index, FlatIndex):
        return ShardedFlatIndex.from_index(
            index, mesh, corpus_quant="int8" if corpus_quant == "int8" else "none")
    if isinstance(index, IVFIndex):
        if corpus_quant == "int8":
            logger.warning("--corpus_quant int8 only applies to Flat corpora; "
                           "sharded IVF keeps fp16")
        return ShardedIVFIndex(index, mesh, query_upload=index.query_upload)
    return index


def main(argv=None, mesh=None):
    """Run the stage on ``argv`` (default: the command line). ``mesh``:
    the devices ``--sharded_index`` shards over (default: every local
    device of ``--device``'s type, ``parallel.mesh.make_mesh``)."""
    args = parse_args(argv)
    logger.info(args)
    device = resolve_device(args.device)
    phase_seconds.clear()

    all_pairs = read_metadata(args.metadata)
    logger.info(f"fp16: {args.embed_fp16} | stopes: {args.embed_stopes}")
    logger.info(f"margin: {args.margin} | k: {args.k}")

    src_lang, tgt_lang = args.src_lang, args.tgt_lang
    embed_dir = Path(args.embed_dir) / f"{src_lang}-{tgt_lang}"
    align_dir = Path(args.align_dir) / f"{src_lang}-{tgt_lang}"

    out_dir = Path(args.out_dir) / f"{src_lang}-{tgt_lang}"
    out_dir.mkdir(parents=True, exist_ok=True)

    metas = find_valid_metas(all_pairs, embed_dir)
    del all_pairs
    if not metas:
        logger.warning("no pairs with embedding tsvs; nothing to score")
        return

    t0 = perf_counter()
    index_dir = Path(args.index_dir) / f"{src_lang}-{tgt_lang}"
    src_index_path = list((index_dir / src_lang).glob("*.populate.idx"))[0]
    tgt_index_path = list((index_dir / tgt_lang).glob("*.populate.idx"))[0]

    logger.info(f"Loading {src_index_path}")
    src_index = load_index(src_index_path, nprobe=args.num_probe, device=device)
    logger.info(f"Loading {tgt_index_path}")
    tgt_index = load_index(tgt_index_path, nprobe=args.num_probe, device=device)
    phase_seconds["index_load"] = perf_counter() - t0
    if args.query_upload == "fp16":
        src_index.query_upload = tgt_index.query_upload = "float16"
        logger.info("Queries upload as fp16 (half the bytes)")

    if args.corpus_quant == "int8" and not args.sharded_index:
        if isinstance(src_index, FlatIndex) and isinstance(tgt_index, FlatIndex):
            src_index.corpus_quant = tgt_index.corpus_quant = "int8"
            logger.info("Device corpora quantize to int8 (half fp16 memory, "
                        "bf16 GEMM search; ~1e-3 margin noise)")
        else:
            logger.warning("--corpus_quant int8 only applies to Flat "
                           "indexes; loaded %s/%s keep fp16",
                           type(src_index).__name__, type(tgt_index).__name__)

    if args.sharded_index:
        mesh = mesh if mesh is not None else make_mesh(device=device)
        src_index = shard_index(src_index, mesh, args.corpus_quant)
        tgt_index = shard_index(tgt_index, mesh, args.corpus_quant)
        logger.info(f"Corpora sharded over {mesh} ({type(src_index).__name__} / "
                    f"{type(tgt_index).__name__})")

    if min(src_index.ntotal, tgt_index.ntotal) < args.k:
        # faiss pads missing neighbors with huge distances, so the k-mean
        # in the margin formula degenerates for corpora smaller than k;
        # the reference behaves identically
        logger.warning(
            f"index smaller than k={args.k} "
            f"(src {src_index.ntotal}, tgt {tgt_index.ntotal}): margin "
            "denominators include +inf padding and scores will collapse; "
            "lower --k to at most the corpus size"
        )

    # fused pipeline: when the embed stages left the rows on the card and
    # the indexes take device queries, each chunk is resolved by one gather
    # a side, with no query upload
    use_device = (
        embed_cache.enabled
        and hasattr(src_index, "search_device_queries")
        and hasattr(tgt_index, "search_device_queries")
        and min(src_index.ntotal, tgt_index.ntotal) >= args.k
    )
    if use_device:
        logger.info("Fused mode: resolving queries from the device embed cache")

    margin_scores = []
    phase_seconds["query_load"] = phase_seconds["search"] = 0.0
    buf_src_e, buf_tgt_e = [], []

    def flush_device(src_entries, tgt_entries) -> bool:
        t0 = perf_counter()
        gs = embed_cache.gather_rows_device(src_entries)
        gt = embed_cache.gather_rows_device(tgt_entries)
        if gs is None or gt is None:
            return False
        if gs[1] != gt[1]:
            raise ValueError(f"unpaired rows: {gs[1]} src, {gt[1]} tgt")
        t1 = perf_counter()
        margin_scores.append(compute_margin_device(src_index, tgt_index, gs[0], gt[0], gs[1],
                                                   args.k, args.margin))
        phase_seconds["query_load"] += t1 - t0
        phase_seconds["search"] += perf_counter() - t1
        return True

    def flush_host(src_entries, tgt_entries) -> None:
        t0 = perf_counter()
        src = load_embed_from_entries(
            src_entries, fp16_embed=args.embed_fp16, use_stopes=args.embed_stopes
        )
        tgt = load_embed_from_entries(
            tgt_entries, fp16_embed=args.embed_fp16, use_stopes=args.embed_stopes
        )
        t1 = perf_counter()
        margin_scores.append(
            compute_margin(src_index, tgt_index, src, tgt, args.k, args.margin)
        )
        phase_seconds["query_load"] += t1 - t0
        phase_seconds["search"] += perf_counter() - t1

    def flush():
        nonlocal buf_src_e, buf_tgt_e
        if not buf_src_e:
            return
        if not (use_device and flush_device(buf_src_e, buf_tgt_e)):
            flush_host(buf_src_e, buf_tgt_e)
        buf_src_e, buf_tgt_e = [], []

    for align_id in my_tqdm(metas):
        t0 = perf_counter()
        buf_src_e.extend(parse_embed_tsv_entries(embed_dir / f"{align_id}.src.tsv"))
        buf_tgt_e.extend(parse_embed_tsv_entries(embed_dir / f"{align_id}.tgt.tsv"))
        phase_seconds["query_load"] += perf_counter() - t0
        if len(buf_src_e) >= CHUNK_ROWS:
            flush()
    flush()
    margin_scores = np.concatenate(margin_scores, axis=0)

    t0 = perf_counter()
    logger.info(f"Writing to {out_dir}...")
    write_to_output(align_dir, metas, margin_scores, out_dir)
    phase_seconds["write"] = perf_counter() - t0
    logger.info("Done!")


if __name__ == "__main__":
    main()
