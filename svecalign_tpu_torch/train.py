"""Encoder fine-tuning CLI: contrastive training on a mined tsv.

Port of the JAX package's ``train.py``, with the same flags plus
``--device``: the pipeline's final ``align.rm_overlap.sort.tsv.gz`` rows
are paired speech clips, and this stage fine-tunes the SpeechLASER
encoder on them with a symmetric InfoNCE objective
(``models/training.py``), data- and tensor-parallel over the local
devices' mesh (``--model_parallel``).

``load_rows`` and ``ClipBatcher`` are the JAX package's, so both packages
draw the same batches from the same tsv and seed.

Checkpoints: orbax has no torch counterpart, so every ``--save_every``
steps the fp32 parameters go to ``OUT/ckpt/<step>/params.pt``
(``torch.save``). Neither package resumes the other's ``ckpt/``; the
shared format is ``OUT/encoder_final.npz`` (``param_utils.save_params_npz``),
which either package loads. Resume follows the JAX CLI: the newest
``ckpt/<step>`` gives the parameters only, with a fresh optimizer state,
and the batcher restarts from its seed's first draw; ``--init_ckpt`` also
starts a fresh optimizer.

CLI: ``python -m svecalign_tpu_torch.train TSV OUT_DIR [--steps N]
[--batch_size B] [--lr 1e-4] [--init_ckpt W.npz] [--model_parallel 1]
[--max_seconds 10] [--min_score 0] [--save_every 100] [--seed 0]
[--device cuda|cpu]``
"""

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

import svecalign_tpu_torch.utils.file_utils as file_utils
from svecalign_tpu_torch.utils.audio_utils import SAMPLE_RATE, load_waveform
from svecalign_tpu_torch.utils.log_utils import logging
from svecalign_tpu_torch.utils.torch_setup import DEVICES

logger = logging.getLogger(__name__)

CKPT_FILE = "params.pt"


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("tsv", type=str,
                        help="mined tsv: score \\t src_path start end 16 \\t tgt_path start end 16")
    parser.add_argument("out_dir", type=str, help="checkpoint/output dir.")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--temperature", type=float, default=0.05)
    parser.add_argument("--init_ckpt", type=str, default=None,
                        help=".npz encoder weights to start from.")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="tensor-parallel degree (mesh 'model' axis).")
    parser.add_argument("--max_seconds", type=float, default=10.0,
                        help="clips are cropped/padded to this duration.")
    parser.add_argument("--min_score", type=float, default=0.0,
                        help="only train on rows with margin score >= this.")
    parser.add_argument("--save_every", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--encoder_layers", type=int, default=24)
    parser.add_argument("--encoder_dim", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                        help="run on the card (default) or, when asked, on the CPU.")
    return parser.parse_args(argv)


def load_rows(tsv_path: str, min_score: float):
    rows = []
    with file_utils.open(tsv_path) as fp:
        for line in fp:
            score_s, src_f, tgt_f = line.rstrip("\n").split("\t")
            if float(score_s) < min_score:
                continue
            sp, ss, se, _ = src_f.rsplit(" ", 3)
            tp, ts, te, _ = tgt_f.rsplit(" ", 3)
            rows.append(((sp, int(ss), int(se)), (tp, int(ts), int(te))))
    return rows


class ClipBatcher:
    """Random mined-pair batches; caches decoded waveforms per audio file."""

    def __init__(self, rows, batch_size: int, n_samples: int, seed: int):
        if len(rows) < 2:
            raise ValueError("need at least 2 mined pairs to train")
        self.rows = rows
        self.batch_size = batch_size
        self.n_samples = n_samples
        self.rng = np.random.default_rng(seed)
        self._wave_cache = {}

    def _wave(self, path: str) -> np.ndarray:
        if path not in self._wave_cache:
            w = load_waveform(path, sr=SAMPLE_RATE)
            self._wave_cache[path] = w if w.ndim == 1 else w[:, 0]
        return self._wave_cache[path]

    def _clip(self, spec) -> np.ndarray:
        path, start, end = spec
        wav = self._wave(path)[start:end][: self.n_samples]
        out = np.zeros(self.n_samples, dtype=np.float32)
        out[: len(wav)] = wav
        return out, min(end - start, self.n_samples)

    def next_batch(self):
        idx = self.rng.choice(len(self.rows), size=self.batch_size, replace=False)
        src = np.stack([self._clip(self.rows[i][0])[0] for i in idx])
        tgt = np.stack([self._clip(self.rows[i][1])[0] for i in idx])
        src_len = np.array([self._clip(self.rows[i][0])[1] for i in idx], np.int32)
        tgt_len = np.array([self._clip(self.rows[i][1])[1] for i in idx], np.int32)
        return dict(src_wav=src, src_len=src_len, tgt_wav=tgt, tgt_len=tgt_len)


def latest_checkpoint(ckpt_dir: Path) -> Optional[int]:
    """The newest step under ``ckpt_dir``, or None. A step directory
    without ``params.pt`` (another package's checkpoint) raises."""
    steps = sorted((int(p.name), p) for p in ckpt_dir.glob("*") if p.name.isdigit())
    if not steps:
        return None
    step, path = steps[-1]
    if not (path / CKPT_FILE).exists():
        raise ValueError(f"{path} holds no {CKPT_FILE}: a checkpoint of the JAX package? The "
                         "packages share encoder_final.npz, not ckpt/")
    return step


def main(argv=None) -> dict:
    """Train; returns ``{"start_step", "losses", "final"}`` (the losses of
    the steps this run took, the path of ``encoder_final.npz``)."""
    args = parse_args(argv)
    logger.info(args)

    from svecalign_tpu_torch.models.laser_encoder import LaserEncoderConfig
    from svecalign_tpu_torch.models.param_utils import (
        load_params_npz,
        params_from_jax,
        save_params_npz,
    )
    from svecalign_tpu_torch.models.training import (
        TrainConfig,
        make_optimizer,
        make_train_state,
        shard_train_step,
    )
    from svecalign_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model_parallel=args.model_parallel, device=args.device)
    logger.info(f"mesh: {mesh.shape}")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows = load_rows(args.tsv, args.min_score)
    logger.info(f"{len(rows)} mined pairs available for training")
    n_samples = int(args.max_seconds * SAMPLE_RATE)
    batcher = ClipBatcher(rows, args.batch_size, n_samples, args.seed)

    config = LaserEncoderConfig(encoder_layers=args.encoder_layers, encoder_dim=args.encoder_dim)
    tcfg = TrainConfig(learning_rate=args.lr, temperature=args.temperature)
    model, opt = make_train_state(config, tcfg, seed=args.seed, device=mesh.first)
    if args.init_ckpt:
        model.load_state_dict(params_from_jax(load_params_npz(args.init_ckpt), model,
                                              source=args.init_ckpt))
        opt = make_optimizer(model, tcfg)
        logger.info(f"initialized from {args.init_ckpt}")

    ckpt_dir = out_dir / "ckpt"
    start_step = latest_checkpoint(ckpt_dir) or 0
    if start_step:
        # the parameters only: the optimizer state stays fresh, as in JAX
        path = ckpt_dir / str(start_step) / CKPT_FILE
        model.load_state_dict(torch.load(path, map_location=mesh.first, weights_only=True))
        logger.info(f"resumed from checkpoint step {start_step}")
    step_fn = shard_train_step(model, opt, tcfg, mesh)

    losses = []
    for step in range(start_step, args.steps):
        loss = step_fn(batcher.next_batch())
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            logger.info(f"step {step}: loss {float(loss):.4f}")
        if (step + 1) % args.save_every == 0:
            path = ckpt_dir / str(step + 1) / CKPT_FILE
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)

    final = out_dir / "encoder_final.npz"
    save_params_npz(model, str(final))
    logger.info(f"saved final weights to {final}")
    return {"start_step": start_step, "losses": [float(x) for x in losses], "final": str(final)}


if __name__ == "__main__":
    main()
