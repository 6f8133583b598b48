"""Parakeet-TDT's model operations and a decode iteration's least time.

The encoder is counted per clip at its valid frames only: the padding of
a batch to its bucket is the program's choice, and counted as waste. A
decode iteration reads the prediction network's and the joint's weights
once, as the program serves them (the LSTM's and ``joint.pred``'s in
bf16, ``joint.out``'s fp32 copy), and each live row's projected frame
(fp32); its operations are the live rows' products. At every batch size
the cell runs the bytes bound it: 64 rows' products are ~0.7 GFLOP, under
a microsecond at the bf16 peak, against ~10 us for the weights.
"""

import math

from bench_port.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S

BF16 = 2
FP32 = 4


def valid_frames(cfg: dict, n_samples: int):
    """(mel frames, encoder frames) of a clip of ``n_samples`` at 16 kHz:
    ``n // 160``, then ``(L - 1) // 2 + 1`` per stride-2 conv."""
    mel = n_samples // 160
    t = mel
    for _ in range(int(math.log2(cfg["subsampling_factor"]))):
        t = (t - 1) // 2 + 1
    return mel, t


def encoder_flops(cfg: dict, n_samples: int) -> float:
    """Multiply-adds times two of one clip's encoder and the joint's frame
    projection at its valid frames: the stem's convs (a 3x3 conv from one
    channel, then per factor a depthwise 3x3 and a pointwise conv, on a
    plane of frames x mels halved at each stride) and its Linear, then per
    block the two feed-forwards (8 d ff a frame), q, k, v and out (8 d^2),
    ``linear_pos`` over 2T - 1 positions, the content and position scores
    and the weighted values (2 T^2 d + 2 T (2T - 1) d + 2 T^2 d), and the
    conv module (pointwise 4 d^2 and 2 d^2, depthwise 2 k d)."""
    mel, t = valid_frames(cfg, n_samples)
    c, f, d = cfg["subsampling_channels"], cfg["n_mels"], cfg["d_model"]
    stem, length, width = 0, mel, f
    for i in range(int(math.log2(cfg["subsampling_factor"]))):
        length, width = (length - 1) // 2 + 1, width // 2
        if i == 0:
            stem += 2 * 9 * c * length * width
        else:
            stem += 2 * 9 * c * length * width + 2 * c * c * length * width
    stem += 2 * c * width * d * t
    ff, k = cfg["ff_dim"], cfg["conv_kernel"]
    block = (t * (8 * d * ff + 8 * d * d + 6 * d * d + 2 * k * d)
             + 2 * (2 * t - 1) * d * d + 2 * t * t * d + 2 * t * (2 * t - 1) * d + 2 * t * t * d)
    return float(stem + cfg["n_layers"] * block + 2 * t * d * cfg["joint_hidden"])


def n_outputs(cfg: dict) -> int:
    return cfg["vocab_size"] + 1 + len(cfg["durations"])


def iteration_weight_bytes(cfg: dict) -> float:
    """Bytes an iteration reads once whatever its rows: every LSTM layer's
    [W_ih | W_hh] (bf16) and its fp32 summed bias, ``joint.pred`` (bf16
    with its bias) and ``joint.out`` with its bias (fp32)."""
    h, j = cfg["pred_hidden"], cfg["joint_hidden"]
    lstm = cfg["pred_layers"] * (BF16 * 4 * h * 2 * h + FP32 * 4 * h)
    return float(lstm + BF16 * (j * h + j) + FP32 * (n_outputs(cfg) * j + n_outputs(cfg)))


def iteration_row_flops(cfg: dict) -> float:
    """One live row's products in an iteration: ``joint.out``, the LSTM
    layers, ``joint.pred``."""
    h, j = cfg["pred_hidden"], cfg["joint_hidden"]
    return float(2 * n_outputs(cfg) * j + cfg["pred_layers"] * 2 * 4 * h * 2 * h + 2 * j * h)


def loop_bound_s(cfg: dict, iterations: int, row_iterations: int) -> float:
    """The least time of ``iterations`` decode iterations over
    ``row_iterations`` live rows in all: the weights once an iteration and
    each live row's projected frame at HBM bandwidth, or the live rows'
    products at the bf16 peak, whichever is longer."""
    by_bytes = (iterations * iteration_weight_bytes(cfg)
                + row_iterations * FP32 * cfg["joint_hidden"]) / HBM_BYTES_PER_S
    by_flops = row_iterations * iteration_row_flops(cfg) / BF16_FLOPS
    return max(by_bytes, by_flops)
