"""Whisper's model operations and a decode step's least bytes.

The encoder is counted per clip at all ``n_audio_ctx`` positions (1500):
every clip is padded to 30 s, and that padding is the model's input, not
the program's choice. A decode step reads the decoder's weights once and
the cross- and self-attention K/V of the rows still decoding ("live"),
and writes those rows' new K/V and fp32 logits: a program that also
computes rows that are done reads more than this count.
"""

from bench_port.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S

BF16 = 2
FP32 = 4


def encoder_flops(cfg: dict) -> float:
    """Multiply-adds times two of one clip's encoder forward: the two convs
    (2 n_ctx mel frames in, n_ctx positions out), then per layer the four
    projections and the MLP (24 T d^2) and the attention's two products
    (4 T^2 d)."""
    t, d, m = cfg["n_audio_ctx"], cfg["n_audio_state"], cfg["n_mels"]
    convs = 2 * (2 * t) * m * 3 * d + 2 * t * d * 3 * d
    return float(convs + cfg["n_audio_layer"] * (24 * t * d * d + 4 * t * t * d))


def cross_kv_flops(cfg: dict) -> float:
    """The cross-attention keys and values of one clip, every layer."""
    return float(cfg["n_text_layer"] * 2 * 2 * cfg["n_audio_ctx"] * cfg["n_text_state"] ** 2)


def decoder_step_weight_bytes(cfg: dict) -> float:
    """The weights one step reads: per layer the self-attention's four
    projections, the cross-attention's query and output projections (its
    keys and values are cached), the MLP, in bf16 with their biases, three
    fp32 LayerNorms; the final LayerNorm; the token table for the logits."""
    d, n = cfg["n_text_state"], cfg["n_text_layer"]
    layer = BF16 * (14 * d * d + 11 * d) + FP32 * 6 * d
    return float(n * layer + FP32 * 2 * d + BF16 * cfg["n_vocab"] * d)


def decode_step_bytes(cfg: dict, live: int, length: int) -> float:
    """Least bytes of a step with ``live`` rows decoding, each attending
    ``length`` self-attention positions (its own included)."""
    d, n = cfg["n_text_state"], cfg["n_text_layer"]
    per_row = (n * 2 * BF16 * d * (cfg["n_audio_ctx"] + length + 1)
               + FP32 * cfg["n_vocab"])
    return decoder_step_weight_bytes(cfg) + live * per_row


def decode_step_flops(cfg: dict, live: int, length: int) -> float:
    d, n = cfg["n_text_state"], cfg["n_text_layer"]
    per_row = (n * (2 * 14 * d * d + 4 * d * (length + cfg["n_audio_ctx"]))
               + 2 * cfg["n_vocab"] * d)
    return float(live * per_row)


def decode_step_bound_s(cfg: dict, live: int, length: int) -> float:
    """The step's least time on one H100: its bytes at HBM bandwidth or its
    operations at the bf16 peak, whichever is longer."""
    return max(decode_step_bytes(cfg, live, length) / HBM_BYTES_PER_S,
               decode_step_flops(cfg, live, length) / BF16_FLOPS)


def batch_steps(budgets, prompt: int = 4):
    """``(live, length)`` of each step after the prefill of a batch whose
    rows sample ``budgets`` tokens each (no row ends early): step j feeds
    the token sampled at j - 1 at position prompt + j - 1 and samples the
    j-th."""
    return [(sum(b > j for b in budgets), prompt + j) for j in range(1, max(budgets))]
