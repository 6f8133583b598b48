"""Model operations of the two speech encoders, two per multiply-add, for
one window at its own length: no padded sample, frame, row or key is
counted, so a program that pads less does not read lower.

LASER: the conv extractor over the window's samples, the projection and
the positional conv over its frames, the trunk's dense layers, and
attention's two products over valid query-key pairs. SONAR: the
fbank's mel projection, the feature projection, per conformer layer the
two FFNs, the q/k/v/out projections, the rel-key scores (q against the
distance table), attention's two products over valid pairs, the
pointwise and depthwise convs, and the pooler. Neither counts
normalisations, activations or the FFT: they are not products.
"""


def laser_window_flops(cfg: dict, n_samples: int) -> float:
    n, c_in, total = n_samples, 1, 0.0
    for dim, k, stride in cfg["conv_layers"]:
        n = (n - k) // stride + 1
        if n <= 0:
            return 0.0
        total += 2.0 * n * dim * c_in * k
        c_in = dim
    d, f = cfg["encoder_dim"], cfg["encoder_ffn_dim"]
    total += 2.0 * n * c_in * d  # projection
    total += 2.0 * n * d * (d // cfg["conv_pos_groups"]) * cfg["conv_pos_kernel"]
    per_layer = 2.0 * n * (4 * d * d + 2 * d * f) + 4.0 * n * n * d
    return total + cfg["encoder_layers"] * per_layer


def sonar_window_flops(cfg: dict, n_samples: int) -> float:
    n10 = 0 if n_samples < 400 else 1 + (n_samples - 400) // 160
    n10 = min(n10, cfg["bucket_frames"][-1])
    t = n10 // 2
    if t <= 0:
        return 0.0
    d, f, h = cfg["model_dim"], cfg["ffn_dim"], cfg["n_heads"]
    n_pos = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    total = 2.0 * n10 * 256 * cfg["n_mels"]  # mel projection of the power spectrum
    total += 2.0 * t * 2 * cfg["n_mels"] * d  # feature projection
    layer = 2 * 2.0 * t * 2 * d * f  # two FFNs
    layer += 2.0 * t * 4 * d * d  # q, k, v, out
    layer += 2.0 * t * d * n_pos  # q against the distance table, every head
    layer += 4.0 * t * t * d  # scores and the weighted sum over valid pairs
    layer += 2.0 * t * d * 2 * d + 2.0 * t * d * cfg["conv_kernel"] + 2.0 * t * d * d  # conv
    total += cfg["n_layers"] * layer
    total += 2 * 2.0 * t * d * d + 4.0 * t * d + 2.0 * d * d + 2.0 * d * cfg["pool_dim"]  # pooler
    return total


WINDOW_FLOPS = {"speech_laser": laser_window_flops, "sonar": sonar_window_flops}
