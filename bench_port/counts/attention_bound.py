"""The least time of one launch of the rel-key attention kernel: what the
function reads and writes once (q, k, v and the output at the launch's
padded shape, the (C, 64) distance table, the (B,) int32 lengths),
against 4 x 64 operations per (valid query, valid key, head) pair at the
bf16 tensor-core peak; the larger of the two."""

from bench_port.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def attention_bound_s(B: int, T: int, H: int, lengths, C: int = 73, elem_bytes: int = 2,
                      head_size: int = 64):
    """Returns (seconds, "bytes" or "operations")."""
    ops = 4.0 * H * head_size * float(sum(int(n) * int(n) for n in lengths))
    nbytes = (4 * B * T * H * head_size + C * head_size) * elem_bytes + 4 * B
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / BF16_FLOPS
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def sonar_launches(cfg: dict, rows_per_chunk: int, window_lengths):
    """(B, T, lengths) of each rel-key launch of a stage-5.3 document, one
    per layer and chunk: the windows grouped by frame bucket in the
    concat file's order, ``rows_per_chunk`` a chunk, padding rows of
    length 0; T is the bucket's stacked frames."""
    buckets = cfg["bucket_frames"]
    by_bucket = {}
    for n in window_lengths:
        nf = 0 if n < 400 else 1 + (n - 400) // 160
        b = next((x for x in buckets if nf <= x), buckets[-1])
        by_bucket.setdefault(b, []).append(min(nf, b) // 2)
    out = []
    for b in sorted(by_bucket):
        lens = by_bucket[b]
        for c0 in range(0, len(lens), rows_per_chunk):
            part = lens[c0:c0 + rows_per_chunk]
            part = part + [0] * (rows_per_chunk - len(part))
            out += [(rows_per_chunk, b // 2, part)] * cfg["n_layers"]
    return out
