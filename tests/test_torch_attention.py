"""The port's plain rel-key attention (svecalign_tpu_torch.ops.attention,
the CPU side of the CUDA kernel's wrapper) against the JAX package's
Pallas kernel in interpret mode and its XLA reference, on the same seeded
inputs, compared on valid query rows.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (the Pallas tests' own); bf16 one
bf16 step of the output (atol 2^-7 + rtol 2^-7), since the kernel rounds
its probabilities to bf16 before normalising and the plain version after.
Every output row, valid or not, must be finite (a length-0 row included).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svecalign_tpu.ops.attention_pallas import (
    relkey_attention_reference,
    relkey_flash_attention,
)
from svecalign_tpu_torch.ops import attention, attention_cuda

torch.set_num_threads(1)

FP32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-7)


def _inputs(seed, b, h, t, left=64, right=8):
    rng = np.random.default_rng(seed)
    dh = 64
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    table = (rng.standard_normal((left + right + 1, dh)) * 0.02).astype(np.float32)
    return q, k, v, table


def _valid(b, t, lens):
    valid = np.zeros((b, t, 1, 1), bool)
    for i, n in enumerate(lens):
        valid[i, :n] = True
    return valid


def _port(q, k, v, table, lens, left=64, right=8, dtype=torch.float32):
    args = [torch.from_numpy(a).to(dtype) for a in (q, k, v, table)]
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    # the kernel's wrapper on CPU tensors: its plain version
    out = attention_cuda.relkey_attention_cuda(*args, lengths, left=left, right=right)
    assert out.dtype == dtype and torch.isfinite(out).all()
    return out.float().numpy()


@pytest.mark.parametrize(
    "b,h,t,lens",
    [
        (2, 4, 200, (200, 150)),      # padded T (< one tile), ragged keys
        (1, 2, 128, (128,)),          # exactly one tile
        (1, 2, 300, (300,)),          # crosses tile boundaries
        (2, 2, 384, (384, 40)),       # length shorter than one tile
    ],
)
def test_plain_matches_pallas_kernel_fp32(b, h, t, lens):
    q, k, v, table = _inputs(b * 1000 + t, b, h, t)
    lengths = jnp.asarray(lens, jnp.int32)
    jq, jk, jv, jt = (jnp.asarray(a) for a in (q, k, v, table))
    kern = np.asarray(relkey_flash_attention(jq, jk, jv, jt, lengths, interpret=True))
    ref = np.asarray(relkey_attention_reference(jq, jk, jv, jt, lengths))
    got = _port(q, k, v, table, lens)
    valid = _valid(b, t, lens)
    for want in (kern, ref):
        np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), **FP32_TOL)


def test_plain_no_lengths_and_asymmetric_clip():
    left, right = 16, 4
    q, k, v, table = _inputs(9, 1, 2, 260, left, right)
    jargs = [jnp.asarray(a) for a in (q, k, v, table)]
    kern = np.asarray(relkey_flash_attention(*jargs, None, left, right, interpret=True))
    got = _port(q, k, v, table, None, left, right)
    np.testing.assert_allclose(got, kern, **FP32_TOL)


def test_plain_matches_pallas_kernel_bf16():
    """bf16 inputs through the XLA reference (bf16 in, probabilities in
    bf16) and the port; a length-0 batch row stays finite."""
    b, h, t, lens = 3, 2, 200, (200, 77, 0)
    q, k, v, table = _inputs(11, b, h, t)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, table)]
    lengths = jnp.asarray(lens, jnp.int32)
    ref = np.asarray(relkey_attention_reference(*jargs, lengths).astype(jnp.float32))
    got = _port(q, k, v, table, lens, dtype=torch.bfloat16)
    valid = _valid(b, t, lens)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, ref, 0), **BF16_TOL)


def test_length_zero_row_is_finite_and_valid_rows_unchanged():
    """A padding-only batch row (length 0) gives finite values everywhere,
    and does not change the other rows."""
    q, k, v, table = _inputs(3, 2, 2, 130)
    both = _port(q, k, v, table, (130, 0))
    one = _port(q[:1], k[:1], v[:1], table, (130,))
    np.testing.assert_array_equal(both[:1], one)


def test_projection_is_rounded_to_q_dtype():
    """p = (q . table^T) / sqrt(dh) in fp32, rounded to q's dtype, as the
    TPU kernel's caller computes it."""
    q, _, _, table = _inputs(5, 1, 2, 40)
    jp = jnp.einsum("blhd,cd->blhc", jnp.asarray(q, jnp.bfloat16),
                    jnp.asarray(table, jnp.bfloat16),
                    preferred_element_type=jnp.float32) * (1 / 8)
    jp = np.asarray(jp.astype(jnp.bfloat16).astype(jnp.float32))
    tp = attention.relkey_projection(torch.from_numpy(q).bfloat16(), torch.from_numpy(table))
    assert tp.dtype == torch.bfloat16
    np.testing.assert_allclose(tp.float().numpy(), jp, rtol=2.0**-8, atol=0)


def test_wrapper_raises_on_unsupported_device():
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_cuda.relkey_attention_cuda(q, q, q, torch.zeros(73, 64, device="meta"))


@pytest.mark.parametrize(
    "q_shape,dtype,table_rows,left,right,match",
    [
        ((1, 4, 2, 32), torch.float32, 73, 64, 8, "q must be"),          # head size 32
        ((1, 4, 64), torch.float32, 73, 64, 8, "q must be"),             # not 4-D
        ((1, 4, 2, 64), torch.float16, 73, 64, 8, "q must be one of"),   # fp16
        ((1, 4, 2, 64), torch.bfloat16, 129, 120, 8, "at most 128"),     # C = 129
        ((1, 4, 2, 64), torch.float32, 72, 64, 8, "table must be"),      # C = 73, 72 rows
        ((1, 4, 2, 64), torch.float32, 21, -1, 21, "non-negative"),      # negative clip
    ],
)
def test_wrapper_rejects_what_the_kernels_do_not_take(q_shape, dtype, table_rows, left, right,
                                                      match):
    """The wrapper checks its inputs before it picks a route, so CPU
    tensors get the errors a card caller would."""
    q = torch.zeros(q_shape, dtype=dtype)
    table = torch.zeros(table_rows, q_shape[-1], dtype=dtype)
    with pytest.raises(ValueError, match=match):
        attention_cuda.relkey_attention_cuda(q, q, q, table, left=left, right=right)


def test_attention_bound_counts_inputs_and_output_only():
    """chip_smoke's bound: q, k, v and the output (B T H 64 bf16 each), the
    (C, 64) table and the int32 lengths move once; 4 x 64 operations per
    valid (query, key, head) pair; the larger time bounds."""
    from chip_smoke import H100_BF16_OPS_PER_S, H100_BYTES_PER_S, _attention_bound_ms

    B, T, H = 16, 250, 16
    lens = [250] * 8 + [100] * 8
    ms, by = _attention_bound_ms(B, T, H, lens)
    nbytes = 4 * B * T * H * 64 * 2 + 73 * 64 * 2 + 4 * B
    ops = 4 * H * 64 * (8 * 250**2 + 8 * 100**2)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / H100_BYTES_PER_S * 1e3, rel=1e-12)
    assert ms > ops / H100_BF16_OPS_PER_S * 1e3

    ms, by = _attention_bound_ms(B, 700, H, [700] * B)  # the 1400-frame bucket, full
    assert by == "operations"
    assert ms == pytest.approx(4 * H * 64 * B * 700**2 / H100_BF16_OPS_PER_S * 1e3, rel=1e-12)
