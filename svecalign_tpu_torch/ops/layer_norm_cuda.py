"""Wrapper of the LayerNorm kernel (``csrc/layer_norm.cu``).

The kernel computes :func:`svecalign_tpu_torch.ops.layer_norm.flax_layer_norm`
with the statistics over the channel axis, in one pass over ``x``: fp32
or bf16 in, fp32 or bf16 out, the conv bias before the statistics and
the GELU after the cast fused in. It takes the two layouts the encoders
call it with, read in place, and on a card writes a contiguous tensor of
``x``'s shape:

- rows: the normalised axis is the last and ``x`` is contiguous, or 3-D
  with contiguous (T, C) rows at any batch stride (a slice of a longer T);
- channels-first: ``x`` is 3-D and its memory is (B, C, T) with T
  contiguous, either ``x`` itself normalised over axis 1 (the extractor's
  norms; the output stays (B, C, T) for the next conv) or its (B, T, C)
  transposed view normalised over axis 2 (``post_extract_norm``, SONAR's
  ``depthwise_layer_norm``; the output is (B, T, C) for the next dense).

Widths are multiples of 8 up to :data:`MAX_WIDTH`. The inputs are checked
before the device is, so a CPU caller gets the errors a card caller
would; then a CUDA tensor launches the kernel, and any other device
raises (the plain version is the caller's to run:
``models/w2v_bert.py::FlaxLayerNorm``). A call that records a graph for
autograd (the trainer's forward) launches the kernel too, through
:class:`_KernelNorm`, whose backward differentiates the plain version
recomputed from the saved inputs. ``LAUNCHES["layer_norm"]`` and the
tracer's counter ``norm.launches`` count launches; a launch captured into
a CUDA graph (the encoders' per-shape programs) is counted at each
replay, not at its capture (``ops/_build.py::count_launch``).

The launch is safe to capture: it goes on the current stream, allocates
nothing (the output is the wrapper's ``torch.empty``) and sets no
attribute (a channels-first block stays under the 48 KB of shared memory
that needs no opt-in).
"""

import ctypes
from typing import Optional

import torch

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.ops import layer_norm

KERNEL = "layer_norm"
COUNTER = "norm.launches"
UNIT = 8  # widths are multiples of it
MAX_WIDTH = 1024  # the encoders' widest (the source's MAX_WIDTH)
TILE_BYTES = 16 * 1024  # the channels-first tile's budget (the source's TILE_BYTES)
THREADS = 256
DTYPES = (torch.float32, torch.bfloat16)
ACT_NONE, ACT_GELU_TANH, ACT_GELU_ERF = 0, 1, 2

LAUNCHES = {KERNEL: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if not getattr(lib, "_typed", False):
        lib.layer_norm_launch.argtypes = [
            _P, _P, _P, _P, _P,  # x, weight, bias, conv bias (or null), out
            _I, _I, _I, _I,  # in_bf16, out_bf16, channels_first, out_rows
            _L, _I, _L, _L,  # outer (row groups or B), C, inner (rows a group or T), group stride
            ctypes.c_float, _I,  # eps, act
            _P,  # stream
        ]
        lib.layer_norm_launch.restype = _I
        lib.layer_norm_cfirst_plan.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
        lib.layer_norm_cfirst_plan.restype = _I
        lib._typed = True
    return lib


def cfirst_plan(C: int, in_size: int):
    """(frames a tile, dynamic shared-memory bytes a block) of the
    channels-first kernel at width ``C`` and input element size
    ``in_size``: the Python copy of the source's ``cfirst_frames`` and
    ``cfirst_smem_bytes``."""
    frames = 64
    while frames > 8 and C * frames * in_size > TILE_BYTES:
        frames //= 2
    pitch = frames + 4 // in_size  # a tile row, padded by 4 bytes
    lanes = min(frames, 32)
    tile = -(-C * pitch * in_size // 16) * 16
    return frames, tile + 4 * (2 * (THREADS // lanes) * frames + 2 * frames)


def source_cfirst_plan(C: int, in_size: int):
    """The source's own channels-first plan (the card's library)."""
    frames, smem = _I(), _I()
    err = _lib().layer_norm_cfirst_plan(C, in_size, ctypes.byref(frames), ctypes.byref(smem))
    if err != 0:
        raise ValueError(f"layer_norm_cfirst_plan({C}, {in_size}): CUDA error {err}")
    return frames.value, smem.value


def layout(x: torch.Tensor, axis: int) -> str:
    """``"rows"`` or ``"channels_first"`` (module docstring) for statistics
    over ``axis`` of ``x``; ValueError for any other layout."""
    axis %= x.dim()
    if axis == x.dim() - 1 and x.is_contiguous():
        return "rows"
    if x.dim() == 3 and axis == 2 and x.stride(2) == 1 and x.stride(1) == x.shape[2]:
        return "rows"
    if x.dim() == 3 and axis == 1 and x.is_contiguous():
        return "channels_first"
    if x.dim() == 3 and axis == 2 and x.transpose(1, 2).is_contiguous():
        return "channels_first"
    raise ValueError(f"layer_norm_cuda: statistics over axis {axis} of a {tuple(x.shape)} "
                     f"tensor with strides {x.stride()} is neither layout the kernel reads")


def _check_inputs(x, weight, bias, axis, out_dtype, conv_bias) -> str:
    """Raise ValueError on what the kernel does not take; returns the
    layout."""
    C = x.shape[axis]
    if C % UNIT or not UNIT <= C <= MAX_WIDTH:
        raise ValueError(f"layer_norm_cuda: width {C} is not a multiple of {UNIT} "
                         f"in [{UNIT}, {MAX_WIDTH}]")
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise ValueError(f"layer_norm_cuda: dtypes must be among {DTYPES}, got {x.dtype} in, "
                         f"{out_dtype} out")
    for name, t in (("weight", weight), ("bias", bias), ("conv_bias", conv_bias)):
        if t is not None and tuple(t.shape) != (C,):
            raise ValueError(f"layer_norm_cuda: {name} must be ({C},), got {tuple(t.shape)}")
    return layout(x, axis)


def _operand(name, t, dtype, device):
    t = t.to(device=device, dtype=dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"layer_norm_cuda: {name} must be 16-byte aligned")
    return t


def flax_layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                         axis: int = -1, out_dtype: Optional[torch.dtype] = None,
                         conv_bias: Optional[torch.Tensor] = None,
                         gelu_out: bool = False) -> torch.Tensor:
    """:func:`~svecalign_tpu_torch.ops.layer_norm.flax_layer_norm` with the
    statistics and the channels along ``axis``; returns a contiguous
    tensor of ``x``'s shape in ``out_dtype`` (fp32 by default)."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    axis %= x.dim()
    kind = _check_inputs(x, weight, bias, axis, out_dtype, conv_bias)
    args = (x, weight, bias, conv_bias, eps, axis, out_dtype, gelu_out, kind)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, conv_bias)):
        return _KernelNorm.apply(*args)
    return _launch(*args)


class _KernelNorm(torch.autograd.Function):
    """The kernel's forward under autograd; the backward recomputes the
    plain version from the saved inputs and differentiates it, so the
    gradients are the plain version's at the same inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv_bias, eps, axis, out_dtype, gelu_out, kind):
        ctx.save_for_backward(x, weight, bias, conv_bias)
        ctx.spec = (eps, axis, out_dtype, gelu_out)
        return _launch(x, weight, bias, conv_bias, eps, axis, out_dtype, gelu_out, kind)

    @staticmethod
    def backward(ctx, grad):
        eps, axis, out_dtype, gelu_out = ctx.spec
        needs = ctx.needs_input_grad[:4]
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = layer_norm.flax_layer_norm(leaves[0], leaves[1], leaves[2], eps, axis, axis,
                                           out_dtype, leaves[3], gelu_out)
            grads = iter(torch.autograd.grad(y, wanted, grad))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in leaves),
                None, None, None, None, None)


def _launch(x, weight, bias, conv_bias, eps, axis, out_dtype, gelu_out, kind) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"layer_norm_cuda: unsupported device {dev}")
    w = _operand("weight", weight.detach(), torch.float32, dev)
    b = _operand("bias", bias.detach(), torch.float32, dev)
    pre = None if conv_bias is None else _operand("conv_bias", conv_bias.detach(), x.dtype, dev)
    C = x.shape[axis]
    channels_first = kind == "channels_first"
    if channels_first:
        B = x.shape[0]
        T = x.shape[2] if axis == 1 else x.shape[1]
        outer, inner, stride, out_rows = B, T, 0, axis == 2
    elif x.is_contiguous():
        outer, inner, stride, out_rows = 1, x.numel() // C, 0, False
    else:  # (B, T, C) rows at batch stride x.stride(0)
        outer, inner, stride, out_rows = x.shape[0], x.shape[1], x.stride(0), False
    if not channels_first and (x.data_ptr() % 16 or stride * x.element_size() % 16):
        raise ValueError("layer_norm_cuda: rows must be 16-byte aligned")
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    if x.numel() == 0:
        return out
    act = ACT_NONE
    if gelu_out:
        act = ACT_GELU_TANH if out_dtype.itemsize < 4 else ACT_GELU_ERF
    with torch.cuda.device(dev):
        err = _lib().layer_norm_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None if pre is None else pre.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(channels_first), int(out_rows), outer, C, inner, stride, float(eps), act,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, KERNEL, counter=COUNTER)
    return out
