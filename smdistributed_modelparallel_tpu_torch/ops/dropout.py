"""Dropout and bulk threefry bits: the CUDA kernels' wrappers, their plain
versions, and the ``jax.random`` draws built on the bits.

The JAX package has no Pallas kernel here: flax's ``nn.Dropout`` and the
plain attention path's dropout draw ``jax.random.bernoulli`` over the
activation, which XLA fuses with threefry into the select. PyTorch has no
such fusion, and one threefry2x32 in torch operations is over a hundred
elementwise launches (``utils/random.threefry2x32``: 20 rounds of seven), so
``csrc/dropout.cu`` holds the one kernel family the dropout sites and the
sampler run on the card:

- ``threefry_bits(key, n, offset, run, stride)``: the uint32 bits of n
  elements of ``jax.random.bits(key, shape)`` (partitionable layout: element
  i is threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)), its two words XORed),
  as int32 bit patterns: local element i is whole element ``offset + (i //
  run) * stride + i % run`` (``run`` None: ``offset + i``). The index map
  lets a shard draw its part of a global array: a flat range, or a tp rank's
  heads of [B, H, T, S] (B runs of (H/tp)·T·S at stride H·T·S) or its T
  block of [B, T, D] (B runs of (T/tp)·D at stride T·D);
- ``dropout_fwd(x, rate, key, index)``: flax's ``Dropout`` in one pass, over
  the elements ``index`` = (offset, run, stride) maps x onto:
  ``keep = uniform(bits) < fp32(1 - rate)`` and ``y = keep ? x / kp : 0``,
  ``kp`` = ``1 - rate`` rounded to x's dtype (JAX divides by the Python
  float as a weakly typed scalar, which rounds to x's dtype first: for bf16
  x that is a division by 0.8984375, not 0.9), the quotient rounded once to
  x's dtype; it also writes the 1-byte mask;
- ``dropout_bwd(dy, mask, rate)``: ``dx = keep ? dy / kp : 0``, the JAX VJP
  of that select and division, reading the forward's mask.

Each wrapper runs its plain PyTorch version for tensors on the CPU and the
kernel for CUDA tensors, and never falls back from one to the other;
``.launches`` counts the kernel launches, ``.shard_launches`` those of them
whose index map has more than one run. ``dropout`` wires the pair into a
``torch.autograd.Function``. ``bits``, ``uniform``, ``bernoulli``,
``gumbel`` and ``categorical`` are ``jax.random``'s functions of the same
names over ``threefry_bits`` (the keys themselves are ``utils/random``'s,
derived on the host).
"""

import ctypes
import functools

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch.utils.random import MASK32, as_key, threefry2x32

# Mantissa bits of an fp32 and the bits of fp32 1.0: uniform's bit trick.
_NMANT = 23
_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _scale(rate, dtype):
    """``(threshold, kp)``: fp32(1 - rate), the uniform draw's bound, and
    1 - rate rounded to ``dtype``, the divisor (both as Python floats)."""
    keep_prob = 1.0 - rate
    return _threshold(keep_prob), float(torch.tensor(keep_prob, dtype=dtype))


def _flat(n, index):
    """``(offset, run, stride)`` of an index map, a flat range of n elements
    as one run of n."""
    offset, run, stride = (0, None, None) if index is None else index
    if run is None or run >= n:
        return int(offset), max(int(n), 1), max(int(n), 1)
    if run <= 0 or stride < run or n % run:
        raise ValueError(f"index map: run {run} and stride {stride} must satisfy 0 < run <= stride, run dividing "
                         f"the {n} elements")
    return int(offset), int(run), int(stride)


def _global_index(n, index, device):
    """The whole tensor's flat index of each of n local elements (int64)."""
    offset, run, stride = _flat(n, index)
    i = torch.arange(n, dtype=torch.int64, device=device)
    if run == n:
        return i + offset
    return offset + torch.div(i, run, rounding_mode="floor") * stride + i % run


def reference_threefry_bits(key, n, offset=0, device="cpu", run=None, stride=None):
    """Plain PyTorch version of ``smp_threefry_bits``: int64 arithmetic masked
    to 32 bits, the result as int32 bit patterns."""
    i = _global_index(n, (offset, run, stride), device)
    y0, y1 = threefry2x32(as_key(key), i >> 32, i & MASK32)
    b = y0 ^ y1
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)


def reference_dropout_fwd(x, rate, key, index=None):
    """Plain PyTorch version of ``smp_dropout_fwd``: ``(y, keep)``, keep a
    bool tensor of x's shape."""
    thresh, kp = _scale(rate, x.dtype)
    offset, run, stride = _flat(x.numel(), index)
    bits = reference_threefry_bits(key, x.numel(), offset, x.device, run, stride)
    keep = _uniform_from_bits(bits).reshape(x.shape) < thresh
    return torch.where(keep, x / _divisor(kp, x), 0.0), keep


def reference_dropout_bwd(dy, keep, rate):
    """Plain PyTorch version of ``smp_dropout_bwd``: ``keep ? dy / kp : 0``."""
    _, kp = _scale(rate, dy.dtype)
    return torch.where(keep.reshape(dy.shape).bool(), dy / _divisor(kp, dy), 0.0)


def _divisor(kp, x):
    """``kp`` as a 0-dim tensor of x's dtype on x's device: a true division
    (torch multiplies by the reciprocal of a Python scalar divisor on a CUDA
    tensor), filled on the device so CUDA-graph capture can hold it."""
    return torch.full((), kp, dtype=x.dtype, device=x.device)


def _is_cuda(t):
    """Whether the kernels would run on this tensor's device (one seam)."""
    return t.is_cuda


def _launch(fn, *args, device):
    """Call ``csrc/dropout.cu``'s ``fn`` on ``device``'s current stream;
    raise if the launch was refused."""
    lib = _kernel()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.smp_cuda_error_string(err).decode()}")


def threefry_bits(key, n, offset=0, device="cpu", run=None, stride=None):
    """The uint32 bits of n elements of ``jax.random.bits(key, shape)``,
    local element i being element ``offset + (i // run) * stride + i % run``
    (``run`` None: ``offset + i``), as an int32 tensor [n] of the same bit
    patterns on ``device``: the plain version on the CPU,
    ``csrc/dropout.cu`` on a CUDA device."""
    device = torch.device(device)
    key = as_key(key)
    if device.type == "cpu":
        return reference_threefry_bits(key, n, offset, device, run, stride)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if not _is_cuda(out):
        raise ValueError(f"threefry_bits: device {device} is neither the CPU nor a CUDA device")
    if n:
        offset, run, stride = _flat(n, (offset, run, stride))
        _launch("smp_threefry_bits", out.data_ptr(), int(key[0]), int(key[1]), offset, n, run, stride,
                device=device)
        threefry_bits.launches += 1
        threefry_bits.shard_launches += run < n
    return out


def _check(name, x):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes fp32, fp16 or bf16; got {x.dtype}")


def dropout_fwd(x, rate, key, index=None):
    """``(y, mask)`` of flax's ``Dropout(rate)`` on x with ``key`` (``0 <
    rate < 1``), x holding the elements of the whole tensor that ``index`` =
    ``(offset, run, stride)`` maps it onto (None: all of it): the plain
    version for CPU tensors (mask a bool tensor), ``smp_dropout_fwd`` for
    CUDA tensors (mask uint8)."""
    key = as_key(key)
    if x.device.type == "cpu":
        return reference_dropout_fwd(x, rate, key, index)
    if not _is_cuda(x):
        raise ValueError(f"dropout_fwd: x must lie on the CPU or a CUDA device, got {x.device}")
    _check("dropout_fwd", x)
    x = x.contiguous()
    y = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    thresh, kp = _scale(rate, x.dtype)
    if x.numel():
        offset, run, stride = _flat(x.numel(), index)
        _launch("smp_dropout_fwd", _DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), mask.data_ptr(), int(key[0]),
                int(key[1]), x.numel(), offset, run, stride, thresh, kp, device=x.device)
        dropout_fwd.launches += 1
        dropout_fwd.shard_launches += run < x.numel()
    return y, mask


def dropout_bwd(dy, mask, rate):
    """``dx = keep ? dy / kp : 0`` for the forward's ``mask``: the plain
    version for CPU tensors, ``smp_dropout_bwd`` for CUDA tensors (mask the
    forward's uint8 mask)."""
    if dy.device.type == "cpu":
        return reference_dropout_bwd(dy, mask, rate)
    if not _is_cuda(dy):
        raise ValueError(f"dropout_bwd: dy must lie on the CPU or a CUDA device, got {dy.device}")
    _check("dropout_bwd", dy)
    if mask.dtype != torch.uint8 or mask.shape != dy.shape or mask.device != dy.device:
        raise ValueError("dropout_bwd: mask must be the forward's uint8 mask, shaped like dy on its device")
    dy, mask = dy.contiguous(), mask.contiguous()
    dx = torch.empty_like(dy)
    _, kp = _scale(rate, dy.dtype)
    if dy.numel():
        _launch("smp_dropout_bwd", _DTYPE_CODE[dy.dtype], dy.data_ptr(), dx.data_ptr(), mask.data_ptr(), dy.numel(),
                kp, device=dy.device)
        dropout_bwd.launches += 1
    return dx


threefry_bits.launches = 0
dropout_fwd.launches = 0
threefry_bits.shard_launches = 0  # of them, the launches over several runs of an index map (a tp shard)
dropout_fwd.shard_launches = 0
dropout_bwd.launches = 0


class _DropoutFn(torch.autograd.Function):
    """``dropout`` with its VJP: the forward saves its mask, the backward is
    one ``dropout_bwd`` that reads it."""

    @staticmethod
    def forward(ctx, x, rate, key, index):
        y, mask = dropout_fwd(x, rate, key, index)
        ctx.rate = rate
        ctx.save_for_backward(mask)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        return dropout_bwd(dy, mask, ctx.rate), None, None, None


def dropout(x, rate, key, index=None):
    """flax's ``nn.Dropout(rate)(x)`` in training mode with the key ``key``:
    x for rate 0, zeros for rate 1 (no draw), else ``select(bernoulli(key,
    1 - rate, x.shape), x / (1 - rate), 0)`` with the division in x's dtype.
    ``index`` = ``(offset, run, stride)``: x is a shard, which takes its
    elements of the whole tensor's mask (``threefry_bits``' map).
    Differentiable in x."""
    if rate == 0.0:
        return x
    if rate == 1.0:  # zeros whose gradient is zero (flax's zeros_like)
        return torch.where(torch.zeros((), dtype=torch.bool, device=x.device), x, 0.0)
    return _DropoutFn.apply(x, float(rate), as_key(key), index)


def bits(key, shape, device="cpu", offset=0):
    """``jax.random.bits(key, shape)`` (uint32) as an int32 tensor of the same
    bits on ``device``; ``offset`` starts the flat element index there."""
    shape = tuple(shape)
    return threefry_bits(key, int(np.prod(shape, dtype=np.int64)), offset=offset, device=device).reshape(shape)


def _uniform_from_bits(b):
    """fp32 in [0, 1) from int32 bit patterns: ``jax.random.uniform``'s
    23 mantissa bits under exponent 1, minus 1.0."""
    top = torch.bitwise_right_shift(b, 32 - _NMANT) & ((1 << _NMANT) - 1)  # a logical shift of the uint32
    return (top | _ONE_BITS).view(torch.float32) - 1.0


def uniform(key, shape, device="cpu", minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    f = _uniform_from_bits(bits(key, shape, device))
    lo, hi = np.float32(minval), np.float32(maxval)
    if lo == 0.0 and hi == 1.0:
        return f
    return torch.clamp_min(f * float(np.float32(hi - lo)) + float(lo), float(lo))


def _threshold(p):
    """``p`` rounded to fp32, as ``jax.random.bernoulli`` takes a Python
    float."""
    return float(np.float32(p))


def bernoulli(key, p, shape, device="cpu"):
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: a bool
    tensor, ``uniform < fp32(p)``."""
    return uniform(key, shape, device) < _threshold(p)


def gumbel(key, shape, device="cpu"):
    """``jax.random.gumbel(key, shape)`` in fp32, "low" mode (the default,
    ``jax_high_dynamic_range_gumbel`` off): ``-log(-log(u))`` with u uniform
    in [tiny, 1)."""
    u = uniform(key, shape, device, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits, axis=-1):
    """``jax.random.categorical(key, logits, axis)``: the argmax over
    ``axis`` of ``logits`` plus a Gumbel draw of their shape (the first
    index among equal maxima)."""
    g = gumbel(key, logits.shape, logits.device).to(logits.dtype)
    return torch.argmax(g + logits, dim=axis)


_LIB = None  # csrc/dropout.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("dropout")
        c_int, c_ptr, c_u32, c_i64, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_longlong, \
            ctypes.c_float
        lib.smp_threefry_bits.argtypes = [c_ptr, c_u32, c_u32, c_i64, c_i64, c_i64, c_i64, c_ptr]
        lib.smp_threefry_bits.restype = c_int
        lib.smp_dropout_fwd.argtypes = [c_int, c_ptr, c_ptr, c_ptr, c_u32, c_u32, c_i64, c_i64, c_i64, c_i64, c_f,
                                        c_f, c_ptr]
        lib.smp_dropout_bwd.argtypes = [c_int, c_ptr, c_ptr, c_ptr, c_i64, c_f, c_ptr]
        for fn in (lib.smp_dropout_fwd, lib.smp_dropout_bwd):
            fn.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
