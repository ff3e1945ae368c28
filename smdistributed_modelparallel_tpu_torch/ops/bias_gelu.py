"""Fused bias + tanh-GELU, forward and backward: the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_gelu.py``:
``bias_gelu`` and its ``custom_vjp``, whose kernels are ``_fwd_kernel``
(``gelu(x + b)``) and ``_bwd_kernel`` (``dpre = g * gelu'(x + b)`` in
fp32), and whose backward ``_bg_bwd`` then forms ``dx = dpre`` in x's dtype
and ``db`` = the fp32 row sum of dpre in b's dtype. Here they are the kernels
of ``csrc/bias_gelu.cu``, wired by a ``torch.autograd.Function``. Each
wrapper (``bias_gelu_fwd``: y; ``bias_gelu_bwd``: dx and db) runs its plain
PyTorch version for tensors on the CPU and a kernel for CUDA tensors; it
never falls back from one to the other.

Two routes, and ``_route`` picks by the operands alone: ``"vec"`` (16-byte
accesses, the bias read in its own dtype; the backward computes all of
``_bg_bwd`` in one pass, db from fp32 partials added in a fixed order) for
rows of a multiple of 16 bytes on 16-byte aligned bases; ``"simt"`` (one
element a thread, an fp32 bias; the backward writes fp32 dpre, then torch
casts it and sums its rows) for the rest. ``.launches`` counts the ``vec``
launches of a wrapper, ``.simt_launches`` the others.

Both versions compute in fp32 from ``u = float(x) + float(b)`` in the TPU
kernel's order of operations; the forward rounds once to x's dtype, the
backward sums the unrounded fp32 dpre for db and rounds dx and db once each.
"""

import ctypes
import math

import torch

_SQRT_2_OVER_PI = float(math.sqrt(2.0 / math.pi))
_COEFF = 0.044715

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# csrc/bias_gelu.cu's "vec" block: VT column groups of 16 bytes by VR row
# slices; BWD_BLOCKS_PER_SM of the backward's blocks are resident on an SM.
# Its grid is one wave of them, so its fp32 partials are ~400 KB whatever the
# shape (132 SMs).
_VT, _VR = 32, 8
_BWD_BLOCKS_PER_SM = 3


def _gelu_tanh(u):
    inner = _SQRT_2_OVER_PI * (u + _COEFF * u * u * u)
    return 0.5 * u * (1.0 + torch.tanh(inner))


def _dgelu_tanh(u):
    inner = _SQRT_2_OVER_PI * (u + _COEFF * u * u * u)
    t = torch.tanh(inner)
    sech2 = 1.0 - t * t
    dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _COEFF * u * u)
    return 0.5 * (1.0 + t) + 0.5 * u * sech2 * dinner


def reference_bias_gelu(x, b):
    """Plain PyTorch version of the forward kernel: ``gelu_tanh(x + b)`` in
    fp32, rounded to x's dtype."""
    return _gelu_tanh(x.float() + b.float()).to(x.dtype)


def reference_bias_gelu_bwd(x, b, g):
    """Plain PyTorch version of the backward kernel: ``g * gelu'(x + b)``,
    fp32."""
    return g.float() * _dgelu_tanh(x.float() + b.float())


def reference_bias_gelu_grads(x, b, g):
    """Plain PyTorch version of the whole backward (``_bg_bwd``): dpre in
    fp32, then ``(dx, db)`` = (dpre in x's dtype, its fp32 row sum in b's
    dtype)."""
    dpre = reference_bias_gelu_bwd(x, b, g)
    return dpre.to(x.dtype), dpre.reshape(-1, x.shape[-1]).sum(0).to(b.dtype)


def _check_cuda(name, x, b, g=None):
    """The kernels' contract: x [..., F] (and g, its shape and dtype) and b
    [F], each in one of fp32, fp16 or bf16, all on one CUDA device."""
    tensors = (x, b) + (() if g is None else (g,))
    if not (_is_cuda(x) and all(a.device == x.device for a in tensors)):
        raise ValueError(f"{name}: inputs must share one CUDA device, got {[str(a.device) for a in tensors]}")
    if x.dtype not in _DTYPE_CODE or (g is not None and g.dtype != x.dtype):
        raise TypeError(f"{name} kernel takes x (and g) in one of {list(_DTYPE_CODE)}; got "
                        f"{x.dtype}{'' if g is None else f', {g.dtype}'}")
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes b in one of {list(_DTYPE_CODE)}; got {b.dtype}")
    if x.dim() < 1 or b.shape != (x.shape[-1],):
        raise ValueError(f"{name}: b must be [{x.shape[-1] if x.dim() else '?'}], got {tuple(b.shape)}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"{name}: g must be shaped like x {tuple(x.shape)}, got {tuple(g.shape)}")


def _route(dtype, F, *ptrs):
    """The kernel that takes rows of F elements of ``dtype`` at these
    addresses (x, and g in the backward): ``"vec"`` when a row is a positive
    multiple of 16 bytes and every base is 16-byte aligned, else ``"simt"``.
    The outputs are fresh allocations, aligned by the allocator."""
    if dtype not in _DTYPE_CODE or F <= 0:
        return "simt"
    return "vec" if (F * dtype.itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs) else "simt"


def _bands(N, F, esz, sms=132):
    """(rows a band, bands) of the "vec" backward over x [N, F] of esz-byte
    elements on a card of ``sms`` SMs: at most one wave of blocks
    (_BWD_BLOCKS_PER_SM an SM) where N allows, a band a multiple of VR rows
    (so every row slice of a block has the same rows but in the last band)."""
    col_blocks = -(-(F * esz // 16) // _VT)
    want = max(1, _BWD_BLOCKS_PER_SM * sms // max(col_blocks, 1))
    rows = max(_VR, -(-(-(-N // want)) // _VR) * _VR)  # ceil(N / want), rounded up to VR
    return rows, -(-N // rows)


def _sms(device):
    """SMs of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(route, x, b, g, *outs):
    """Launch ``route``'s kernels on x's device and current stream; raise if
    the launch was refused. The forward (g None): ``outs = (y,)``; the
    backward: ``(dpre,)`` on "simt", ``(dx, partials, db)`` on "vec"."""
    F = x.shape[-1]
    N = x.numel() // F if F else 0
    lib = _kernel()
    bwd = g is not None
    g_ptr = g.data_ptr() if bwd else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "vec":
            out, partials, db = outs if bwd else (outs[0], None, None)
            rows, bands = _bands(N, F, x.element_size(), _sms(x.device)) if bwd else (0, 0)
            err = lib.smp_bias_gelu_vec(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype], int(bwd), x.data_ptr(), b.data_ptr(), g_ptr,
                out.data_ptr(), partials.data_ptr() if bwd else None, db.data_ptr() if bwd else None, N, F, rows,
                bands, stream)
        else:
            bf = b.float().contiguous()  # exact: the CUDA-core kernels add an fp32 bias
            err = lib.smp_bias_gelu(_DTYPE_CODE[x.dtype], int(bwd), x.data_ptr(), bf.data_ptr(), g_ptr,
                                    outs[0].data_ptr(), N, F, stream)
    if err != 0:
        name = "bias_gelu_bwd" if bwd else "bias_gelu_fwd"
        raise RuntimeError(f"{name} ({route}) launch failed: {lib.smp_cuda_error_string(err).decode()}")


def bias_gelu_fwd(x, b):
    """``gelu_tanh(x + b)`` in x's dtype over x [..., F] and b [F]: the
    plain version for CPU tensors, one of ``csrc/bias_gelu.cu``'s forward
    kernels (``_fwd_kernel``'s counterpart; ``_route`` picks) for CUDA
    tensors, else it raises."""
    if x.device.type == "cpu":
        return reference_bias_gelu(x, b)
    _check_cuda("bias_gelu_fwd", x, b)
    x, b = x.contiguous(), b.contiguous()
    y = torch.empty_like(x)
    route = _route(x.dtype, x.shape[-1], x.data_ptr())
    _launch(route, x, b, None, y)
    if route == "vec":
        bias_gelu_fwd.launches += 1
    else:
        bias_gelu_fwd.simt_launches += 1
    return y


def bias_gelu_bwd(x, b, g):
    """``_bg_bwd``: ``(dx, db)`` for x [..., F], b [F] and g shaped like x,
    with dpre = g * gelu_tanh'(x + b) in fp32, dx = dpre in x's dtype and db
    = its fp32 row sum in b's dtype. The plain version for CPU tensors; for
    CUDA tensors ``csrc/bias_gelu.cu``'s one-pass kernel ("vec"), or its
    dpre kernel then a torch cast and row sum ("simt"); else it raises."""
    if x.device.type == "cpu":
        return reference_bias_gelu_grads(x, b, g)
    _check_cuda("bias_gelu_bwd", x, b, g)
    x, b, g = x.contiguous(), b.contiguous(), g.contiguous()
    F = x.shape[-1]
    route = _route(x.dtype, F, x.data_ptr(), g.data_ptr())
    if route == "vec":
        dx = torch.empty_like(x)
        partials = torch.empty((_bands(x.numel() // F, F, x.element_size(), _sms(x.device))[1], F),
                               dtype=torch.float32, device=x.device)
        db = torch.empty((F,), dtype=b.dtype, device=x.device)
        _launch(route, x, b, g, dx, partials, db)
        bias_gelu_bwd.launches += 1
        return dx, db
    dpre = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch(route, x, b, g, dpre)
    bias_gelu_bwd.simt_launches += 1
    return dpre.to(x.dtype), dpre.reshape(-1, F).sum(0).to(b.dtype)


bias_gelu_fwd.launches = 0  # launches of the forward's "vec" kernel
bias_gelu_fwd.simt_launches = 0  # ... of its "simt" kernel
bias_gelu_bwd.launches = 0  # launches of the backward's "vec" kernels (dx and db in one call)
bias_gelu_bwd.simt_launches = 0  # ... of its "simt" dpre kernel


class _BiasGeluFn(torch.autograd.Function):
    """``bias_gelu`` with ``_bg_bwd``'s backward: the forward saves (x, b);
    the backward is one ``bias_gelu_bwd`` call giving dx in x's dtype and db
    in b's dtype."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.save_for_backward(x, b)
        return bias_gelu_fwd(x, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        dx, db = bias_gelu_bwd(x, b, g.to(x.dtype))
        return dx if ctx.needs_input_grad[0] else None, db if ctx.needs_input_grad[1] else None


def bias_gelu(x, b):
    """``gelu(x + b)`` (tanh approximation) over ``x [..., F]`` and ``b
    [F]`` in one fused pass. Differentiable in x and b. CPU tensors run the
    plain versions; CUDA tensors launch ``csrc/bias_gelu.cu`` or raise."""
    return _BiasGeluFn.apply(x, b)


def _is_cuda(x):
    """Whether the kernels would run on a CUDA device (one seam, so the CPU
    tests can take the card's branch)."""
    return x.is_cuda


def bias_gelu_ok(activation, x):
    """Dispatch precondition: the tanh-GELU family (HF "gelu_new", the
    reference's fused bias_gelu polynomial) and, for the JAX gate's "on
    TPU", the activation ``x`` on a CUDA device."""
    return activation in ("gelu", "gelu_new") and _is_cuda(x)


_LIB = None  # csrc/bias_gelu.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("bias_gelu")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.smp_bias_gelu.argtypes = [c_int, c_int] + [c_ptr] * 4 + [c_int, c_int, c_ptr]
        lib.smp_bias_gelu.restype = c_int
        lib.smp_bias_gelu_vec.argtypes = [c_int] * 3 + [c_ptr] * 6 + [c_int] * 4 + [c_ptr]
        lib.smp_bias_gelu_vec.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
