"""Matrix product of two fp8 (e4m3) operands into fp32: the fp8 rung of the
fused QKV projection, the CUDA kernel's wrapper and its plain version.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_qkv.py``'s
``matmul_bias_fp8``, whose kernel is ``_mm_fp8_kernel``. Here the kernels
are ``csrc/matmul_fp8.cu``'s. ``matmul_fp8`` runs the plain version for
tensors on the CPU and a kernel for CUDA tensors; it never falls back from
one to the other. ``_route`` picks the kernel by the operands alone:
``"wgmma"`` (tensor cores fed by TMA, the e4m3 bytes widened exactly to f16
in shared memory, fp32 accumulation) when D is a positive multiple of 16 and
both bases are 16-byte aligned (TMA's rules), else ``"simt"`` (the CUDA
cores). A route never gives way to the other when a build or a launch fails.
``matmul_fp8.launches`` counts the tensor-core launches, ``.simt_launches``
the CUDA-core ones. It is not differentiable on its own: ``quant._fp8_mm2d``
owns the e5m2 backward, as the JAX package's ``custom_vjp`` does, and keeps
the dequant multiply and the bias in its epilogue.

Layout: ``w8`` is the port's parameter as the attention layer holds it, an
``nn.Linear``-style [F, D] weight, i.e. the JAX kernel's w8 [D, F]
transposed. Both operands are contiguous along D.

The JAX kernel falls back to a plain f8 dot when no tile fits the TPU's 12
MiB VMEM budget (D above about 19.6k). Both CUDA kernels stream D through
shared memory, so together they take any N, D and F and need no such
fallback; the fp8 rung rides the fused QKV's gate
(``matmul_bias.fused_qkv_ok``, with its ``_is_cuda`` seam) and has none of
its own.
"""

import ctypes

import torch


def reference_matmul_fp8(x8, w8):
    """Plain PyTorch version of the kernel: ``x8 [N, D] @ w8 [F, D]^T`` with
    both e4m3 operands widened to fp32 (exact), an fp32 product."""
    return x8.float() @ w8.float().t()


def _check_cuda(x8, w8):
    """The kernel's contract: x8 [N, D] and w8 [F, D], both
    ``torch.float8_e4m3fn``, on one CUDA device."""
    if not (_is_cuda(x8) and w8.device == x8.device):
        raise ValueError(f"matmul_fp8: inputs must share one CUDA device, got {x8.device}, {w8.device}")
    if x8.dtype != torch.float8_e4m3fn or w8.dtype != torch.float8_e4m3fn:
        raise TypeError(f"matmul_fp8 kernel takes float8_e4m3fn operands; got {x8.dtype}, {w8.dtype}")
    if x8.dim() != 2 or w8.dim() != 2 or x8.shape[1] != w8.shape[1]:
        raise ValueError(f"matmul_fp8: x8 must be [N, D] and w8 [F, D], got {tuple(x8.shape)}, {tuple(w8.shape)}")


def _route(D, x_ptr, w_ptr):
    """The kernel that takes x8 [N, D] and w8 [F, D] (e4m3) at these
    addresses: ``"wgmma"`` when TMA can stage them (D a positive multiple of
    16, 16-byte aligned bases), else ``"simt"``."""
    return "wgmma" if D > 0 and D % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0 else "simt"


def matmul_fp8(x8, w8):
    """``x8 @ w8^T`` in fp32: the plain version for CPU tensors, one of
    ``csrc/matmul_fp8.cu``'s kernels (``_mm_fp8_kernel``'s counterpart;
    ``_route`` picks) for CUDA tensors, else it raises."""
    if x8.device.type == "cpu":
        return reference_matmul_fp8(x8, w8)
    _check_cuda(x8, w8)
    x8, w8 = x8.contiguous(), w8.contiguous()
    y = torch.empty((x8.shape[0], w8.shape[0]), dtype=torch.float32, device=x8.device)
    route = _route(x8.shape[1], x8.data_ptr(), w8.data_ptr())
    _launch(route, x8, w8, y)
    if route == "wgmma":
        matmul_fp8.launches += 1
    else:
        matmul_fp8.simt_launches += 1
    return y


matmul_fp8.launches = 0  # launches of the tensor-core kernel
matmul_fp8.simt_launches = 0  # launches of the CUDA-core kernel


def _launch(route, x8, w8, y):
    """Launch ``route``'s kernel on x8's device and current stream; raise if
    the launch was refused."""
    lib = _kernel()
    entry = lib.smp_matmul_fp8_wgmma if route == "wgmma" else lib.smp_matmul_fp8_simt
    (N, D), F = x8.shape, w8.shape[0]
    with torch.cuda.device(x8.device):
        err = entry(x8.data_ptr(), w8.data_ptr(), y.data_ptr(), N, D, F,
                    torch.cuda.current_stream(x8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_fp8 ({route}) launch failed: {lib.smp_cuda_error_string(err).decode()}")


def _is_cuda(x):
    """Whether a kernel would run on a CUDA device (one seam, so the CPU
    tests can take the card's branch)."""
    return x.is_cuda


_LIB = None  # csrc/matmul_fp8.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("matmul_fp8")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        for entry in (lib.smp_matmul_fp8_wgmma, lib.smp_matmul_fp8_simt):
            entry.argtypes = [c_ptr] * 3 + [c_int] * 3 + [c_ptr]
            entry.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
