"""Matrix product of two fp8 (e4m3) operands into fp32: the fp8 rung of the
fused QKV projection, the CUDA kernel's wrapper and its plain version.

Counterpart of ``smdistributed_modelparallel_tpu/ops/pallas_qkv.py``'s
``matmul_bias_fp8``, whose kernel is ``_mm_fp8_kernel``. Here the kernel is
``csrc/matmul_fp8.cu``. ``matmul_fp8`` runs the plain version for tensors on
the CPU and the kernel for CUDA tensors; it never falls back from one to the
other, and counts its kernel's launches in ``.launches``. It is not
differentiable on its own: ``quant._fp8_mm2d`` owns the e5m2 backward, as the
JAX package's ``custom_vjp`` does, and keeps the dequant multiply and the bias
in its epilogue.

Layout: ``w8`` is the port's parameter as the attention layer holds it, an
``nn.Linear``-style [F, D] weight, i.e. the JAX kernel's w8 [D, F]
transposed. Both operands are contiguous along D.

The JAX kernel falls back to a plain f8 dot when no tile fits the TPU's 12
MiB VMEM budget (D above about 19.6k). The CUDA kernel streams D through
shared memory, so it takes any N, D and F and has no such fallback; the fp8
rung rides the fused QKV's gate (``matmul_bias.fused_qkv_ok``, with its
``_is_cuda`` seam) and has none of its own.
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
    if not (x8.is_cuda and w8.device == x8.device):
        raise ValueError(f"matmul_fp8: inputs must share one CUDA device, got {x8.device}, {w8.device}")
    if x8.dtype != torch.float8_e4m3fn or w8.dtype != torch.float8_e4m3fn:
        raise TypeError(f"matmul_fp8 kernel takes float8_e4m3fn operands; got {x8.dtype}, {w8.dtype}")
    if x8.dim() != 2 or w8.dim() != 2 or x8.shape[1] != w8.shape[1]:
        raise ValueError(f"matmul_fp8: x8 must be [N, D] and w8 [F, D], got {tuple(x8.shape)}, {tuple(w8.shape)}")


def matmul_fp8(x8, w8):
    """``x8 @ w8^T`` in fp32: the plain version for CPU tensors,
    ``csrc/matmul_fp8.cu`` (``_mm_fp8_kernel``'s counterpart) for CUDA
    tensors, else it raises."""
    if x8.device.type == "cpu":
        return reference_matmul_fp8(x8, w8)
    _check_cuda(x8, w8)
    x8, w8 = x8.contiguous(), w8.contiguous()
    (N, D), F = x8.shape, w8.shape[0]
    y = torch.empty((N, F), dtype=torch.float32, device=x8.device)
    lib = _kernel()
    with torch.cuda.device(x8.device):
        err = lib.smp_matmul_fp8(x8.data_ptr(), w8.data_ptr(), y.data_ptr(), N, D, F,
                                 torch.cuda.current_stream(x8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_fp8 launch failed: {lib.smp_cuda_error_string(err).decode()}")
    matmul_fp8.launches += 1
    return y


matmul_fp8.launches = 0  # launches of csrc/matmul_fp8.cu


_LIB = None  # csrc/matmul_fp8.cu, loaded at the first launch


def _kernel():
    global _LIB
    if _LIB is None:
        from smdistributed_modelparallel_tpu_torch.ops import _build

        lib = _build.load("matmul_fp8")
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.smp_matmul_fp8.argtypes = [c_ptr] * 3 + [c_int] * 3 + [c_ptr]
        lib.smp_matmul_fp8.restype = c_int
        lib.smp_cuda_error_string.argtypes = [c_int]
        lib.smp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
