"""The port's fused QKV matmul (``ops/matmul_bias.py``) against the JAX
package's (``ops/pallas_qkv.py``).

The plain version (what the wrapper runs on CPU tensors, and what the card
holds ``csrc/matmul_bias.cu`` against) against the Pallas kernel run in
interpret mode, on the same numpy inputs from a seed; the port's weight is
the [F, D] ``nn.Linear`` layout, the JAX kernel's [D, F] transposed:
  - the forward, with and without bias, fp32 and bf16, on ragged shapes:
    fp32 1e-5 (``tests/test_tp_overlap.py``'s tolerance; only the summation
    order differs); bf16 within one bf16 ulp (rtol 2**-7) plus 1e-4, since
    both round one fp32 sum, summed in another order, to bf16;
  - the backward (``_MatmulBiasFn`` against ``_mb_bwd`` through
    ``jax.vjp``, for one cotangent): fp32 1e-4 (as test_tp_overlap's grads);
    bf16 within one bf16 ulp (the fp32 products are rounded once);
  - the dispatch gate and the launch counter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smdistributed_modelparallel_tpu.ops import pallas_qkv
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

# (N, D, F): ragged everywhere, few rows, and a wider F than one TPU block.
SHAPES = [(9, 33, 17), (6, 21, 13), (8, 64, 96), (70, 40, 600)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(N, D, F, seed, jdtype, tdtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.standard_normal((D, F)).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    dy = rng.standard_normal((N, F)).astype(np.float32)
    j = [jnp.asarray(a, jdtype) for a in (x, w, b, dy)]
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdtype) for a in j]
    t[1] = t[1].t().contiguous()  # [F, D]: the port's nn.Linear layout
    return j, t


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_pallas_kernel(shape, bias, dtype):
    (jx, jw, jb, _), (tx, tw, tb, _) = _inputs(*shape, sum(shape), *DTYPES[dtype])
    want = pallas_qkv.matmul_bias(jx, jw, jb if bias else None, interpret=True)
    got = mb.matmul_bias_fwd(tx, tw, tb if bias else None)  # CPU tensors: the plain version
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    # The two packages' plain references agree as well.
    _close(mb.reference_matmul_bias(tx, tw, tb if bias else None),
           pallas_qkv.reference_matmul_bias(jx, jw, jb if bias else None), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_pallas_vjp(shape, bias, dtype):
    (jx, jw, jb, jdy), (tx, tw, tb, tdy) = _inputs(*shape, 7 * sum(shape), *DTYPES[dtype])
    jargs = (jx, jw, jb) if bias else (jx, jw)
    y, vjp = jax.vjp(lambda *a: pallas_qkv.matmul_bias(*a, interpret=True), *jargs)
    want = vjp(jdy.astype(y.dtype))
    targs = [a.requires_grad_() for a in ((tx, tw, tb) if bias else (tx, tw))]
    out = mb.matmul_bias(*targs)
    got = torch.autograd.grad(out, targs, tdy)
    assert out.grad_fn is not None
    tol = 1e-4 if dtype == "fp32" else None
    for name, g, w in zip(("dx", "dw", "db"), got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        if name == "dw":
            w = w.T  # the port's weight is [F, D]
        assert g.dtype == targs[0].dtype, name
        g = g.float().numpy()
        if tol is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2**-7, atol=1e-3, err_msg=name)


def test_fused_qkv_ok_contract(monkeypatch):
    """Off the card the gate is False (as the JAX gate is off its TPU); on
    the card any D passes, and at tp > 1 only inside the ring."""
    x = torch.zeros(4, 20_000)  # wider than any tile the TPU's VMEM budget fits
    assert not mb.fused_qkv_ok(x)
    monkeypatch.setattr(mb, "_is_cuda", lambda t: True)
    assert mb.fused_qkv_ok(x)
    assert mb.fused_qkv_ok(x, ring=True, tp=2)
    assert not mb.fused_qkv_ok(x, ring=False, tp=2)
    monkeypatch.setattr(pallas_qkv, "FORCE_INTERPRET", True)
    assert not pallas_qkv.fused_qkv_ok(20_000)  # the JAX gate refuses this D


def test_wrapper_counts_only_kernel_launches():
    _, (tx, tw, tb, _) = _inputs(9, 33, 17, 0, jnp.float32, torch.float32)
    before = mb.matmul_bias_fwd.launches
    mb.matmul_bias_fwd(tx, tw, tb)
    mb.matmul_bias(tx.requires_grad_(), tw, tb).sum().backward()
    assert mb.matmul_bias_fwd.launches == before
    assert mb._LIB is None  # nothing is built for CPU tensors


# _route: bf16 and fp16 operands whose rows are a multiple of 16 bytes on
# 16-byte aligned bases go to the tensor cores (TMA's rules); fp32 (no TF32 in
# the contract), a D of other row bytes, or a base off by a storage offset go
# to the CUDA cores.
@pytest.mark.parametrize("dtype,D,offset,want", [
    (torch.bfloat16, 768, 0, "wgmma"),
    (torch.float16, 768, 0, "wgmma"),
    (torch.bfloat16, 8, 0, "wgmma"),
    (torch.float32, 768, 0, "simt"),
    (torch.float32, 33, 0, "simt"),
    (torch.bfloat16, 33, 0, "simt"),
    (torch.float16, 36, 0, "simt"),
    (torch.bfloat16, 0, 0, "simt"),
    (torch.bfloat16, 768, 1, "simt"),
    (torch.float16, 768, 8, "wgmma"),
], ids=lambda v: str(v).removeprefix("torch."))
def test_route_by_dtype_row_bytes_and_alignment(dtype, D, offset, want):
    base = torch.empty(4 * max(D, 1) + 16, dtype=dtype)
    x = base[offset:offset + 2 * D].view(2, D) if D else base[:0].view(0, 0)
    assert x.is_contiguous()
    assert mb._route(dtype, D, x.data_ptr(), base.data_ptr()) == want
    assert mb._route(dtype, D, base.data_ptr(), x.data_ptr()) == want  # either operand


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.float16, 64, "wgmma"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 33, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
def test_launches_counted_by_route(monkeypatch, dtype, D, want):
    """Through the ``_is_cuda`` seam (meta tensors stand in for the card's):
    the tensor-core route counts in ``.launches``, the CUDA-core route in
    ``.simt_launches``, one launch each, and CPU tensors count in neither."""
    launched = []
    monkeypatch.setattr(mb, "_is_cuda", lambda t: True)
    monkeypatch.setattr(mb, "_launch", lambda route, x, w, b, y: launched.append(route))
    x, w, b = (torch.empty(s, dtype=dtype, device="meta") for s in ((5, D), (7, D), (7,)))
    before = (mb.matmul_bias_fwd.launches, mb.matmul_bias_fwd.simt_launches)
    y = mb.matmul_bias_fwd(x, w, b)
    assert y.shape == (5, 7) and y.dtype == dtype and launched == [want]
    moved = (mb.matmul_bias_fwd.launches - before[0], mb.matmul_bias_fwd.simt_launches - before[1])
    assert moved == ((1, 0) if want == "wgmma" else (0, 1))
    mb.matmul_bias_fwd(torch.zeros(5, D, dtype=dtype), torch.zeros(7, D, dtype=dtype))  # the plain version
    assert launched == [want]
    assert (mb.matmul_bias_fwd.launches - before[0], mb.matmul_bias_fwd.simt_launches - before[1]) == moved


@pytest.mark.parametrize("b_dtype,want", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32), (torch.float16, torch.float32),
    (torch.float64, torch.float32),
], ids=lambda v: str(v).removeprefix("torch."))
def test_bias_reaches_the_kernel_uncast(monkeypatch, b_dtype, want):
    """The kernels read a bias in x's dtype or in fp32 as it is, so the path
    (bf16 operands, a bf16 bias) casts no bias per call; another dtype is
    widened, or rounded, to fp32 as the plain version does."""
    seen = []
    monkeypatch.setattr(mb, "_is_cuda", lambda t: True)
    monkeypatch.setattr(mb, "_launch", lambda route, x, w, b, y: seen.append((b.dtype, b.shape, b.is_contiguous())))
    x, w = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in ((5, 64), (7, 64)))
    mb.matmul_bias_fwd(x, w, torch.empty(1, 7, dtype=b_dtype, device="meta"))
    assert seen == [(want, (7,), True)]
