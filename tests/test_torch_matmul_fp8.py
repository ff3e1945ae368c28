"""The port's fp8 matmul (``ops/matmul_fp8.py``) against the JAX package's
(``ops/pallas_qkv.matmul_bias_fp8``).

The plain version (what the wrapper runs on CPU tensors, and what the card
holds ``csrc/matmul_fp8.cu`` against) against the Pallas kernel run in
interpret mode, on the same e4m3 operands made from a seed with numpy; the
port's weight is the [F, D] ``nn.Linear`` layout, the JAX kernel's [D, F]
transposed. Shapes: the fused QKV of the smp.nn path scaled down, N below
32, ragged (1000 x 33 -> 17) and D beyond one tile of the card's kernel (64)
and of the TPU's blocks. Values: every e4m3 code but NaN (magnitudes up to
448, subnormals, signed zeros), activation-like operands cast with a delayed
scale, and rows and columns of zeros.

Tolerance: each product of two e4m3 values is exact in fp32, so the two
versions differ only in the order of the fp32 sums. Any order of a sum of D
terms is within D * 2**-24 of the sum of their magnitudes of the exact sum,
so each element is held to 2 * D * 2**-24 * (|x8| @ |w8|^T) of its own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from smdistributed_modelparallel_tpu.ops import pallas_qkv
from smdistributed_modelparallel_tpu_torch.ops import matmul_fp8 as mf

# (N, D, F)
SHAPES = {
    "qkv_path_scaled_down": (256, 96, 288),
    "few_rows_n8": (8, 64, 96),
    "ragged_1000x33x17": (1000, 33, 17),
    "d1600_beyond_one_tile": (40, 1600, 72),
}
NAN_CODES = (0x7F, 0xFF)


def fp8_operands(N, D, F, values, seed):
    """(x8 [N, D], w8 [F, D]) as numpy float8_e4m3fn: ``codes`` draws every
    non-NaN code uniformly; ``activations`` casts N(0, 1) activations and
    N(0, 0.02) weights with scales that put their amax at 448, as a delayed
    scale would. Row 1 of x8 and column 2 of the product are zeros."""
    rng = np.random.default_rng(seed)
    if values == "codes":
        u = rng.integers(0, 256, (N + F, D)).astype(np.uint8)
        u[np.isin(u, NAN_CODES)] = 0
        x8, w8 = u[:N].view(ml_dtypes.float8_e4m3fn), u[N:].view(ml_dtypes.float8_e4m3fn)
    else:
        x = rng.standard_normal((N, D)).astype(np.float32) * 3.0
        w = rng.standard_normal((F, D)).astype(np.float32) * 0.02
        x8 = (x / (np.abs(x).max() / 448.0)).astype(ml_dtypes.float8_e4m3fn)
        w8 = (w / (np.abs(w).max() / 448.0)).astype(ml_dtypes.float8_e4m3fn)
    x8, w8 = x8.copy(), w8.copy()
    x8[min(1, N - 1)] = 0
    w8[min(2, F - 1)] = 0
    return x8, w8


def _tolerance(x8, w8):
    absdot = np.abs(x8.astype(np.float32)).astype(np.float64) @ np.abs(w8.astype(np.float32)).T.astype(np.float64)
    return 2 * x8.shape[1] * 2.0**-24 * absdot


@pytest.mark.parametrize("values", ["codes", "activations"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_matches_pallas_kernel(shape, values):
    N, D, F = SHAPES[shape]
    x8, w8 = fp8_operands(N, D, F, values, seed=N + D + F)
    want = np.asarray(pallas_qkv.matmul_bias_fp8(jnp.asarray(x8), jnp.asarray(w8.T.copy()), interpret=True))
    tx, tw = (torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn) for a in (x8, w8))
    got = mf.matmul_fp8(tx, tw)  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (N, F)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= _tolerance(x8, w8)).all(), float(err.max())
    assert (got.numpy()[min(1, N - 1)] == 0).all() and (got.numpy()[:, min(2, F - 1)] == 0).all()
    assert np.isfinite(got.numpy()).all()


def test_reference_is_an_exact_fp32_product():
    """The plain version widens exactly: on small integer-valued e4m3
    operands every sum is exact in fp32, so it equals the numpy product."""
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (20, 30)).astype(np.float32)
    w = rng.integers(-8, 9, (10, 30)).astype(np.float32)
    got = mf.reference_matmul_fp8(torch.from_numpy(x).to(torch.float8_e4m3fn),
                                  torch.from_numpy(w).to(torch.float8_e4m3fn))
    np.testing.assert_array_equal(got.numpy(), x @ w.T)


def test_wrapper_counts_only_kernel_launches():
    x8, w8 = fp8_operands(9, 33, 17, "codes", 0)
    tx, tw = (torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn) for a in (x8, w8))
    before = mf.matmul_fp8.launches
    mf.matmul_fp8(tx, tw)
    assert mf.matmul_fp8.launches == before
    assert mf._LIB is None  # nothing is built for CPU tensors


# _route: e4m3 operands with D a positive multiple of 16 (16-byte rows) on
# 16-byte aligned bases go to the tensor cores; the rest to the CUDA cores.
@pytest.mark.parametrize("D,offset,want", [
    (768, 0, "wgmma"), (16, 0, "wgmma"), (1600, 0, "wgmma"), (33, 0, "simt"), (8, 0, "simt"), (0, 0, "simt"),
    (768, 1, "simt"), (768, 8, "simt"), (768, 16, "wgmma"),
])
def test_route_by_row_bytes_and_alignment(D, offset, want):
    base = torch.zeros(4 * max(D, 1) + 32, dtype=torch.uint8).view(torch.float8_e4m3fn)
    x8 = base[offset:offset + 2 * D].view(2, D) if D else base[:0].view(0, 0)
    assert mf._route(D, x8.data_ptr(), base.data_ptr()) == want
    assert mf._route(D, base.data_ptr(), x8.data_ptr()) == want  # either operand


@pytest.mark.parametrize("D,want", [(64, "wgmma"), (33, "simt")])
def test_launches_counted_by_route(monkeypatch, D, want):
    """Through the ``_is_cuda`` seam (meta tensors stand in for the card's):
    the tensor-core route counts in ``.launches``, the CUDA-core route in
    ``.simt_launches``, one launch each, and CPU tensors count in neither."""
    launched = []
    monkeypatch.setattr(mf, "_is_cuda", lambda t: True)
    monkeypatch.setattr(mf, "_launch", lambda route, x8, w8, y: launched.append(route))
    x8, w8 = (torch.empty(s, dtype=torch.float8_e4m3fn, device="meta") for s in ((5, D), (7, D)))
    before = (mf.matmul_fp8.launches, mf.matmul_fp8.simt_launches)
    y = mf.matmul_fp8(x8, w8)
    assert y.shape == (5, 7) and y.dtype == torch.float32 and launched == [want]
    moved = (mf.matmul_fp8.launches - before[0], mf.matmul_fp8.simt_launches - before[1])
    assert moved == ((1, 0) if want == "wgmma" else (0, 1))
    mf.matmul_fp8(torch.zeros(5, D).to(torch.float8_e4m3fn), torch.zeros(7, D).to(torch.float8_e4m3fn))
    assert launched == [want]
    assert (mf.matmul_fp8.launches - before[0], mf.matmul_fp8.simt_launches - before[1]) == moved
