"""The port's fused bias + GELU (``ops/bias_gelu.py``) against the JAX
package's (``ops/pallas_gelu.py``).

The plain versions (what the wrappers run on CPU tensors, and what the card
holds ``csrc/bias_gelu.cu`` against) against the Pallas kernels run in
interpret mode, on the same numpy inputs from a seed, on ragged shapes and
with zeros in b and g:
  - the forward: fp32 1e-6 (as ``tests/test_tp_overlap.py``; the same
    operations in the same order, tanh aside); bf16 within one bf16 ulp
    (rtol 2**-7), since an ulp of difference in fp32 can flip the one
    rounding to bf16;
  - the backward kernel's fp32 dpre (``reference_bias_gelu_bwd``): 1e-5 in
    both dtypes (fp32 out);
  - dx and db through ``_BiasGeluFn`` against ``jax.vjp`` of the
    ``custom_vjp``: fp32 1e-5 (as test_tp_overlap's grads; db, a sum over
    up to 300 rows in another order, also 1e-5 relative); bf16 dx within one
    ulp, db (an fp32 sum of dpre, rounded once) within one ulp plus 1e-3;
  - the unfused ``nn/gelu.py`` functions against the JAX package's;
  - the dispatch gate and the launch counters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu.nn as jax_nn
from smdistributed_modelparallel_tpu.ops import pallas_gelu
import smdistributed_modelparallel_tpu_torch.nn as port_nn
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg

# (leading shape, F): ragged rows and columns, a 3-d activation, more rows
# than one TPU block.
SHAPES = [((5,), 37), ((4,), 19), ((2, 3), 64), ((300,), 48)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(lead, F, seed, jdtype, tdtype, zeros=False):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(lead + (F,))).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    g = rng.standard_normal(lead + (F,)).astype(np.float32)
    if zeros:
        b[::3] = 0.0
        g[..., ::4] = 0.0
    j = [jnp.asarray(a, jdtype) for a in (x, b, g)]
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdtype) for a in j]
    return j, t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) else a.detach().float().numpy()


CASES = [(s, z) for s in SHAPES for z in (False, True)]
IDS = [f"{'x'.join(map(str, lead))}x{F}{'_zeros' if z else ''}" for (lead, F), z in CASES]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_pallas_kernel(case, dtype):
    (lead, F), zeros = case
    (jx, jb, _), (tx, tb, _) = _inputs(lead, F, F, *DTYPES[dtype], zeros=zeros)
    want = pallas_gelu.bias_gelu(jx, jb, True)
    got = bg.bias_gelu_fwd(tx, tb)  # CPU tensors: the plain version
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "fp32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(_np(bg.reference_bias_gelu(tx, tb)), _np(pallas_gelu.reference_bias_gelu(jx, jb)),
                               rtol=2**-7 if dtype == "bf16" else 0, atol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_dpre_matches_pallas_kernel(case, dtype):
    (lead, F), zeros = case
    (jx, jb, jg), (tx, tb, tg) = _inputs(lead, F, 3 * F, *DTYPES[dtype], zeros=zeros)
    want = pallas_gelu._call_rowwise(pallas_gelu._bwd_kernel, jnp.float32, True, jx.reshape(-1, F), jb,
                                     jg.reshape(-1, F))
    got = bg.reference_bias_gelu_bwd(tx, tb, tg)  # the plain version of _bwd_kernel
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(_np(got).reshape(-1, F), _np(want), rtol=1e-5, atol=1e-5)
    if zeros:
        assert (got[..., ::4] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grads_match_pallas_vjp(case, dtype):
    (lead, F), zeros = case
    (jx, jb, jg), (tx, tb, tg) = _inputs(lead, F, 5 * F, *DTYPES[dtype], zeros=zeros)
    _, vjp = jax.vjp(lambda x, b: pallas_gelu.bias_gelu(x, b, True), jx, jb)
    jdx, jdb = vjp(jg)
    tx.requires_grad_()
    tb.requires_grad_()
    out = bg.bias_gelu(tx, tb)
    dx, db = torch.autograd.grad(out, (tx, tb), tg)
    assert dx.dtype == tx.dtype and db.dtype == tb.dtype
    if dtype == "fp32":
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=0, atol=1e-5)
        # db sums up to 300 rows of dpre in another order: 1e-5 of its size too.
        np.testing.assert_allclose(_np(db), _np(jdb), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=2**-7, atol=1e-5)
        np.testing.assert_allclose(_np(db), _np(jdb), rtol=2**-7, atol=1e-3)


def test_unfused_gelu_functions_match_jax():
    rng = np.random.default_rng(0)
    x = (2 * rng.standard_normal((6, 23))).astype(np.float32)
    b = rng.standard_normal(23).astype(np.float32)
    np.testing.assert_allclose(port_nn.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_nn.gelu(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_nn.bias_gelu(torch.from_numpy(x), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_nn.bias_gelu(jnp.asarray(x), jnp.asarray(b))), rtol=0, atol=1e-6)


def test_bias_gelu_ok_contract(monkeypatch):
    """The tanh-GELU family, and (the JAX gate's "on TPU") a CUDA tensor."""
    x = torch.zeros(2, 8)
    assert not bg.bias_gelu_ok("gelu", x)
    monkeypatch.setattr(bg, "_is_cuda", lambda t: True)
    assert bg.bias_gelu_ok("gelu", x) and bg.bias_gelu_ok("gelu_new", x)
    for act in ("relu", "gelu_erf", "silu"):
        assert not bg.bias_gelu_ok(act, x)


def _counts():
    return [getattr(fn, k) for fn in (bg.bias_gelu_fwd, bg.bias_gelu_bwd) for k in ("launches", "simt_launches")]


def test_wrappers_count_only_kernel_launches():
    for dtype in sorted(DTYPES):  # CPU tensors, on rows of either route's size
        _, (tx, tb, tg) = _inputs((4,), 16 if dtype == "bf16" else 19, 0, *DTYPES[dtype])
        before = _counts()
        bg.bias_gelu_fwd(tx, tb)
        bg.bias_gelu_bwd(tx, tb, tg)
        bg.bias_gelu(tx.requires_grad_(), tb).sum().backward()
        assert _counts() == before
    assert bg._LIB is None  # nothing is built for CPU tensors
