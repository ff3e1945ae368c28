"""The bias-GELU backward's contract and both wrappers' routes
(``ops/bias_gelu.py``), on the CPU.

  - ``reference_bias_gelu_grads`` (the plain version of the one-pass "vec"
    backward: dx in x's dtype, db the fp32 row sum of dpre in b's dtype)
    against ``jax.vjp`` of the Pallas ``bias_gelu`` in interpret mode, on
    ragged shapes and with zeros, fp32 and bf16, at ``test_torch_bias_gelu``'s
    tolerances (fp32 1e-5; bf16 dx one ulp, db one ulp plus 1e-3);
  - a bias of another dtype than x (bf16 against fp32 and the reverse) against
    the JAX package given the same dtypes: db comes back in b's dtype;
  - ``_route`` as a pure function of dtype, F and the bases' alignment, and
    the launches it sends to each route (meta tensors through the
    ``_is_cuda`` and ``_launch`` seams stand in for the card's);
  - ``_bands``: the backward's bands cover every row once and keep the fp32
    partials near 400 KB;
  - the b dtype the kernels take, and ``chip_smoke.gelu_db_tol``, the card's
    bound on db: it admits another fp32 summation order and refuses a db that
    lost one band of rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import GELU_TOL, gelu_db_tol
from smdistributed_modelparallel_tpu.ops import pallas_gelu
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
# (leading shape, F): ragged rows and columns, a 3-d activation, more rows
# than one TPU block.
SHAPES = [((5,), 37), ((4,), 19), ((2, 3), 64), ((300,), 48)]
CASES = [(s, z) for s in SHAPES for z in (False, True)]
IDS = [f"{'x'.join(map(str, lead))}x{F}{'_zeros' if z else ''}" for (lead, F), z in CASES]


def _inputs(lead, F, seed, x_dtype, b_dtype, zeros=False):
    """(jax x, b, g), (torch x, b, g): the same values, from a seed."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(lead + (F,))).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    g = rng.standard_normal(lead + (F,)).astype(np.float32)
    if zeros:
        b[::3] = 0.0
        g[..., ::4] = 0.0
    j = [jnp.asarray(a, JDT[t]) for a, t in ((x, x_dtype), (b, b_dtype), (g, x_dtype))]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(d) for a, d in zip(j, (x_dtype, b_dtype, x_dtype))]
    return j, t


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _jax_grads(jx, jb, jg):
    _, vjp = jax.vjp(lambda x, b: pallas_gelu.bias_gelu(x, b, True), jx, jb)
    return vjp(jg)


def _assert_grads(dx, db, jdx, jdb, x_dtype, b_dtype):
    """test_torch_bias_gelu's tolerances: fp32 1e-5 (db, a sum of up to 300
    rows in another order, also 1e-5 of its size); bf16 dx within one ulp,
    db (an fp32 sum rounded once) within one ulp plus 1e-3."""
    if x_dtype == torch.float32:
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=2**-7, atol=1e-5)
    if b_dtype == torch.float32:
        np.testing.assert_allclose(_np(db), _np(jdb), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(db), _np(jdb), rtol=2**-7, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_reference_grads_match_pallas_vjp(case, dtype):
    (lead, F), zeros = case
    (jx, jb, jg), (tx, tb, tg) = _inputs(lead, F, 7 * F, dtype, dtype, zeros)
    jdx, jdb = _jax_grads(jx, jb, jg)
    dx, db = bg.reference_bias_gelu_grads(tx, tb, tg)
    assert dx.dtype == dtype and dx.shape == tx.shape and db.dtype == dtype and db.shape == (F,)
    _assert_grads(dx, db, jdx, jdb, dtype, dtype)
    got = bg.bias_gelu_bwd(tx, tb, tg)  # CPU tensors: the same plain version
    assert all(torch.equal(a, b) for a, b in zip(got, (dx, db)))
    if zeros:
        assert (dx[..., ::4] == 0).all()


@pytest.mark.parametrize("x_dtype,b_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)], ids=["bf16_bf16", "fp32_bf16",
                                                                                     "bf16_fp32"])
def test_bias_dtype_matches_jax(x_dtype, b_dtype):
    """A bias in its own dtype (the smp.nn path passes a bf16 one): y, and
    the grads through the autograd function, against the JAX package given
    the same dtypes; db comes back in b's dtype."""
    (jx, jb, jg), (tx, tb, tg) = _inputs((3, 7), 40, 11, x_dtype, b_dtype)
    want_y = pallas_gelu.bias_gelu(jx, jb, True)
    jdx, jdb = _jax_grads(jx, jb, jg)
    tx.requires_grad_()
    tb.requires_grad_()
    y = bg.bias_gelu(tx, tb)
    dx, db = torch.autograd.grad(y, (tx, tb), tg)
    assert y.dtype == x_dtype and dx.dtype == x_dtype and db.dtype == b_dtype
    rtol = 0 if x_dtype == torch.float32 else 2**-7
    np.testing.assert_allclose(_np(y.detach()), _np(want_y), rtol=rtol, atol=1e-6)
    _assert_grads(dx, db, jdx, jdb, x_dtype, b_dtype)


# _route: rows of a positive multiple of 16 bytes on 16-byte aligned bases go
# to the "vec" kernels; another row size, a base off by a storage offset, an
# empty row or a dtype the kernels do not take to "simt".
@pytest.mark.parametrize("dtype,F,offset,want", [
    (torch.bfloat16, 3072, 0, "vec"),
    (torch.float16, 3072, 0, "vec"),
    (torch.float32, 3072, 0, "vec"),
    (torch.bfloat16, 8, 0, "vec"),
    (torch.float32, 4, 0, "vec"),
    (torch.bfloat16, 6400, 0, "vec"),
    (torch.bfloat16, 17, 0, "simt"),
    (torch.float16, 12, 0, "simt"),
    (torch.float32, 6, 0, "simt"),
    (torch.bfloat16, 0, 0, "simt"),
    (torch.bfloat16, 3072, 1, "simt"),
    (torch.float32, 3072, 2, "simt"),
    (torch.float32, 3072, 4, "vec"),
    (torch.float16, 3072, 8, "vec"),
    (torch.float64, 2, 0, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
def test_route_by_dtype_row_bytes_and_alignment(dtype, F, offset, want):
    base = torch.empty(4 * max(F, 1) + 16, dtype=dtype)
    x = base[offset:offset + 2 * F].view(2, F) if F else base[:0].view(0, 0)
    assert x.is_contiguous()
    assert bg._route(dtype, F, x.data_ptr()) == want
    assert bg._route(dtype, F, x.data_ptr(), base.data_ptr()) == want  # the backward: x and g
    assert bg._route(dtype, F, base.data_ptr(), x.data_ptr()) == want


@pytest.fixture
def meta_launches(monkeypatch):
    """Send meta tensors down the card's branch (an H100's 132 SMs); record
    each launch's route and its outputs' (shape, dtype)."""
    launched = []
    monkeypatch.setattr(bg, "_is_cuda", lambda t: True)
    monkeypatch.setattr(bg, "_sms", lambda device: 132)
    monkeypatch.setattr(bg, "_launch", lambda route, x, b, g, *outs: launched.append(
        (route, [(tuple(o.shape), o.dtype) for o in outs])))
    return launched


def _counts():
    return [getattr(fn, k) for fn in (bg.bias_gelu_fwd, bg.bias_gelu_bwd) for k in ("launches", "simt_launches")]


@pytest.mark.parametrize("dtype,F,want", [
    (torch.bfloat16, 3072, "vec"), (torch.float16, 64, "vec"), (torch.float32, 64, "vec"),
    (torch.bfloat16, 33, "simt"), (torch.float32, 17, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
def test_launches_counted_by_route(meta_launches, dtype, F, want):
    """One launch a call on ``_route``'s route, counted in ``.launches``
    ("vec") or ``.simt_launches``; the "vec" backward writes dx, fp32
    partials [bands, F] and db in one launch, the "simt" one fp32 dpre (torch
    then casts it and sums its rows); CPU tensors count in neither."""
    N = 100
    x, g = (torch.empty((4, N // 4, F), dtype=dtype, device="meta") for _ in range(2))
    b = torch.empty(F, dtype=torch.bfloat16, device="meta")
    before = _counts()
    y = bg.bias_gelu_fwd(x, b)
    dx, db = bg.bias_gelu_bwd(x, b, g)
    assert y.shape == dx.shape == x.shape and y.dtype == dx.dtype == dtype
    assert db.shape == (F,) and db.dtype == torch.bfloat16
    bands = bg._bands(N, F, x.element_size())[1]
    if want == "vec":
        assert meta_launches == [("vec", [(x.shape, dtype)]),
                                 ("vec", [(x.shape, dtype), ((bands, F), torch.float32), ((F,), torch.bfloat16)])]
    else:
        assert meta_launches == [("simt", [(x.shape, dtype)]), ("simt", [(x.shape, torch.float32)])]
    moved = [a - b for a, b in zip(_counts(), before)]
    assert moved == ([1, 0, 1, 0] if want == "vec" else [0, 1, 0, 1])
    cpu = [torch.zeros((2, F), dtype=dtype), torch.zeros(F), torch.zeros((2, F), dtype=dtype)]
    bg.bias_gelu_fwd(*cpu[:2])
    bg.bias_gelu_bwd(*cpu)
    assert [a - b for a, b in zip(_counts(), before)] == moved and len(meta_launches) == 2


def test_bias_dtype_contract(meta_launches):
    """The kernels read b in its own dtype, so they take fp32, fp16 and bf16
    and refuse another floating dtype by name; the plain versions (CPU) take
    any floating b, as the JAX package does."""
    x = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    for b_dtype in (torch.float32, torch.float16, torch.bfloat16):
        bg.bias_gelu_fwd(x, torch.empty(16, dtype=b_dtype, device="meta"))
        bg.bias_gelu_bwd(x, torch.empty(16, dtype=b_dtype, device="meta"), x)
    b64 = torch.empty(16, dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="float32.*float16.*bfloat16"):
        bg.bias_gelu_fwd(x, b64)
    with pytest.raises(TypeError, match="float32.*float16.*bfloat16"):
        bg.bias_gelu_bwd(x, b64, x)
    assert len(meta_launches) == 6
    xc = torch.randn(8, 16)
    bc = torch.randn(16, dtype=torch.float64)
    dx, db = bg.bias_gelu_bwd(xc, bc, torch.ones(8, 16))
    assert bg.bias_gelu_fwd(xc, bc).dtype == torch.float32 and db.dtype == torch.float64


@pytest.mark.parametrize("N,F,esz", [(2048, 3072, 2), (8, 3072, 2), (1000, 3072, 2), (2047, 3072, 2),
                                     (512, 6400, 2), (300, 96, 2), (0, 3072, 2), (32768, 3072, 2),
                                     (2048, 3072, 4), (100, 16, 4), (5, 200000, 2)])
def test_bands_cover_every_row_once(N, F, esz):
    """Every row in one band, bands of whole row slices, one wave of blocks
    on an H100 (or one band where a row of blocks is more), partials near
    400 KB."""
    rows, bands = bg._bands(N, F, esz)
    assert rows >= bg._VR and rows % bg._VR == 0
    assert bands * rows >= N and (bands - 1) * rows < max(N, 1)
    assert bands * F * 4 <= 410e3 or bands == 1
    col_blocks = -(-(F * esz // 16) // bg._VT)
    assert col_blocks * bands <= bg._BWD_BLOCKS_PER_SM * 132 or bands == 1
    assert bg._bands(N, F, esz, sms=114)[0] >= rows  # fewer SMs: no more blocks


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
def test_db_bound_admits_another_order_and_refuses_a_lost_band(b_dtype):
    """``gelu_db_tol`` (chip_smoke's bound on the card's db): a column sum in
    another fp32 order (sequential, as the kernel's thread adds its rows)
    lies inside it; a db that lost one band of 32 rows does not."""
    _, (tx, tb, tg) = _inputs((2048,), 96, 5, torch.bfloat16, b_dtype)
    dpre = bg.reference_bias_gelu_bwd(tx, tb, tg)
    _, want = bg.reference_bias_gelu_grads(tx, tb, tg)
    tol = gelu_db_tol(dpre, want)
    other = torch.zeros(96)
    for row in dpre.flip(0):  # every row, one at a time, from the last
        other = other + row
    assert ((other.to(b_dtype).float() - want.float()).abs() <= tol).all()
    lost = dpre[32:].sum(0).to(b_dtype)
    assert ((lost.float() - want.float()).abs() > tol).any()
    assert GELU_TOL[torch.float16] == (1e-5, 2**-10)
