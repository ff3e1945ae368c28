"""Routing of the port's fused cross-entropy backward (``ops/fused_ce.py``)
between its two kernels for each of dx and dW in ``csrc/fused_ce.cu``, and the
arithmetic of the tensor-core kernels.

``_route`` picks the tensor-core kernels (``"wgmma"``, fed by TMA, a cluster
splitting D) for bf16 x and w, contiguous, D a multiple of 8 up to 2048 on
16-byte aligned bases, and the CUDA-core kernels (``"simt"``) for the rest. On
the CPU the wrappers' card branch is driven with meta tensors through the
``_is_cuda`` seam and a recording ``_launch``: each launch counts on its
route's counter. CPU tensors still run the plain versions and build nothing.

The tensor-core kernels keep dlog in fp32 by feeding it to bf16 products as a
hi/lo pair (hi = bf16(dlog), lo = bf16(dlog - hi)). An emulation of that
arithmetic on bf16-representable inputs held in fp32 agrees with the plain
versions to 2^-15 of the largest value, which one bf16 rounding of dlog does
not: the reason the kernel carries lo. The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py`` phase B), and the plain versions against the JAX package in
``tests/test_torch_fused_ce.py``.
"""

import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fc

N, V = 24, 40


def _operand(rows, D, dtype, offset=0):
    """A contiguous [rows, D] tensor whose first element sits ``offset``
    elements into its storage."""
    return torch.zeros(offset + rows * D, dtype=dtype)[offset:].view(rows, D)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "wgmma"),
    (torch.float16, "simt"),   # dlog would fall into fp16's subnormals
    (torch.float32, "simt"),   # no TF32 in the contract
], ids=lambda v: str(v).removeprefix("torch."))
def test_route_by_dtype(dtype, want):
    x, w = _operand(N, 64, dtype), _operand(V, 64, dtype)
    assert fc._route(x, w) == want


@pytest.mark.parametrize("D,want", [
    (8, "wgmma"), (64, "wgmma"), (768, "wgmma"), (1600, "wgmma"), (2048, "wgmma"),
    (12, "simt"),    # rows of 24 bytes: not a multiple of 16
    (2056, "simt"),  # past 8 CTAs of 256 columns
])
def test_route_by_width(D, want):
    assert fc._route(_operand(N, D, torch.bfloat16), _operand(V, D, torch.bfloat16)) == want


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("offset,want", [(1, "simt"), (8, "wgmma")])  # 2 bytes off 16, 16 bytes on
def test_route_by_alignment(which, offset, want):
    x, w = _operand(N, 64, torch.bfloat16), _operand(V, 64, torch.bfloat16)
    if which == "x":
        x = _operand(N, 64, torch.bfloat16, offset)
    else:
        w = _operand(V, 64, torch.bfloat16, offset)
    assert fc._route(x, w) == want


def test_route_refuses_a_strided_operand():
    x = _operand(N, 128, torch.bfloat16)[:, :64]
    assert not x.is_contiguous()
    assert fc._route(x, _operand(V, 64, torch.bfloat16)) == "simt"
    assert fc._route(_operand(N, 64, torch.bfloat16), _operand(V, 128, torch.bfloat16)[:, :64]) == "simt"


def test_route_refuses_mixed_dtypes():
    assert fc._route(_operand(N, 64, torch.bfloat16), _operand(V, 64, torch.float32)) == "simt"


WRAPPERS = {"fused_ce_bwd_dx": (fc.fused_ce_bwd_dx, False), "fused_ce_bwd_dw": (fc.fused_ce_bwd_dw, True)}


def _meta(rows, D, dtype):
    return torch.empty(rows, D, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 768, "wgmma"), (torch.bfloat16, 1600, "wgmma"), (torch.float16, 768, "simt"),
    (torch.float32, 768, "simt"), (torch.bfloat16, 12, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_launches_counted_by_route(monkeypatch, wrapper, dtype, D, want):
    """Through the ``_is_cuda`` seam (meta tensors stand in for the card's):
    one launch of ``_route``'s kernel, dx or dW as the wrapper names, counted
    in ``.launches`` on the tensor-core route and in ``.simt_launches`` on the
    CUDA-core route; the output comes back shaped like the owned operand, in
    its dtype, with the smoothing term passed as eps / (smooth_denom or V)."""
    launched = []
    monkeypatch.setattr(fc, "_is_cuda", lambda t: True)
    monkeypatch.setattr(fc, "_launch", lambda route, dw, x, w, t, lse, g, eps, eps_d, out: launched.append(
        (route, dw, eps, eps_d, t.dtype, lse.dtype, g.dtype)))
    fn, dw = WRAPPERS[wrapper]
    x, w = _meta(N, D, dtype), _meta(V, D, dtype)
    targets = torch.empty(N, dtype=torch.long, device="meta")
    lse = g = torch.empty(N, device="meta")
    before = (fn.launches, fn.simt_launches)
    out = fn(x, w, targets, lse, g, 0.1, 50)
    assert launched == [(want, dw, 0.1, 0.1 / 50, torch.int32, torch.float32, torch.float32)]
    assert (fn.launches - before[0], fn.simt_launches - before[1]) == ((1, 0) if want == "wgmma" else (0, 1))
    assert out.shape == (V if dw else N, D) and out.dtype == dtype


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_cpu_wrappers_run_the_plain_versions(wrapper):
    """CPU tensors take the plain versions: no launch is counted on either
    route and nothing is built."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(0.1 * rng.standard_normal((V, 64)).astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(rng.integers(0, V, N))
    lse = fc.fused_ce_fwd_reference(x, w, t)[0]
    g = torch.full((N,), 1.0 / N)
    fn, _ = WRAPPERS[wrapper]
    plain = getattr(fc, wrapper + "_reference")
    before = (fn.launches, fn.simt_launches)
    assert torch.equal(fn(x, w, t, lse, g), plain(x, w, t, lse, g))
    assert (fn.launches, fn.simt_launches) == before
    assert fc._LIB is None


# --------------------------------------------------------------------------
# The tensor-core kernels' arithmetic, emulated


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _emulated(x, w, t, lse, g, eps, denom, split):
    """dx and dW as the tensor-core kernels form them from fp32 operands that
    hold bf16 values: z in fp32, dlog in the reference's rounding order,
    then dlog as bf16 hi + bf16 lo (``split``) or as one bf16 value, each
    product exact in fp32 and summed in fp32."""
    z = x @ w.t()
    p = torch.exp(z - lse[:, None])
    cols = torch.arange(w.shape[0])
    tm = (cols[None, :] == t[:, None]).float()
    if eps:
        tm = (1.0 - eps) * tm + eps / (denom or w.shape[0])
    dlog = (p - tm) * g[:, None]
    hi = _bf16(dlog)
    parts = [hi, _bf16(dlog - hi)] if split else [hi]
    return sum(d @ w for d in parts), sum(d.t() @ x for d in parts)


@pytest.mark.parametrize("eps,denom", [(0.0, None), (0.1, 333)], ids=["plain", "smoothing"])
def test_hi_lo_split_keeps_the_fp32_dlog(eps, denom):
    """With dlog carried as a bf16 hi/lo pair the emulated kernel agrees with
    the plain versions (fp32 dlog, fp32 products) to 2^-15 of the largest
    value; with dlog rounded once to bf16 it misses that bound."""
    rng = np.random.default_rng(7)
    n, v, d = 64, 300, 96
    x = _bf16(torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)))
    w = _bf16(torch.from_numpy(0.5 * rng.standard_normal((v, d)).astype(np.float32)))
    t = torch.from_numpy(rng.integers(0, v, n))
    g = torch.from_numpy(rng.random(n).astype(np.float32))
    lse = fc.fused_ce_fwd_reference(x, w, t, eps)[0]
    want = (fc.fused_ce_bwd_dx_reference(x, w, t, lse, g, eps, denom, block_v=v),
            fc.fused_ce_bwd_dw_reference(x, w, t, lse, g, eps, denom, block_v=v))
    assert all(a.dtype == torch.float32 for a in want)
    for split, within in ((True, True), (False, False)):
        got = _emulated(x, w, t, lse, g, eps, denom, split)
        for a, b in zip(got, want):
            err = float((a - b).abs().max()) / float(b.abs().max())
            assert (err <= 2.0**-15) == within, (split, err)


@pytest.mark.parametrize("owned,walked,clusters", [
    (2048, 50257, 39), (32768, 50257, 39), (50257, 2048, 39), (50257, 32768, 39), (1000, 50257, 15),
    (1000, 200, 132), (2048, 200, 39), (128, 64, 1),
])
def test_cluster_chunks_fill_the_card(owned, walked, clusters):
    """The tensor-core grid's walk chunks: they cover every walked tile, are
    no more than 16, and are the fewest that fill 85% of the last wave of
    co-resident clusters (one chunk, and no fp32 partials, wherever the owned
    blocks alone do so, as at the capacity path's N 32768)."""
    per, chunks = fc._cluster_chunks(owned, walked, clusters)
    tiles = -(-walked // 64)
    blocks = -(-owned // 128)
    assert 1 <= chunks <= 16 and (chunks - 1) * per < tiles <= chunks * per

    def fill(c):
        return blocks * c / (-(-blocks * c // clusters) * clusters)

    if fill(1) >= 0.85:
        assert chunks == 1
    elif any(fill(c) >= 0.85 for c in range(1, min(16, tiles) + 1)):
        assert fill(chunks) >= 0.85 and all(fill(c) < 0.85 for c in range(1, chunks))
