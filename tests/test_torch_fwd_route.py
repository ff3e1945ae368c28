"""Routing of the port's two forward kernels with a tensor-core form: the
flash-attention forward (``ops/flash_attention.py``, plain and ids mode,
``csrc/flash_fwd.cu``) and the fused cross-entropy forward
(``ops/fused_ce.py``, ``csrc/fused_ce.cu``).

The flash forward shares ``_route`` with the backward: ``"wgmma"`` (tensor
cores fed by TMA) for fp16 and bf16 with hd 64, 16-byte aligned bases and
batch, row and head strides that are positive multiples of 16 bytes, and
``"simt"`` (the CUDA cores) for the rest. The CE forward's ``_fwd_route``:
``"wgmma"`` for bf16 or fp16 x and w, contiguous, D a multiple of 8 on
16-byte aligned bases. On the CPU the wrappers' card branch is driven with
meta tensors through the ``_is_cuda`` seam and a recording launch: each
launch counts on its route's counter. CPU tensors still run the plain
versions and build nothing. The tensor-core CE forward's vocabulary chunks
(``_fwd_chunks``) fill the card at the training microbatch's and the
capacity path's N. The kernels themselves are held against the plain
versions and the CUDA-core route on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase B), and the
plain versions against the JAX package in ``tests/test_torch_flash_attention.py``,
``tests/test_torch_flash_ids.py`` and ``tests/test_torch_fused_ce.py``.
"""

import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa
from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fc

B, T, H = 2, 8, 3
N, V = 24, 40


def _bthd(dtype, hd, pad=0, offset=0, L=T):
    """A [B, L, H, hd] tensor whose head rows are hd + pad elements apart and
    whose first element sits ``offset`` elements into its storage."""
    base = torch.zeros(offset + B * L * H * (hd + pad), dtype=dtype)
    x = base[offset:].view(B, L, H, hd + pad)[..., :hd]
    assert x.stride(-1) == 1
    return x


# --------------------------------------------------------------------------
# The flash forward


@pytest.mark.parametrize("dtype,hd,pad,offset,want", [
    (torch.bfloat16, 64, 0, 0, "wgmma"),
    (torch.float16, 64, 0, 0, "wgmma"),
    (torch.float32, 64, 0, 0, "simt"),    # no TF32 in the contract
    (torch.bfloat16, 48, 0, 0, "simt"),   # a head dim the tensor-core kernel does not take
    (torch.bfloat16, 128, 0, 0, "simt"),
    (torch.float16, 256, 0, 0, "simt"),
    (torch.bfloat16, 64, 8, 0, "wgmma"),  # rows 144 bytes apart: a multiple of 16
    (torch.bfloat16, 64, 4, 0, "simt"),   # rows 136 bytes apart
    (torch.bfloat16, 64, 0, 1, "simt"),   # a base 2 bytes off 16
    (torch.float16, 64, 0, 8, "wgmma"),   # a base 16 bytes on
], ids=lambda v: str(v).removeprefix("torch."))
def test_flash_fwd_route_by_dtype_head_dim_alignment_and_strides(dtype, hd, pad, offset, want):
    q = _bthd(dtype, hd, pad, offset)
    k, v = (_bthd(dtype, hd) for _ in range(2))
    assert fa._route(q, k, v) == want
    assert fa._route(k, q, v) == want and fa._route(k, v, q) == want  # any of the three operands


def test_flash_fwd_route_takes_views_into_a_fused_qkv_output():
    """q, k and v as the attention layers cut them from one [N, 3D] fused
    QKV output: rows 3D apart, k and v D elements into the buffer."""
    D = H * 64
    qkv = torch.zeros(B * T, 3 * D, dtype=torch.bfloat16)
    q, k, v = (qkv[:, i * D:(i + 1) * D].view(B, T, H, 64) for i in range(3))
    assert q.stride() == (T * 3 * D, 3 * D, 64, 1)
    assert fa._route(q, k, v) == "wgmma"
    assert fa._route(qkv[:, 1:D + 1].view(B, T, H, 64), k, v) == "simt"  # 2 bytes off


def test_flash_fwd_route_refuses_a_broadcast_batch_and_empty_operands():
    x = _bthd(torch.bfloat16, 64)[:1].expand(B, T, H, 64)
    assert x.stride(0) == 0
    assert fa._route(x, x, x) == "simt"
    q = _bthd(torch.bfloat16, 64)
    assert fa._route(q, q[:, :0], q[:, :0]) == "simt"  # S = 0: nothing for TMA to read


def _meta(dtype, hd, L=T):
    return torch.empty(B, L, H, hd, dtype=dtype, device="meta")


FLASH_CALLS = {
    "flash_attention": lambda q, k, v: fa.flash_attention(q, k, v),
    "flash_fwd_with_ids": lambda q, k, v: fa.flash_fwd_with_ids(
        q, k, v, None, torch.arange(T, device="meta"), torch.arange(T, device="meta"), scale=0.125, causal=True),
}


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.float16, 64, "wgmma"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 48, "simt"), (torch.float16, 128, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
@pytest.mark.parametrize("wrapper", sorted(FLASH_CALLS))
def test_flash_fwd_launches_counted_by_route(monkeypatch, wrapper, dtype, hd, want):
    """Through the ``_is_cuda`` seam (meta tensors stand in for the card's):
    one launch of ``_route``'s kernel through ``smp_flash_fwd``, counted in
    ``.launches`` on the tensor-core route and in ``.simt_launches`` on the
    CUDA-core route; o comes back in q's dtype (fp32 in ids mode) and lse
    as fp32 [B, H, T]."""
    launched = []
    monkeypatch.setattr(fa, "_is_cuda", lambda t: True)
    monkeypatch.setattr(fa, "_launch", lambda route, kernel, device, args: launched.append((route, kernel)))
    fn = getattr(fa, wrapper)
    q, k, v = (_meta(dtype, hd) for _ in range(3))
    before = (fn.launches, fn.simt_launches)
    o, lse = FLASH_CALLS[wrapper](q, k, v)
    assert launched == [(want, "flash_fwd")]
    assert (fn.launches - before[0], fn.simt_launches - before[1]) == ((1, 0) if want == "wgmma" else (0, 1))
    assert o.shape == q.shape and o.dtype == (torch.float32 if wrapper.endswith("_ids") else dtype)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32


def test_flash_fwd_launch_passes_the_route_and_views_as_they_lie(monkeypatch):
    """A fused-QKV view reaches the kernel with its own strides (no copy):
    the launch gets the batch, row and head strides of the [N, 3D] buffer."""
    launched = []
    monkeypatch.setattr(fa, "_is_cuda", lambda t: True)
    monkeypatch.setattr(fa, "_launch", lambda route, kernel, device, args: launched.append((route, args)))
    D = H * 64
    qkv = torch.empty(B * T, 3 * D, dtype=torch.bfloat16, device="meta")
    q, k, v = (qkv[:, i * D:(i + 1) * D].view(B, T, H, 64) for i in range(3))
    fa.flash_attention(q, k, v)
    (route, args), = launched
    assert route == "wgmma"
    strides = args[14:23]  # after dtype, 8 pointers and B, T, S, H, hd
    assert strides == (T * 3 * D, 3 * D, 64) * 3


@pytest.mark.parametrize("wrapper", sorted(FLASH_CALLS))
def test_flash_fwd_cpu_wrappers_run_the_plain_versions(wrapper):
    """CPU tensors take the plain versions: no launch is counted on either
    route and nothing is built."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, 64)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    fn = getattr(fa, wrapper)
    before = (fn.launches, fn.simt_launches)
    if wrapper.endswith("_ids"):
        ids = torch.arange(T)
        got = fn(q, k, v, None, ids, ids, scale=0.125, causal=True)
        want = fa.flash_fwd_with_ids_reference(q, k, v, None, ids, ids, scale=0.125, causal=True)
    else:
        got, want = fn(q, k, v), fa.flash_attention_reference(q, k, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.simt_launches) == before
    assert fa._LIB is None


# --------------------------------------------------------------------------
# The fused cross-entropy forward


def _operand(rows, D, dtype, offset=0):
    """A contiguous [rows, D] tensor whose first element sits ``offset``
    elements into its storage."""
    return torch.zeros(offset + rows * D, dtype=dtype)[offset:].view(rows, D)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "wgmma"),
    (torch.float16, "wgmma"),  # no dlog in the forward: fp16's range is enough
    (torch.float32, "simt"),   # no TF32 in the contract
], ids=lambda v: str(v).removeprefix("torch."))
def test_ce_fwd_route_by_dtype(dtype, want):
    assert fc._fwd_route(_operand(N, 64, dtype), _operand(V, 64, dtype)) == want


@pytest.mark.parametrize("D,want", [
    (8, "wgmma"), (64, "wgmma"), (768, "wgmma"), (1600, "wgmma"), (4096, "wgmma"),  # D is the K loop: no bound
    (12, "simt"),  # rows of 24 bytes: not a multiple of 16
    (33, "simt"),
])
def test_ce_fwd_route_by_width(D, want):
    assert fc._fwd_route(_operand(N, D, torch.bfloat16), _operand(V, D, torch.bfloat16)) == want


@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("offset,want", [(1, "simt"), (8, "wgmma")])  # 2 bytes off 16, 16 bytes on
def test_ce_fwd_route_by_alignment(which, offset, want):
    x, w = _operand(N, 64, torch.float16), _operand(V, 64, torch.float16)
    if which == "x":
        x = _operand(N, 64, torch.float16, offset)
    else:
        w = _operand(V, 64, torch.float16, offset)
    assert fc._fwd_route(x, w) == want


def test_ce_fwd_route_refuses_strided_and_mixed_operands():
    x = _operand(N, 128, torch.bfloat16)[:, :64]
    assert not x.is_contiguous()
    assert fc._fwd_route(x, _operand(V, 64, torch.bfloat16)) == "simt"
    assert fc._fwd_route(_operand(N, 64, torch.bfloat16), _operand(V, 64, torch.float16)) == "simt"


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 768, "wgmma"), (torch.float16, 768, "wgmma"), (torch.bfloat16, 1600, "wgmma"),
    (torch.float32, 768, "simt"), (torch.bfloat16, 12, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
@pytest.mark.parametrize("smoothing", [0.0, 0.1], ids=["plain", "smoothing"])
def test_ce_fwd_launches_counted_by_route(monkeypatch, dtype, D, want, smoothing):
    """Through the ``_is_cuda`` seam (meta tensors stand in for the card's):
    one launch of ``_fwd_route``'s kernel, counted in ``.launches`` on the
    tensor-core route and in ``.simt_launches`` on the CUDA-core route, with
    int32 targets; lse and tgt come back as fp32 [N], the logit sum only
    under smoothing."""
    launched = []
    monkeypatch.setattr(fc, "_is_cuda", lambda t: True)
    monkeypatch.setattr(fc, "_fwd_launch", lambda route, x, w, t, lse, tgt, lsum: launched.append(
        (route, t.dtype, lsum is None)))
    x, w = (torch.empty(rows, D, dtype=dtype, device="meta") for rows in (N, V))
    targets = torch.empty(N, dtype=torch.long, device="meta")
    before = (fc.fused_ce_fwd.launches, fc.fused_ce_fwd.simt_launches)
    lse, tgt, lsum = fc.fused_ce_fwd(x, w, targets, smoothing)
    assert launched == [(want, torch.int32, not smoothing)]
    moved = (fc.fused_ce_fwd.launches - before[0], fc.fused_ce_fwd.simt_launches - before[1])
    assert moved == ((1, 0) if want == "wgmma" else (0, 1))
    assert lse.shape == tgt.shape == (N,) and lse.dtype == tgt.dtype == torch.float32
    assert (lsum is None) == (not smoothing)


def test_ce_fwd_cpu_wrapper_runs_the_plain_version():
    """CPU tensors take the plain version: no launch is counted on either
    route and nothing is built."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, 64)).astype(np.float32)).to(torch.float16)
    w = torch.from_numpy(0.1 * rng.standard_normal((V, 64)).astype(np.float32)).to(torch.float16)
    t = torch.from_numpy(rng.integers(0, V, N))
    before = (fc.fused_ce_fwd.launches, fc.fused_ce_fwd.simt_launches)
    got, want = fc.fused_ce_fwd(x, w, t, 0.1), fc.fused_ce_fwd_reference(x, w, t, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fc.fused_ce_fwd.launches, fc.fused_ce_fwd.simt_launches) == before
    assert fc._LIB is None


@pytest.mark.parametrize("n,v,sms,want", [
    (2048, 50257, 132, (25, 8)),   # the training microbatch: 16 row blocks x 8 chunks = 128 CTAs, one wave
    (32768, 50257, 132, (197, 1)),  # the capacity path: 256 row blocks fill two waves alone
    (1000, 200, 132, (1, 1)),       # one vocab tile: nothing to split
    (128, 50257, 132, (13, 16)),    # one row block: 16 chunks at most
])
def test_ce_fwd_chunks_fill_the_card(n, v, sms, want):
    """The tensor-core forward's vocabulary chunks: 256-wide tiles, one CTA
    per (128 rows, chunk) and one CTA an SM; they cover every tile, are no
    more than 16, and are the fewest that fill 85% of the last wave (one
    chunk wherever the row blocks alone do, as at N 32768)."""
    per, chunks = fc._fwd_chunks(n, v, sms)
    assert (per, chunks) == want
    tiles, blocks = -(-v // 256), -(-n // 128)
    assert 1 <= chunks <= 16 and (chunks - 1) * per < tiles <= chunks * per
    if chunks > 1 and chunks < min(16, tiles):
        assert blocks * chunks / (-(-blocks * chunks // sms) * sms) >= 0.85
