"""Routing of the port's flash-attention backward (``ops/flash_attention.py``)
between its two kernels in ``csrc/flash_bwd.cu``.

``_route`` picks the tensor-core kernels (``"wgmma"``, fed by TMA) for fp16
and bf16 operands with hd 64, 16-byte aligned bases and batch, row and head
strides that are positive multiples of 16 bytes, and the CUDA-core kernels
(``"simt"``) for the rest. On the CPU the wrappers' card branch is driven with
meta tensors through the ``_is_cuda`` seam and a recording ``_launch``: each
launch counts on its route's counter, in plain and in ids mode. CPU tensors
still run the plain versions and build nothing. The kernels themselves are
held against the plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py`` phase B), and the plain versions against the JAX package in
``tests/test_torch_flash_attention_bwd.py`` and ``tests/test_torch_flash_ids.py``.
"""

import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa

B, T, H = 2, 8, 3


def _bthd(dtype, hd, pad=0, offset=0, L=T):
    """A [B, L, H, hd] tensor whose head rows are hd + pad elements apart and
    whose first element sits ``offset`` elements into its storage."""
    base = torch.zeros(offset + B * L * H * (hd + pad), dtype=dtype)
    x = base[offset:].view(B, L, H, hd + pad)[..., :hd]
    assert x.stride(-1) == 1
    return x


@pytest.mark.parametrize("dtype,hd,pad,offset,want", [
    (torch.bfloat16, 64, 0, 0, "wgmma"),
    (torch.float16, 64, 0, 0, "wgmma"),
    (torch.float32, 64, 0, 0, "simt"),    # no TF32 in the contract
    (torch.bfloat16, 48, 0, 0, "simt"),   # a head dim the tensor-core kernels do not take
    (torch.bfloat16, 128, 0, 0, "simt"),
    (torch.float16, 256, 0, 0, "simt"),
    (torch.bfloat16, 64, 8, 0, "wgmma"),  # rows 144 bytes apart: a multiple of 16
    (torch.bfloat16, 64, 4, 0, "simt"),   # rows 136 bytes apart
    (torch.bfloat16, 64, 0, 1, "simt"),   # a base 2 bytes off 16
    (torch.float16, 64, 0, 8, "wgmma"),   # a base 16 bytes on
], ids=lambda v: str(v).removeprefix("torch."))
def test_route_by_dtype_head_dim_alignment_and_strides(dtype, hd, pad, offset, want):
    q = _bthd(dtype, hd, pad, offset)
    k, v, do = (_bthd(dtype, hd) for _ in range(3))
    assert fa._route(q, k, v, do) == want
    assert fa._route(k, q, v, do) == want and fa._route(k, v, do, q) == want  # any of the four operands


def test_route_takes_views_into_a_fused_qkv_output():
    """q, k and v as the attention layers cut them from one [N, 3D] fused
    QKV output: rows 3D apart, k and v D elements into the buffer."""
    D = H * 64
    qkv = torch.zeros(B * T, 3 * D, dtype=torch.bfloat16)
    q, k, v = (qkv[:, i * D:(i + 1) * D].view(B, T, H, 64) for i in range(3))
    assert q.stride() == (T * 3 * D, 3 * D, 64, 1)
    do = torch.zeros(B, T, H, 64, dtype=torch.bfloat16)
    assert fa._route(q, k, v, do) == "wgmma"
    assert fa._route(qkv[:, 1:D + 1].view(B, T, H, 64), k, v, do) == "simt"  # 2 bytes off


def test_route_refuses_a_broadcast_batch():
    x = _bthd(torch.bfloat16, 64)[:1].expand(B, T, H, 64)
    assert x.stride(0) == 0
    assert fa._route(x, x, x, x) == "simt"


def _meta(dtype, hd, L=T):
    return torch.empty(B, L, H, hd, dtype=dtype, device="meta")


CALLS = {
    "flash_bwd_dq": lambda q, k, v, do, lse, delta: fa.flash_bwd_dq(q, k, v, do, lse, delta),
    "flash_bwd_dkv": lambda q, k, v, do, lse, delta: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
    "flash_bwd_dq_ids": lambda q, k, v, do, lse, delta: fa.flash_bwd_dq_ids(
        q, k, v, do, lse, delta, None, torch.arange(T, device="meta"), torch.arange(T, device="meta"),
        scale=0.125, causal=True),
    "flash_bwd_dkv_ids": lambda q, k, v, do, lse, delta: fa.flash_bwd_dkv_ids(
        q, k, v, do, lse, delta, None, torch.arange(T, device="meta"), torch.arange(T, device="meta"),
        scale=0.125, causal=True),
}


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.float16, 64, "wgmma"), (torch.float32, 64, "simt"),
    (torch.bfloat16, 48, "simt"),
], ids=lambda v: str(v).removeprefix("torch."))
@pytest.mark.parametrize("wrapper", sorted(CALLS))
def test_launches_counted_by_route(monkeypatch, wrapper, dtype, hd, want):
    """Through the ``_is_cuda`` seam (meta tensors stand in for the card's):
    one launch of ``_route``'s kernel through the C entry the wrapper names,
    counted in ``.launches`` on the tensor-core route and in
    ``.simt_launches`` on the CUDA-core route; the outputs come back in the
    input dtype, or in fp32 in ids mode."""
    launched = []
    monkeypatch.setattr(fa, "_is_cuda", lambda t: True)
    monkeypatch.setattr(fa, "_launch", lambda route, kernel, device, args: launched.append((route, kernel)))
    fn = getattr(fa, wrapper)
    q, k, v, do = (_meta(dtype, hd) for _ in range(4))
    lse = delta = torch.empty(B, H, T, device="meta")
    before = (fn.launches, fn.simt_launches)
    outs = CALLS[wrapper](q, k, v, do, lse, delta)
    outs = outs if isinstance(outs, tuple) else (outs,)
    kernel = "flash_bwd_dq" if "_dq" in wrapper else "flash_bwd_dkv"
    assert launched == [(want, kernel)]
    assert (fn.launches - before[0], fn.simt_launches - before[1]) == ((1, 0) if want == "wgmma" else (0, 1))
    out_dtype = torch.float32 if wrapper.endswith("_ids") else dtype
    assert all(o.shape == q.shape and o.dtype == out_dtype for o in outs)


@pytest.mark.parametrize("wrapper", sorted(CALLS))
def test_cpu_wrappers_run_the_plain_versions(wrapper):
    """CPU tensors take the plain versions: no launch is counted on either
    route and nothing is built."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H, 64)).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_reference(q, k, v)
    delta = fa.attention_delta(o, do)
    fn = getattr(fa, wrapper)
    before = (fn.launches, fn.simt_launches)
    if wrapper.endswith("_ids"):
        ids = torch.arange(T)
        args, kw = (q, k, v, do, lse, delta, None, ids, ids), dict(scale=0.125, causal=True)
        plain = getattr(fa, wrapper + "_reference")
    else:
        args, kw = (q, k, v, do, lse, delta), {}
        plain = getattr(fa, wrapper + "_reference")
    got, want = fn(*args, **kw), plain(*args, **kw)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fn.launches, fn.simt_launches) == before
    assert fa._BWD_LIB is None
