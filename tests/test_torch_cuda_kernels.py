"""Card-only tests of the port's CUDA kernels (marked ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card. On the card
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX; these
tests need none):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Each kernel is held against its plain PyTorch version, which the CPU tests
hold against the JAX package. Tolerances: fp32 runs the same arithmetic,
summation order and online softmax aside, so 1e-4; bf16 rounds P to bf16
against different row maxima, so O to 2e-2 while LSE (fp32) stays 1e-3.
The flash forward has a tensor-core kernel (fp16 and bf16 at hd 64) and a
CUDA-core kernel, in plain and ids mode: on chip_smoke's cases, ragged
lengths and fused-QKV views the tensor cores agree with the plain version
(chip_smoke's ``TOL``), with the CUDA-core kernel forced on the same inputs
and with a repeat launch (``fwd_check``). So does the CE forward, in bf16
and fp16 (``_ce_compare``).
The backward kernels: fp32 1e-4 and bf16 2e-2 of the largest gradient
(ds and p are rounded to bf16 after fp32 products summed in another order).
The fused cross-entropy kernels: the forward statistics (fp32 in both
dtypes) 1e-4 of the largest value; dx and dW 1e-4 (fp32) and 2e-2 (bf16,
where they come back rounded) of the largest value; the cases, their inputs
and these tolerances are ``chip_smoke.py``'s phase B sweep. Its backward has
a tensor-core kernel (bf16) and a CUDA-core kernel for each of dx and dW:
in bf16 every case runs on the tensor cores, agrees with the CUDA-core
kernels forced on the same inputs (``CE_SIMT_TOL``) and repeats bit for bit
(``_ce_compare``). So are those of
``matmul_bias`` and the two ``bias_gelu`` wrappers (``MB_CASES``,
``GELU_CASES``, ``mb_compare``, ``gelu_compare``; tolerances stated there;
the bias-GELU pair on its "vec" route or, for a ragged row or an unaligned
base, "simt", y and dx per element and db within ``gelu_db_tol``, repeats
bit-equal; an out-of-range target on the materialized head)
and of ``matmul_fp8`` (``FP8_CASES``, ``fp8_inputs``, ``fp8_compare``: each
element within the fp32 summation-order bound of its own). Both matrix
products have a tensor-core and a CUDA-core kernel; the comparisons hold
the route each case took to ``_route``'s, the ragged shapes reach the
tensor cores, and the two routes agree on the same inputs. So do the flash
backward's (``bwd_check``): its tensor-core kernels at hd 64 in bf16 and fp16,
plain and ids mode, on chip_smoke's cases and ragged lengths, against the
plain version, the CUDA-core kernels and a repeat launch (equal bits). The fp8 casts on
the card equal the CPU's bit for bit, and one fp32 step of the smp.nn model
under ``matmul_precision: fp8`` agrees with the CPU's. The ids-mode flash
kernels (one pair of a context-parallel ring step) run ``chip_smoke.py``'s
``IDS_CASES`` (``ids_inputs``, ``ids_compare``; the flash tolerances above,
the outputs fp32), and cp = 2 attention in two ranks on the card agrees with
full attention on the CPU.
"""

import copy

import numpy as np
import pytest
import torch

import smdistributed_modelparallel_tpu_torch as smp_torch
from chip_smoke import (
    BWD_TOL as SMOKE_BWD_TOL,
    CASES as SMOKE_CASES,
    CE_CASES,
    CE_TOL,
    TOL as SMOKE_TOL,
    _ce_compare,
    FP8_CASES,
    GELU_CASES,
    IDS_CASES,
    MB_CASES,
    MB_TOL,
    ce_inputs,
    fp8_bound,
    fp8_compare,
    fp8_inputs,
    gelu_compare,
    gelu_db_tol,
    gelu_inputs,
    bwd_check,
    flash_route,
    fwd_check,
    ids_compare,
    ids_inputs,
    mb_compare,
    mb_inputs,
    run_ranks,
)
from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, init_gpt2_weights_
from smdistributed_modelparallel_tpu_torch.nn import cross_entropy as port_ce
from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead, init_weights_
from smdistributed_modelparallel_tpu_torch.nn import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.ops.attention import attention_core
from smdistributed_modelparallel_tpu_torch.ops.bias_gelu import bias_gelu, bias_gelu_bwd, bias_gelu_fwd
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg_mod
from smdistributed_modelparallel_tpu_torch.ops import fused_ce as ce_mod
from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa_mod
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb_mod
from smdistributed_modelparallel_tpu_torch.ops import matmul_fp8 as mf_mod
from smdistributed_modelparallel_tpu_torch.ops.matmul_bias import matmul_bias, matmul_bias_fwd
from smdistributed_modelparallel_tpu_torch.ops.matmul_fp8 import matmul_fp8
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from smdistributed_modelparallel_tpu_torch.ops.fused_ce import (
    fused_ce_bwd_dw,
    fused_ce_bwd_dw_reference,
    fused_ce_bwd_dx,
    fused_ce_bwd_dx_reference,
    fused_ce_fwd,
    fused_ce_fwd_reference,
    fused_lm_head_ce,
)

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}

# (B, T, S, H, hd, kwargs): every feature of the forward kernel.
CASES = {
    "causal_main_shape": (4, 512, 512, 12, 64, {}),
    "causal_t_lt_s": (2, 200, 333, 4, 64, {}),
    "causal_t_gt_s_sentinel_rows": (2, 300, 130, 4, 64, dict(block_q=128, block_k=128)),
    "non_causal": (2, 256, 384, 4, 64, dict(causal=False)),
    "causal_window": (2, 384, 384, 4, 64, dict(window=100, block_q=128, block_k=128)),
    "symmetric_window": (2, 256, 320, 4, 64, dict(causal=False, window=70, block_q=128, block_k=128)),
    "kpad_fully_padded_rows": (3, 160, 160, 4, 64, dict(kpad=True)),
    "dropout": (2, 256, 256, 4, 64, dict(dropout_rate=0.1, seed=-123456789)),
    "dropout_head_remap": (2, 256, 256, 4, 64, dict(dropout_rate=0.1, seed=77, head0=4, head_total=12,
                                                    counter_len=1000)),
    "hd128": (2, 256, 256, 4, 128, {}),
    "hd256_scale": (1, 128, 128, 2, 256, dict(scale=0.1)),
    "ragged_t200_hd48": (2, 200, 200, 4, 48, {}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    yield torch.device("cuda")
    smp_torch.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_fwd_matches_plain_version(cuda, case, dtype):
    B, T, S, H, hd, kw = CASES[case]
    kw = dict(kw)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, L, H, hd, generator=gen, device=cuda).to(dtype) for L in (T, S, S))
    if kw.pop("kpad", False):
        kpad = torch.zeros(B, S, device=cuda)
        kpad[1, :50] = -1e30  # left padding: rows < 50 see only pad keys
        kpad[2, :] = -1e30    # a fully padded sequence
        kw["kpad_bias"] = kpad
    counter = "launches" if flash_route(dtype, hd) == "wgmma" else "simt_launches"  # the route's count
    before = getattr(flash_attention, counter)
    o, lse = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_attention, counter) == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
    tol_o, tol_lse = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol_o)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=tol_lse)


@pytest.mark.cuda
def test_flash_fwd_rejects_what_it_cannot_run(cuda):
    q = torch.zeros(1, 128, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros(1, 128, 2, 320, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


def _fwd_case(name, dtype, cuda):
    """chip_smoke.CASES' case: (run, want, route, v_max, rate) for fwd_check."""
    _, B, T, S, H, hd, kw = next(c for c in SMOKE_CASES if c[0] == name)
    kw = dict(kw)
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(B, L, H, hd, generator=gen, device=cuda).to(dtype) for L in (T, S, S))
    if kw.pop("kpad", None):
        kpad = torch.zeros(B, S, device=cuda)
        kpad[1, :50] = -1e30  # left padding: rows < 50 see only pad keys
        kpad[2, :] = -1e30    # a fully padded sequence
        kw["kpad_bias"] = kpad
    want = flash_attention_reference(q, k, v, **kw)
    return (lambda: flash_attention(q, k, v, **kw)), want, flash_route(dtype, hd), float(v.float().abs().max()), \
        kw.get("dropout_rate", 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", [c[0] for c in SMOKE_CASES])
def test_flash_fwd_routes_agree_and_repeat_bit_equal(cuda, case, dtype):
    """Every chip_smoke case in bf16 and fp16 on ``_route``'s route: the
    tensor cores at hd 64 (fully-masked rows, windows, dropout, T != S and
    ragged lengths included), where the kernel agrees with the CUDA-core
    kernel forced on the same inputs (FWD_SIMT_ULP, FWD_SIMT_LSE) and a
    second launch gives equal bits; the CUDA cores elsewhere. Both against
    the plain version (chip_smoke.TOL)."""
    run, want, route, v_max, rate = _fwd_case(case, dtype, cuda)
    _, ok, detail = fwd_check(run, want, flash_attention, route, dtype, SMOKE_TOL[dtype], v_max, rate)
    assert ok, detail


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", ["t1000", "t77_s130", "t65_s63", "t1_s200"])
def test_flash_fwd_tensor_cores_on_ragged_lengths(cuda, case, causal):
    """Partial first and last tiles on the tensor cores: T above and below S,
    one row past a tile, one row; K/V rows past S arrive from TMA as zeros
    and must not be visited."""
    B, T, S, H = RAGGED_BWD[case]
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(B, L, H, 64, generator=gen, device=cuda).to(torch.bfloat16) for L in (T, S, S))
    want = flash_attention_reference(q, k, v, causal=causal)
    _, ok, detail = fwd_check(lambda: flash_attention(q, k, v, causal=causal), want, flash_attention, "wgmma",
                              torch.bfloat16, SMOKE_TOL[torch.bfloat16], float(v.float().abs().max()))
    assert ok, detail


@pytest.mark.cuda
def test_flash_fwd_tensor_cores_read_fused_qkv_views(cuda):
    """q, k and v as views into one [B * T, 3 * H * 64] fused QKV output (rows
    3 H 64 apart, k and v offset into the row) take the tensor cores as they
    lie and agree with the plain version on contiguous copies."""
    B, T, H = 2, 300, 12
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(B * T, 3 * H * 64, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, i * H * 64:(i + 1) * H * 64].view(B, T, H, 64) for i in range(3))
    assert fa_mod._route(q, k, v) == "wgmma" and not q.is_contiguous()
    want = flash_attention_reference(*(x.contiguous() for x in (q, k, v)))
    _, ok, detail = fwd_check(lambda: flash_attention(q, k, v), want, flash_attention, "wgmma", torch.bfloat16,
                              SMOKE_TOL[torch.bfloat16], float(v.float().abs().max()))
    assert ok, detail


@pytest.mark.cuda
def test_flash_fwd_tensor_core_route_refuses_what_it_cannot_run(cuda, monkeypatch):
    """Forced onto the tensor cores, fp32 and hd 128 are refused by the
    kernel's entry and the wrapper raises: no route stands in for the other."""
    monkeypatch.setattr(fa_mod, "_route", lambda *a: "wgmma")
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 128)):
        q = torch.zeros(1, 128, 2, hd, device=cuda, dtype=dtype)
        with pytest.raises(RuntimeError, match="wgmma"):
            flash_attention(q, q, q)


@pytest.mark.cuda
def test_generate_on_card_matches_cpu(cuda):
    """fp32 greedy generation: the card (flash kernel in the prefill) and the
    CPU (plain path) give the same tokens from the same weights."""
    smp_torch.init({})
    module = init_gpt2_weights_(
        gpt2("gpt2_124m", vocab_size=97, max_len=256, d_model=64, n_layers=2, n_heads=4),
        torch.Generator().manual_seed(0), std=0.5,
    )
    ids = torch.randint(0, 97, (2, 160), generator=torch.Generator().manual_seed(1))
    want = smp_torch.generate(module, ids, 8, params=module.state_dict())
    gpu = smp_torch.DistributedModel(module, device=cuda)
    before = flash_attention.simt_launches
    got = smp_torch.generate(gpu, ids, 8).cpu()
    assert flash_attention.simt_launches == before + 2  # one per layer, prefill only; fp32: the CUDA cores
    assert torch.equal(got, want)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bwd_matches_plain_version(cuda, case, dtype):
    """dq, dk and dv of the two backward kernels against the plain backward,
    from the plain forward's O and LSE."""
    B, T, S, H, hd, kw = CASES[case]
    kw = dict(kw)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(B, L, H, hd, generator=gen, device=cuda).to(dtype) for L in (T, S, S, T))
    if kw.pop("kpad", False):
        kpad = torch.zeros(B, S, device=cuda)
        kpad[1, :50] = -1e30
        kpad[2, :] = -1e30
        kw["kpad_bias"] = kpad
    o, lse = flash_attention_reference(q, k, v, **kw)
    delta = attention_delta(o, do)
    counter = "launches" if flash_route(dtype, hd) == "wgmma" else "simt_launches"  # the route's count
    before = (getattr(flash_bwd_dq, counter), getattr(flash_bwd_dkv, counter))
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (getattr(flash_bwd_dq, counter), getattr(flash_bwd_dkv, counter)) == (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_reference(q, k, v, o, do, lse, **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(ref.float().abs().max()), (name, err)


def _bwd_case(name, dtype, cuda):
    """chip_smoke.CASES' case: (run, want, route, tol) for bwd_check."""
    _, B, T, S, H, hd, kw = next(c for c in SMOKE_CASES if c[0] == name)
    kw = dict(kw)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(B, L, H, hd, generator=gen, device=cuda).to(dtype) for L in (T, S, S, T))
    if kw.pop("kpad", None):
        kpad = torch.zeros(B, S, device=cuda)
        kpad[1, :50] = -1e30
        kpad[2, :] = -1e30
        kw["kpad_bias"] = kpad
    o, lse = flash_attention_reference(q, k, v, **kw)
    delta = attention_delta(o, do)
    want = flash_attention_bwd_reference(q, k, v, o, do, lse, **kw)

    def run():
        return (flash_bwd_dq(q, k, v, do, lse, delta, **kw),) + flash_bwd_dkv(q, k, v, do, lse, delta, **kw)

    return run, want, flash_route(dtype, hd), SMOKE_BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", [c[0] for c in SMOKE_CASES])
def test_flash_bwd_routes_agree_and_repeat_bit_equal(cuda, case, dtype):
    """Every chip_smoke case in bf16 and fp16 on ``_route``'s route: the
    tensor cores at hd 64, where the kernels agree with the CUDA-core kernels
    forced on the same inputs and a second launch gives equal bits; the CUDA
    cores elsewhere. Both against the plain version (BWD_TOL)."""
    run, want, route, tol = _bwd_case(case, dtype, cuda)
    _, ok, detail = bwd_check(run, want, (flash_bwd_dq, flash_bwd_dkv), route, tol)
    assert ok, detail


# Ragged lengths on the tensor cores: partial first and last tiles, T above
# and below S, one row past a tile.
RAGGED_BWD = {"t1000": (1, 1000, 1000, 2), "t77_s130": (2, 77, 130, 3), "t65_s63": (2, 65, 63, 2),
              "t1_s200": (1, 1, 200, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", sorted(RAGGED_BWD))
def test_flash_bwd_tensor_cores_on_ragged_lengths(cuda, case, causal):
    B, T, S, H = RAGGED_BWD[case]
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(B, L, H, 64, generator=gen, device=cuda).to(torch.bfloat16) for L in (T, S, S, T))
    o, lse = flash_attention_reference(q, k, v, causal=causal)
    delta = attention_delta(o, do)
    want = flash_attention_bwd_reference(q, k, v, o, do, lse, causal=causal)
    run = lambda: (flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),) + flash_bwd_dkv(  # noqa: E731
        q, k, v, do, lse, delta, causal=causal)
    _, ok, detail = bwd_check(run, want, (flash_bwd_dq, flash_bwd_dkv), "wgmma", SMOKE_BWD_TOL[torch.bfloat16])
    assert ok, detail


@pytest.mark.cuda
def test_flash_bwd_tensor_core_route_refuses_what_it_cannot_run(cuda, monkeypatch):
    """Forced onto the tensor cores, fp32 and hd 128 are refused by the
    kernel's entry and the wrapper raises: no route stands in for the other."""
    monkeypatch.setattr(fa_mod, "_route", lambda *a: "wgmma")
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 128)):
        q = torch.zeros(1, 128, 2, hd, device=cuda, dtype=dtype)
        lse = delta = torch.zeros(1, 2, 128, device=cuda)
        with pytest.raises(RuntimeError, match="wgmma"):
            flash_bwd_dq(q, q, q, q, lse, delta)
        with pytest.raises(RuntimeError, match="wgmma"):
            flash_bwd_dkv(q, q, q, q, lse, delta)


@pytest.mark.cuda
def test_attention_core_grad_through_kernels_matches_cpu(cuda):
    """No detached output: qkv.weight.grad through attention_core's kernel
    path (flash forward and backward kernels) equals the CPU path's."""
    torch.manual_seed(0)
    qkv = torch.nn.Linear(64, 3 * 64)
    x = torch.randn(2, 160, 64)

    def grad(device):
        lin = copy.deepcopy(qkv).to(device)
        q, k, v = lin(x.to(device)).split(64, dim=-1)
        out = attention_core(*(t.reshape(2, 160, 4, 16) for t in (q, k, v)))
        assert out.grad_fn is not None
        (out.float() ** 2).sum().backward()
        return lin.weight.grad.cpu()

    def count():  # fp32: the forward and the backward take the CUDA-core route
        return (flash_attention.simt_launches, flash_bwd_dq.simt_launches, flash_bwd_dkv.simt_launches)

    launches = count()
    got = grad(cuda)
    assert count() == tuple(n + 1 for n in launches)
    want = grad("cpu")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_attention_dropout_on_card_replays_in_backward(cuda):
    """attention_core's dropout reaches the kernels: with the seed its key
    gives (``bits(key, ())`` as int32) the forward and the gradient agree
    with the plain versions."""
    from smdistributed_modelparallel_tpu_torch.utils import random

    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 256, 4, 64, generator=gen, device=cuda).requires_grad_() for _ in range(3))
    key = random.key(1234)
    seed = random.to_int32(random.bits32(key))
    out = attention_core(q, k, v, dropout_rate=0.1, dropout_rng=key)
    out.sum().backward()
    o_ref, _ = flash_attention_reference(q.detach(), k.detach(), v.detach(), seed=seed, dropout_rate=0.1)
    torch.testing.assert_close(out.detach(), o_ref, rtol=0, atol=1e-4)
    assert torch.isfinite(q.grad).all() and q.grad.abs().max() > 0


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu(cuda):
    """One fp32 training step (loss mode, 2 microbatches, AdamW): the card
    (flash kernels, T = 128) and the CPU (plain path) agree."""
    small = init_gpt2_weights_(gpt2("gpt2_124m", vocab_size=97, max_len=128, d_model=64, n_layers=2, n_heads=4),
                               torch.Generator().manual_seed(0))
    ids = torch.randint(0, 97, (2, 128), generator=torch.Generator().manual_seed(1))
    results = {}
    for device in (cuda, "cpu"):
        smp_torch.init({"microbatches": 2}, device=device)
        model = smp_torch.DistributedModel(copy.deepcopy(small))
        opt = smp_torch.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8), model)

        @smp_torch.step
        def train_step(model, batch):
            tgt = torch.cat([batch[:, 1:], torch.full_like(batch[:, :1], -100)], dim=1)
            loss = model(batch, targets=tgt).sum() / (batch.shape[0] * (batch.shape[1] - 1))
            model.backward(loss)
            return loss

        loss = float(train_step(model, ids).reduce_mean())
        grads = {n: g.cpu() for n, g in model.grads.items()}
        opt.step()
        results[str(device)] = (loss, grads, {k: v.cpu() for k, v in model.state_dict().items()})
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = results["cuda"], results["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for name in g_cpu:
        torch.testing.assert_close(g_gpu[name], g_cpu[name], rtol=1e-4, atol=1e-6, msg=name)
        # AdamW's first step moves every parameter by ~lr (1e-3) whatever its
        # gradient's size, so a gradient that is zero but for rounding (the
        # key bias) may move either way: the update is held to 2 lr.
        torch.testing.assert_close(p_gpu[name], p_cpu[name], rtol=0, atol=2e-3, msg=name)


# Phase B's sweep of the fused cross-entropy kernels, one definition for
# both: {name: (N, V, D, kwargs)}.
CE_SWEEP = {name: (N, V, D, kw) for name, N, V, D, kw in CE_CASES}


def _ce_case(device, N, V, D, dtype, kw, seed=0):
    x, w, t, g = ce_inputs(N, V, D, dtype, torch.Generator(device=device).manual_seed(seed), kw)
    return x, w, t, g, float(kw.get("smoothing", 0.0)), kw.get("smooth_denom")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CE_SWEEP))
def test_fused_ce_kernels_match_plain_versions(cuda, case, dtype):
    N, V, D, kw = CE_SWEEP[case]
    x, w, t, g, eps, denom = _ce_case(cuda, N, V, D, dtype, kw)
    # The launches count on their route's counter: bf16 the tensor cores
    # (.launches), fp32 the CUDA cores (.simt_launches).
    counter = "launches" if dtype == torch.bfloat16 else "simt_launches"

    def count():
        return tuple(getattr(fn, counter) for fn in (fused_ce_fwd, fused_ce_bwd_dx, fused_ce_bwd_dw))

    before = count()
    stats = fused_ce_fwd(x, w, t, eps)
    torch.cuda.synchronize()
    want = fused_ce_fwd_reference(x, w, t, eps)
    for name, got, ref in zip(("lse", "tgt", "logit_sum"), stats, want):
        if ref is None:
            assert got is None
            continue
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * max(1.0, float(ref.abs().max())), (name, err)
    lse = want[0]
    dx = fused_ce_bwd_dx(x, w, t, lse, g, eps, denom)
    torch.cuda.synchronize()
    dw = fused_ce_bwd_dw(x, w, t, lse, g, eps, denom)
    torch.cuda.synchronize()
    assert count() == tuple(n + 1 for n in before)
    for name, got, ref in (("dx", dx, fused_ce_bwd_dx_reference(x, w, t, lse, g, eps, denom)),
                           ("dw", dw, fused_ce_bwd_dw_reference(x, w, t, lse, g, eps, denom))):
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max())
        assert err <= CE_TOL[dtype] * float(ref.float().abs().max()), (name, err)
    if kw.get("gzeros"):
        assert (dx[::5] == 0).all()


@pytest.mark.cuda
def test_fused_ce_kernels_reject_what_they_cannot_run(cuda):
    x = torch.zeros(8, 16, device=cuda, dtype=torch.float64)
    t = torch.zeros(8, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError):
        fused_ce_fwd(x, x, t)
    with pytest.raises(TypeError):
        fused_ce_fwd(x.float(), x.half(), t)
    with pytest.raises(ValueError):
        fused_ce_fwd(x.float(), torch.zeros(8, 15, device=cuda), t)


@pytest.mark.cuda
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_fused_ce_grads_through_kernels_match_cpu(cuda, label_smoothing):
    """fp32 per-token losses, x.grad and the table's grad through the three
    kernels (fused_ce: True on the card) against the CPU's materialized
    path, with ignored rows."""
    smp_torch.init({"fused_ce": True})
    N, V, D = 300, 1000, 96
    x, w, t, _, _, _ = _ce_case("cpu", N, V, D, torch.float32, {})
    t[::9] = -100
    runs = {}

    def count():  # fp32: every kernel takes the CUDA-core route
        return (fused_ce_fwd.simt_launches, fused_ce_bwd_dx.simt_launches, fused_ce_bwd_dw.simt_launches)

    before = count()
    for device in (cuda, "cpu"):
        h = x.reshape(3, 100, D).clone().to(device).requires_grad_()
        table = w.clone().to(device).requires_grad_()
        per = port_ce.fused_lm_head_cross_entropy(h, table, t.reshape(3, 100).to(device),
                                                  label_smoothing=label_smoothing)
        (per.sum() / N).backward()
        runs[str(device)] = (per.detach().cpu(), h.grad.cpu(), table.grad.cpu())
    assert count() == tuple(n + 1 for n in before)
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (runs["cuda"][0].reshape(-1)[::9] == 0).all()


@pytest.mark.cuda
def test_materialized_head_takes_out_of_range_targets(cuda):
    """Targets -100, -5 and V on CUDA tensors through the materialized head
    (fused_ce: False): no device-side assert; the losses and gradients are
    the CPU's (an out-of-range target's loss is its row's lse)."""
    smp_torch.init({"fused_ce": False})
    N, V, D = 64, 1000, 32
    x, w, t, _, _, _ = _ce_case("cpu", N, V, D, torch.float32, {})
    t[1], t[3], t[5] = -100, -5, V
    runs = {}
    for device in (cuda, "cpu"):
        h = x.clone().to(device).requires_grad_()
        table = w.clone().to(device).requires_grad_()
        per = port_ce.fused_lm_head_cross_entropy(h, table, t.to(device), ignore_index=-5)
        per.sum().backward()
        torch.cuda.synchronize()
        runs[str(device)] = (per.detach().cpu(), h.grad.cpu(), table.grad.cpu())
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert runs["cuda"][0][3] == 0 and runs["cuda"][0][1] > 0 and runs["cuda"][0][5] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CE_SWEEP))
def test_fused_ce_bwd_routes_agree_and_repeat_bit_equal(cuda, case):
    """Every chip_smoke CE case in bf16: dx and dW on the tensor cores,
    within CE_TOL of the plain version, within CE_SIMT_TOL of the CUDA-core
    kernels forced on the same inputs, and a second launch gives equal bits."""
    N, V, D, kw = CE_SWEEP[case]
    x, w, t, g, eps, denom = _ce_case(cuda, N, V, D, torch.bfloat16, kw, seed=2)
    for name, (_, ok, detail) in _ce_compare(x, w, t, g, eps, denom).items():
        assert ok, (name, detail)
        if name != "fused_ce_fwd":
            assert detail.startswith("route wgmma"), (name, detail)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(CE_SWEEP))
def test_fused_ce_fwd_routes_agree_and_repeat_bit_equal(cuda, case, dtype):
    """Every chip_smoke CE case (ragged N and V, smoothing, targets outside
    [0, V)) in bf16 and fp16: the forward on the tensor cores, within
    CE_FWD_TOL of the plain version and of the CUDA-core kernel forced on
    the same inputs, and a second launch gives equal bits."""
    N, V, D, kw = CE_SWEEP[case]
    x, w, t, g, eps, denom = _ce_case(cuda, N, V, D, dtype, kw, seed=3)
    (_, ok, detail), = _ce_compare(x, w, t, g, eps, denom, backward=False).values()
    assert ok, detail
    assert detail.startswith("route wgmma"), detail


@pytest.mark.cuda
def test_fused_ce_fwd_tensor_core_route_refuses_what_it_cannot_run(cuda, monkeypatch):
    """Forced onto the tensor cores, fp32 operands and a D that is not a
    multiple of 8 are refused by the kernel's entry and the wrapper raises."""
    monkeypatch.setattr(ce_mod, "_fwd_route", lambda *a: "wgmma")
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 12)):
        x = torch.zeros(64, D, device=cuda, dtype=dtype)
        w = torch.zeros(100, D, device=cuda, dtype=dtype)
        t = torch.zeros(64, dtype=torch.long, device=cuda)
        with pytest.raises(RuntimeError, match="wgmma"):
            fused_ce_fwd(x, w, t)


@pytest.mark.cuda
def test_fused_ce_bwd_tensor_core_route_refuses_what_it_cannot_run(cuda, monkeypatch):
    """Forced onto the tensor cores, fp16 and fp32 operands (and a D that is
    not a multiple of 8) are refused by the kernel's entry and the wrapper
    raises: no route stands in for the other."""
    monkeypatch.setattr(ce_mod, "_route", lambda *a: "wgmma")
    for dtype, D in ((torch.float16, 64), (torch.float32, 64), (torch.bfloat16, 12)):
        x = torch.zeros(64, D, device=cuda, dtype=dtype)
        w = torch.zeros(100, D, device=cuda, dtype=dtype)
        t = torch.zeros(64, dtype=torch.long, device=cuda)
        lse = g = torch.zeros(64, device=cuda)
        with pytest.raises(RuntimeError, match="wgmma"):
            fused_ce_bwd_dx(x, w, t, lse, g)
        with pytest.raises(RuntimeError, match="wgmma"):
            fused_ce_bwd_dw(x, w, t, lse, g)


@pytest.mark.cuda
def test_fused_lm_head_ce_mixed_dtypes_meet_in_the_wider(cuda):
    x, w, t, _, _, _ = _ce_case(cuda, 256, 500, 64, torch.float32, {})
    xb = x.to(torch.bfloat16).requires_grad_()
    wf = w.clone().requires_grad_()
    per = fused_lm_head_ce(xb, wf, t)
    per.sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and wf.grad.dtype == torch.float32
    want = fused_ce_fwd_reference(xb.detach().float(), w, t)
    torch.testing.assert_close(per.detach(), want[0] - want[1], rtol=0, atol=1e-4)


# Phase B's sweeps of matmul_bias and the bias_gelu kernels, one definition
# for both.
MB_SWEEP = {name: (N, D, F, kw) for name, N, D, F, kw in MB_CASES}
GELU_SWEEP = {name: (N, F, kw) for name, N, F, kw in GELU_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(MB_SWEEP))
def test_matmul_bias_kernel_matches_plain_version(cuda, case, dtype):
    N, D, F, kw = MB_SWEEP[case]
    x, w, b = mb_inputs(N, D, F, dtype, torch.Generator(device=cuda).manual_seed(0), kw)
    before = matmul_bias_fwd.launches + matmul_bias_fwd.simt_launches
    _, ok, detail = mb_compare(x, w, b)  # which also holds the route taken to _route's
    assert matmul_bias_fwd.launches + matmul_bias_fwd.simt_launches == before + 1
    assert ok, detail


# The bias_gelu cases that take the "simt" route: a row of 17 elements, a
# base one element off 16 bytes.
GELU_SIMT = {"ragged_1000x17", "x_offset_1"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(GELU_SWEEP))
def test_bias_gelu_kernels_match_plain_versions(cuda, case, dtype):
    """Both wrappers against their plain versions (y and dx within GELU_TOL,
    db within chip_smoke's gelu_db_tol), on the route the case must take,
    each launched twice with equal bits."""
    N, F, kw = GELU_SWEEP[case]
    x, b, g = gelu_inputs(N, F, dtype, torch.Generator(device=cuda).manual_seed(1), kw)
    want = "simt" if case in GELU_SIMT else "vec"
    assert bg_mod._route(dtype, F, x.data_ptr(), g.data_ptr()) == bg_mod._route(dtype, F, x.data_ptr()) == want
    before = [fn.launches + fn.simt_launches for fn in (bias_gelu_fwd, bias_gelu_bwd)]
    results = gelu_compare(x, b, g)
    assert [fn.launches + fn.simt_launches for fn in (bias_gelu_fwd, bias_gelu_bwd)] == [n + 2 for n in before]
    for name, (_, ok, detail) in results.items():
        assert ok, (name, detail)
        assert detail.startswith(f"route {want}"), (name, detail)


@pytest.mark.cuda
def test_bias_gelu_vec_route_refuses_what_it_cannot_run(cuda, monkeypatch):
    """Forced onto "vec", a row of other bytes and a base off 16 bytes are
    refused by the kernels' entry and the wrapper raises: no route stands in
    for the other."""
    monkeypatch.setattr(bg_mod, "_route", lambda *a: "vec")
    ragged = torch.zeros(8, 17, device=cuda, dtype=torch.bfloat16)
    off = torch.zeros(8 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(8, 64)
    for x in (ragged, off):
        b = torch.zeros(x.shape[-1], device=cuda, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="vec"):
            bias_gelu_fwd(x, b)
        with pytest.raises(RuntimeError, match="vec"):
            bias_gelu_bwd(x, b, torch.zeros_like(x))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [0, 1, 33, 4096])
def test_bias_gelu_bwd_db_of_any_row_count(cuda, N):
    """db over 0 rows is zeros; over a few rows or more bands than one
    batch of the band sum, the plain version's within gelu_db_tol."""
    x, b, g = gelu_inputs(max(N, 1), 256, torch.bfloat16, torch.Generator(device=cuda).manual_seed(3), {})
    x, g = x[:N], g[:N]
    dx, db = bias_gelu_bwd(x, b, g)
    want_dx, want_db = bg_mod.reference_bias_gelu_grads(x, b, g)
    assert dx.shape == x.shape and db.dtype == b.dtype
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    tol = gelu_db_tol(bg_mod.reference_bias_gelu_bwd(x, b, g), want_db)
    assert ((db.float() - want_db.float()).abs() <= tol).all()


@pytest.mark.cuda
def test_matmul_bias_and_bias_gelu_reject_what_they_cannot_run(cuda):
    x = torch.zeros(8, 16, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        matmul_bias_fwd(x, torch.zeros(4, 16, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        matmul_bias_fwd(x.float(), torch.zeros(4, 16, device=cuda).half())
    with pytest.raises(ValueError):
        matmul_bias_fwd(x.float(), torch.zeros(4, 15, device=cuda))
    with pytest.raises(ValueError):
        matmul_bias_fwd(x.float(), torch.zeros(4, 16, device=cuda), torch.zeros(4))  # a CPU bias
    with pytest.raises(TypeError):
        bias_gelu_fwd(x, torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        bias_gelu_fwd(x.float(), torch.zeros(15, device=cuda))
    with pytest.raises(ValueError):
        bias_gelu_bwd(x.float(), torch.zeros(16, device=cuda), torch.zeros(8, 15, device=cuda))
    # The kernels read b in its own dtype: fp32, fp16 or bf16, and no other.
    with pytest.raises(TypeError, match="float32.*float16.*bfloat16"):
        bias_gelu_fwd(x.float(), torch.zeros(16, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32.*float16.*bfloat16"):
        bias_gelu_bwd(x.float(), torch.zeros(16, device=cuda, dtype=torch.float64), x.float())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "simt"])
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.float16, torch.bfloat16, torch.float64],
                         ids=["fp32", "fp16", "bf16", "fp64"])
def test_matmul_bias_reads_each_bias_dtype(cuda, monkeypatch, route, b_dtype):
    """bf16 operands (ragged N and F) with a bias of each dtype (read as it
    is in bf16 and fp32, cast to fp32 first otherwise), on both routes, within
    MB_TOL of the plain version (which widens the bias to fp32 as well)."""
    x, w, _ = mb_inputs(1000, 768, 2300, torch.bfloat16, torch.Generator(device=cuda).manual_seed(7), {})
    b = torch.randn(2300, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda).to(b_dtype)
    monkeypatch.setattr(mb_mod, "_route", lambda *a: route)
    y = matmul_bias_fwd(x, w, b)
    ref = mb_mod.reference_matmul_bias(x, w, b)
    err = float((y.float() - ref.float()).abs().max())
    assert y.dtype == torch.bfloat16 and err <= MB_TOL[torch.bfloat16] * float(ref.float().abs().max()), err


@pytest.mark.cuda
def test_fused_grads_through_kernels_match_cpu(cuda):
    """fp32 gradients of x, w and b through ``matmul_bias`` and of x and b
    through ``bias_gelu`` (the kernels, then their autograd backward) against
    the CPU's plain versions."""
    torch.manual_seed(0)
    x, w, b = torch.randn(300, 64), 0.1 * torch.randn(96, 64), torch.randn(96)
    runs = {}
    for device in (cuda, "cpu"):
        xs, ws, bs = (t.clone().to(device).requires_grad_() for t in (x, w, b))
        y = bias_gelu(matmul_bias(xs, ws, bs), bs)
        (y ** 2).sum().backward()
        runs[str(device)] = [t.grad.cpu() for t in (xs, ws, bs)]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_smp_nn_fused_step_on_card_matches_cpu(cuda):
    """One fp32 step of ``DistributedTransformerLMHead`` under ``fused_qkv``
    and ``fused_bias_gelu`` (2 microbatches, T = 128): the card (the three
    kernels and the flash kernels) and the CPU (the unfused path, the same
    function in fp32) give the same loss and gradients."""
    cfg = dict(num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64, intermediate_size=256,
               vocab_size=97, num_positions=128, causal_mask_size=128, pre_layernorm=True, post_layernorm=False,
               final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0,
               embedding_dropout_prob=0.0, fused_bias_gelu=True)
    init = init_weights_(DistributedTransformerLMHead(**cfg), 0.02, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 97, (2, 128), generator=torch.Generator().manual_seed(1))
    results = {}
    def launches():  # fp32 operands take matmul_bias's CUDA-core route
        return (matmul_bias_fwd.launches, matmul_bias_fwd.simt_launches, bias_gelu_fwd.launches,
                bias_gelu_bwd.launches)

    before = launches()
    for device in (cuda, "cpu"):
        smp_torch.init({"microbatches": 2, "fused_qkv": True}, device=device)
        model = smp_torch.DistributedModel(copy.deepcopy(init))

        @smp_torch.step
        def train_step(model, batch):
            loss = vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]).mean()
            model.backward(loss)
            return loss

        loss = float(train_step(model, ids).reduce_mean())
        results[str(device)] = (loss, {n: g.cpu() for n, g in model.grads.items()})
    after = launches()
    assert tuple(a - b for a, b in zip(after, before)) == (0, 4, 4, 4)  # 2 layers x 2 microbatches, card only
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for name in g_cpu:
        torch.testing.assert_close(g_gpu[name], g_cpu[name], rtol=1e-4, atol=1e-6, msg=name)


FP8_SWEEP = {name: (N, D, F, kw) for name, N, D, F, kw in FP8_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FP8_SWEEP))
def test_matmul_fp8_kernel_matches_plain_version(cuda, case):
    N, D, F, kw = FP8_SWEEP[case]
    x8, w8 = fp8_inputs(N, D, F, torch.Generator(device=cuda).manual_seed(2), kw)
    before = matmul_fp8.launches + matmul_fp8.simt_launches
    _, ok, detail = fp8_compare(x8, w8)  # which also holds the route taken to _route's
    assert matmul_fp8.launches + matmul_fp8.simt_launches == before + 1
    assert ok, detail


# Ragged N and F (a partial last tile in both directions; a partial last row
# tile at the path's F) reach the tensor-core routes.
RAGGED_TC = {"ragged_1000x768x2300": (1000, 768, 2300), "n2047_f2304": (2047, 768, 2304)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED_TC))
@pytest.mark.parametrize("kernel", ["matmul_bias_bf16", "matmul_bias_fp16", "matmul_fp8"])
def test_tensor_core_route_on_ragged_shapes(cuda, case, kernel):
    N, D, F = RAGGED_TC[case]
    gen = torch.Generator(device=cuda).manual_seed(4)
    if kernel == "matmul_fp8":
        fn, compare, inputs = matmul_fp8, fp8_compare, fp8_inputs(N, D, F, gen, dict(values="codes"))
    else:
        dtype = torch.bfloat16 if kernel.endswith("bf16") else torch.float16
        fn, compare, inputs = matmul_bias_fwd, mb_compare, mb_inputs(N, D, F, dtype, gen, {})
    before = (fn.launches, fn.simt_launches)
    _, ok, detail = compare(*inputs)
    assert (fn.launches - before[0], fn.simt_launches - before[1]) == (1, 0), detail
    assert ok, detail


@pytest.mark.cuda
def test_matmul_bias_routes_agree(cuda, monkeypatch):
    """The tensor-core and CUDA-core kernels on the same bf16 inputs (ragged
    N and F) agree within MB_TOL of the largest |y|."""
    x, w, b = mb_inputs(1000, 768, 2300, torch.bfloat16, torch.Generator(device=cuda).manual_seed(5), {})
    assert mb_mod._route(x.dtype, 768, x.data_ptr(), w.data_ptr()) == "wgmma"
    tc = matmul_bias_fwd(x, w, b)
    monkeypatch.setattr(mb_mod, "_route", lambda *a: "simt")
    before = matmul_bias_fwd.simt_launches
    simt = matmul_bias_fwd(x, w, b)
    assert matmul_bias_fwd.simt_launches == before + 1
    err = float((tc.float() - simt.float()).abs().max())
    assert err <= MB_TOL[torch.bfloat16] * float(simt.float().abs().max()), err


@pytest.mark.cuda
def test_matmul_fp8_routes_agree(cuda, monkeypatch):
    """The tensor-core and CUDA-core kernels on the same e4m3 inputs (every
    code, ragged N and F) each hold every element to its fp32 summation-order
    bound, so they agree within twice that bound."""
    x8, w8 = fp8_inputs(1000, 768, 2300, torch.Generator(device=cuda).manual_seed(6), dict(values="codes"))
    assert mf_mod._route(768, x8.data_ptr(), w8.data_ptr()) == "wgmma"
    tc = matmul_fp8(x8, w8)
    monkeypatch.setattr(mf_mod, "_route", lambda *a: "simt")
    before = matmul_fp8.simt_launches
    simt = matmul_fp8(x8, w8)
    assert matmul_fp8.simt_launches == before + 1
    for y in (tc, simt):
        _, ok, share = fp8_bound(x8, w8, y)
        assert ok, share
    absdot = x8.float().abs().double() @ w8.float().abs().double().t()
    assert bool(((tc.double() - simt.double()).abs() <= 2 * (2 * 768 * 2.0**-24 * absdot)).all())


@pytest.mark.cuda
def test_matmul_fp8_rejects_what_it_cannot_run(cuda):
    x8 = torch.zeros(8, 16, device=cuda).to(torch.float8_e4m3fn)
    w8 = torch.zeros(4, 16, device=cuda).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        matmul_fp8(x8.float(), w8)
    with pytest.raises(TypeError):
        matmul_fp8(x8, w8.to(torch.float8_e5m2))
    with pytest.raises(ValueError):
        matmul_fp8(x8, w8[:, :15])
    with pytest.raises(ValueError):
        matmul_fp8(x8, w8.cpu())


@pytest.mark.cuda
def test_fp8_casts_on_card_match_cpu(cuda):
    """``_cast_f8`` (a true division by the slot's scale, a tensor on the
    card) and ``_cast_e5m2_current`` give the CPU's bits."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(257, 129, generator=g) * torch.exp(torch.empty(257, 129).uniform_(-6, 5, generator=g))
    qs = quant.QuantState()
    qs.scale = torch.rand(len(quant.SITE_SLOTS), generator=g) * 0.05 + 1e-4
    out = {}
    for device in (cuda, torch.device("cpu")):
        qs.to(device)
        with quant.step_trace(qs):
            x8, _ = quant._cast_f8(x.to(device), "qkv.x")
            xb8, _ = quant._cast_f8(x.to(device, torch.bfloat16), "mlp_fc.x")
        g8, dg = quant._cast_e5m2_current(x.to(device) * 1e-3)
        out[device.type] = [t.cpu().view(torch.uint8) for t in (x8, xb8, g8)] + [float(dg)]
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        assert torch.equal(got, want)
    assert out["cuda"][3] == out["cpu"][3]


@pytest.mark.cuda
def test_smp_nn_fp8_step_on_card_matches_cpu(cuda, monkeypatch):
    """One fp32 step of ``DistributedTransformerLMHead`` under
    ``matmul_precision: fp8`` and both fused knobs (2 microbatches, T =
    128): the card (``matmul_fp8``, the bias-GELU and flash kernels) and the
    CPU (their plain versions, through the fused branch) give the same loss,
    gradients and quant state. Only the fp32 summation order differs, which
    can flip an element across an e4m3 rounding boundary: loss 1e-4
    relative, gradients 1e-2 in relative L2, the amax observations 1e-5."""
    monkeypatch.setattr(mb_mod, "_is_cuda", lambda t: True)
    monkeypatch.setattr(bg_mod, "_is_cuda", lambda t: True)
    cfg = dict(num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64, intermediate_size=256,
               vocab_size=97, num_positions=128, causal_mask_size=128, pre_layernorm=True, post_layernorm=False,
               final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0,
               embedding_dropout_prob=0.0, fused_bias_gelu=True)
    init = init_weights_(DistributedTransformerLMHead(**cfg), 0.02, torch.Generator().manual_seed(0))
    ids = torch.randint(0, 97, (2, 128), generator=torch.Generator().manual_seed(1))
    results = {}
    before = (matmul_fp8.launches, matmul_bias_fwd.launches)
    for device in (cuda, "cpu"):
        smp_torch.init({"microbatches": 2, "fused_qkv": True, "matmul_precision": "fp8"}, device=device)
        model = smp_torch.DistributedModel(copy.deepcopy(init))

        @smp_torch.step
        def train_step(model, batch):
            loss = vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]).mean()
            model.backward(loss)
            return loss

        loss = float(train_step(model, ids).reduce_mean())
        results[str(device)] = (loss, {n: g.cpu() for n, g in model.grads.items()},
                                smp_torch.state.quant_state.state_dict())
    assert (matmul_fp8.launches - before[0], matmul_bias_fwd.launches - before[1]) == (4, 0)  # card only
    (l_gpu, g_gpu, q_gpu), (l_cpu, g_cpu, q_cpu) = results["cuda"], results["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    diff = sum(float(((g_gpu[n] - g) ** 2).sum()) for n, g in g_cpu.items())
    norm = sum(float((g ** 2).sum()) for g in g_cpu.values())
    assert (diff / norm) ** 0.5 <= 1e-2
    np.testing.assert_allclose(q_gpu["amax_history"], q_cpu["amax_history"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(q_gpu["scale"], q_cpu["scale"], rtol=1e-5, atol=0)


IDS_SWEEP = {c[0]: c[1:] for c in IDS_CASES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(IDS_SWEEP))
def test_flash_ids_kernels_match_plain_versions(cuda, case, dtype):
    """Each ids-mode kernel on its route against its plain version (and on
    the tensor cores against the CUDA-core route and a repeat launch)."""
    B, Tl, H, hd, n, me, src, kw = IDS_SWEEP[case]
    gen = torch.Generator(device=cuda).manual_seed(0)
    errs, ok, detail = ids_compare(*ids_inputs(B, Tl, H, hd, n, me, src, dtype, gen, kw))
    assert ok, detail


@pytest.mark.cuda
def test_flash_ids_rejects_what_it_cannot_run(cuda):
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_fwd_with_ids

    q = torch.zeros(1, 256, 2, 64, device=cuda)
    ids = torch.arange(256, device=cuda)
    with pytest.raises(ValueError, match="q_ids"):
        flash_fwd_with_ids(q, q, q, None, ids[:100], ids, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="multiples of 64"):
        flash_fwd_with_ids(q, q, q, None, ids, ids, scale=1.0, causal=True, block_k=96)


def _cp_card_worker(rank, world):
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.ops.context_parallel import cp_attention
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_fwd_with_ids

    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 512, 4, 64, generator=gen) for _ in range(4))
    sl = slice(rank * 256, (rank + 1) * 256)
    out = {}
    for impl in ("ring", "ulysses"):
        smp.init({"context_parallel_degree": world, "ddp": True, "context_parallel_impl": impl}, device="cuda:0")
        ql, kl, vl = (x[:, sl].cuda().requires_grad_() for x in (q, k, v))
        flash_fwd_with_ids.simt_launches = 0  # fp32: the CUDA-core route
        o = cp_attention(ql, kl, vl, scale=0.125, causal=True)
        (o * g[:, sl].cuda()).sum().backward()
        out[impl] = [x.detach().cpu().numpy() for x in (o, ql.grad, kl.grad, vl.grad)]
        out[impl + "_launches"] = flash_fwd_with_ids.simt_launches
    return out


@pytest.mark.cuda
def test_cp2_attention_on_card_matches_full_attention_on_cpu(cuda):
    """Two ranks on cuda:0 over gloo (host copies): the ring on the ids-mode
    kernels and Ulysses on the plain ones, fp32, against the plain full
    attention on the CPU: outputs 1e-4, gradients 1e-4 of the largest."""
    per_rank = run_ranks(2, _cp_card_worker)
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 512, 4, 64, generator=gen) for _ in range(4))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    o, _ = flash_attention(qt, kt, vt, scale=0.125, causal=True)
    (o * g).sum().backward()
    want = [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]
    for impl in ("ring", "ulysses"):
        got = [np.concatenate([r[impl][i] for r in per_rank], axis=1) for i in range(4)]
        for a, b in zip(got, want):
            assert float(np.abs(a - b).max()) <= 1e-4 * max(float(np.abs(b).max()), 1.0), impl
    assert [r["ring_launches"] for r in per_rank] == [2, 2]


_CKPT_CFG = dict(num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64, intermediate_size=256,
                 vocab_size=97, num_positions=128, causal_mask_size=128, pre_layernorm=True, post_layernorm=False,
                 final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0,
                 embedding_dropout_prob=0.0, fused_bias_gelu=True)


def _ckpt_run(cuda, seed, steps, ids, resume=None):
    """bf16 smp.nn training on the card (the fused knobs, AdamW):
    ``resume`` a checkpoint before the model exists; the losses and the
    model."""
    smp_torch.reset()
    smp_torch.init({"microbatches": 2, "bf16": True, "fused_qkv": True}, device=cuda)
    if resume is not None:
        smp_torch.resume_from_checkpoint(resume, tag="c")
    module = init_weights_(DistributedTransformerLMHead(**_CKPT_CFG), 0.02, torch.Generator().manual_seed(seed))
    model = smp_torch.DistributedModel(module)
    opt = smp_torch.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8), model)

    @smp_torch.step
    def train_step(model, batch):
        loss = vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]).mean()
        model.backward(loss)
        return loss

    losses = []
    for _ in range(steps):
        losses.append(float(train_step(model, ids).reduce_mean()))
        opt.step()
    return losses, model, opt, train_step


@pytest.mark.cuda
def test_checkpoint_save_and_resume_on_card(cuda, tmp_path):
    """A partial checkpoint of CUDA tensors resumes (deferred, into a model
    from another seed) to the uninterrupted run's losses and parameters, bit
    for bit; a ``blocking=False`` save followed at once by an in-place
    ``optimizer.step()`` holds the submission's bits."""
    ids = torch.randint(0, 97, (4, 128), generator=torch.Generator().manual_seed(1)).to(cuda)
    _, model, opt, train_step = _ckpt_run(cuda, 0, 2, ids)
    smp_torch.save_checkpoint(str(tmp_path), tag="c")
    want_sd = model.reference_state_dict()
    smp_torch.save_checkpoint(str(tmp_path), tag="a", blocking=False)
    want = []
    for _ in range(2):
        want.append(float(train_step(model, ids).reduce_mean()))
        opt.step()
    smp_torch.wait_for_checkpoints()
    final = model.reference_state_dict()
    files = np.load(tmp_path / "a_partial" / "model_shards_p0.npz")
    for k, v in want_sd.items():
        assert files[f"{k}|[{', '.join(f'[0, {d}]' for d in v.shape)}]"].tobytes() == v.tobytes(), k
    got, model2, _, _ = _ckpt_run(cuda, 5, 2, ids, resume=str(tmp_path))
    assert got == want
    for k, v in model2.reference_state_dict().items():
        assert v.tobytes() == final[k].tobytes(), k
    assert all(p.is_cuda for p in model2.parameters())


@pytest.mark.cuda
def test_prefetch_batches_equal_host_batches(cuda):
    """``smp.dataloader`` stages every array leaf on the card, bit-equal to
    the host batch, so the step's ``.to(device)`` returns it as it is."""
    smp_torch.reset()
    smp_torch.init({}, device=cuda)
    rng = np.random.default_rng(0)
    host = [{"ids": rng.integers(0, 50257, (8, 1024)), "w": rng.random((8,), np.float32),
             "t": torch.arange(6, dtype=torch.bfloat16), "n": 3} for _ in range(5)]
    got = list(smp_torch.dataloader(iter(host), size=2))
    torch.cuda.synchronize()
    assert len(got) == 5
    for g, h in zip(got, host):
        for k in ("ids", "w"):
            assert g[k].is_cuda and g[k].dtype == torch.from_numpy(h[k]).dtype
            assert np.array_equal(g[k].cpu().numpy(), h[k])
        assert g["t"].is_cuda and torch.equal(g["t"].cpu(), h["t"]) and g["n"] == 3
        assert g["ids"].to(torch.device(cuda)) is g["ids"]


@pytest.mark.cuda
def test_dropout_kernels_match_plain_versions_bit_for_bit(cuda):
    """chip_smoke's phase-B sweep of ``csrc/dropout.cu``: threefry bits under
    keys from ``key``, ``fold_in`` and ``split`` at the path's size, odd
    sizes and offsets past 2**32; the dropout forward (y and mask) and
    backward in fp32, bf16 and fp16 at rates 0.1, 0.5 and 0: every bit equal
    to the plain version's."""
    from chip_smoke import _phase_b_dropout

    failures = []
    errs = _phase_b_dropout(failures)
    assert failures == [] and errs == {"threefry_bits": 0.0, "dropout_fwd": 0.0, "dropout_bwd": 0.0}


@pytest.mark.cuda
def test_dropout_step_on_card_matches_cpu(cuda):
    """One fp32 step of a small smp.nn model with all three dropouts, card
    against CPU from the same weights and seed (chip_smoke's phase-D check):
    losses rtol 2e-4 / atol 2e-5, gradients rtol 2e-3 / atol 2e-4."""
    from chip_smoke import _d_small_card_vs_cpu

    runs = _d_small_card_vs_cpu()
    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, _) = runs["cuda"], runs["cpu"]
    assert abs(l_gpu - l_cpu) <= 2e-5 + 2e-4 * abs(l_cpu)
    for name, want in g_cpu.items():
        torch.testing.assert_close(g_gpu[name], want, rtol=2e-3, atol=2e-4)
    assert n_gpu["dropout_fwd"] == n_gpu["dropout_bwd"] == 14
