"""Card-only tests of the port's CUDA kernels (marked ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card. On the card
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX; these
tests need none):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Each kernel is held against its plain PyTorch version, which the CPU tests
hold against the JAX package. Tolerances: fp32 runs the same arithmetic,
summation order and online softmax aside, so 1e-4; bf16 rounds P to bf16
against different row maxima, so O to 2e-2 while LSE (fp32) stays 1e-3.
"""

import pytest
import torch

import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, init_gpt2_weights_
from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
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
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
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
    before = flash_attention.launches
    got = smp_torch.generate(gpu, ids, 8).cpu()
    assert flash_attention.launches == before + 2  # one per layer, prefill only
    assert torch.equal(got, want)
