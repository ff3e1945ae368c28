#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --phases B # kernel-vs-plain comparisons only

Builds the port's CUDA kernels from ``smdistributed_modelparallel_tpu_torch/
csrc`` (one nvcc per source, all started together), then:

  A. the main path: ``smp.generate`` on GPT-2 124M at full width (d 768,
     12 layers, 12 heads, vocab 50257) with random GPT-2-style weights from
     a seed, bf16, 4 prompts of 512 tokens, 32 new tokens, greedy and
     sampled; each kernel's launch count is set to 0 just before and read
     just after, and must show one launch per layer per prefill. A small
     fp32 model is also held against the same weights run on the CPU.
  B. every kernel against its plain PyTorch version on the card, at the
     main path's shape and over a feature sweep, within stated tolerances.
  C. times: kernel, plain version and the one PyTorch library call that
     computes the same function, with CUDA events; and the bound (the least
     time the card could take for the same work).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is absent, the package is missing, or any phase
fails.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, at a 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

KERNEL_SOURCES = ["flash_fwd"]
SEED = 1234


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build():
    from smdistributed_modelparallel_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(KERNEL_SOURCES)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(KERNEL_SOURCES)} source(s) built in {secs:.1f} s")


def phase_a():
    """The main path through the public entry points."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention

    B, T, NEW = 4, 512, 32
    smp.init({"bf16": True})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    module = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
    model = smp.DistributedModel(module, device="cuda")
    n_layers = len(module.layers)
    prompts = torch.randint(0, module.vocab_size, (B, T), generator=g, device="cuda")
    sample_kw = dict(temperature=0.8, top_k=50, top_p=0.95)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # Warm-up (cuBLAS handles, allocator), not counted.
    smp.generate(model, prompts, 2)

    flash_attention.launches = 0
    _, prefill_ms = timed(lambda: smp.generate(model, prompts, 1))
    greedy, greedy_ms = timed(lambda: smp.generate(model, prompts, NEW))
    sampled, sampled_ms = timed(lambda: smp.generate(
        model, prompts, NEW, rng=torch.Generator(device="cuda").manual_seed(SEED), **sample_kw))
    launches = {"flash_fwd": flash_attention.launches}
    n_prefills = 3

    decode_ms_per_token = (greedy_ms - prefill_ms) / (NEW - 1)
    tokens_per_s = B * NEW / (greedy_ms / 1e3)
    log(f"[A] prefill (generate, 1 new token) {prefill_ms:.2f} ms  B={B} T={T}")
    log(f"[A] greedy generate {NEW} tokens {greedy_ms:.2f} ms; decode {decode_ms_per_token:.3f} ms/token; "
        f"{tokens_per_s:.1f} tokens/s")
    log(f"[A] sampled generate {NEW} tokens {sampled_ms:.2f} ms")
    log(f"[A] launches on the main path: {launches} over {n_prefills} prefills of {n_layers} layers")

    if launches["flash_fwd"] < n_layers * n_prefills:
        raise RuntimeError(f"flash_fwd launched {launches['flash_fwd']} times, expected >= {n_layers * n_prefills}")
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        if out.shape != (B, T + NEW):
            raise RuntimeError(f"{name} output shape {tuple(out.shape)}")
        if not torch.equal(out[:, :T], prompts):
            raise RuntimeError(f"{name} output does not start with the prompts")
        if int(out.min()) < 0 or int(out.max()) >= module.vocab_size:
            raise RuntimeError(f"{name} tokens out of range")
    again = smp.generate(model, prompts, NEW, rng=torch.Generator(device="cuda").manual_seed(SEED), **sample_kw)
    if not torch.equal(again, sampled):
        raise RuntimeError("sampled generation is not reproducible from its seed")

    # Full-width prefill logits: kernel path vs the plain attention path.
    with torch.inference_mode():
        bf16_module = copy.deepcopy(module).to(torch.bfloat16)
        logits = bf16_module(prompts)
        os.environ["SMP_DISABLE_PALLAS_ATTN"] = "1"
        try:
            plain_logits = bf16_module(prompts)
        finally:
            del os.environ["SMP_DISABLE_PALLAS_ATTN"]
    if not torch.isfinite(logits).all():
        raise RuntimeError("non-finite logits")
    rel = float((logits.float() - plain_logits.float()).abs().max() / plain_logits.float().abs().max())
    log(f"[A] bf16 GPT-2 124M prefill logits, kernel vs plain attention: max rel diff {rel:.3e} (limit 5e-2)")
    # bf16 rounds P differently in the two attention paths; twelve layers
    # compound that to a few bf16 ulps of the logit scale.
    if rel > 5e-2:
        raise RuntimeError("prefill logits disagree between the kernel and the plain path")

    # Small fp32 model: the card (kernel path) against the CPU (plain path).
    smp.init({})
    # Weights at std 0.5, so the logits are far from ties and greedy tokens
    # compare exactly.
    small = init_gpt2_weights_(gpt2("gpt2_124m", vocab_size=97, max_len=256, d_model=64, n_layers=2, n_heads=4),
                               torch.Generator().manual_seed(SEED), std=0.5)
    cpu_model = smp.DistributedModel(copy.deepcopy(small), device="cpu")
    gpu_model = smp.DistributedModel(small, device="cuda")
    ids = torch.randint(0, 97, (2, 160), generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        cpu_logits = cpu_model(ids)
        err = float((gpu_model(ids.cuda()).cpu() - cpu_logits).abs().max() / cpu_logits.abs().max())
    toks_gpu = smp.generate(gpu_model, ids, 8).cpu()
    toks_cpu = smp.generate(cpu_model, ids, 8)
    log(f"[A] fp32 small model, card vs CPU: logits max rel diff {err:.3e} (limit 2e-5); "
        f"greedy tokens equal: {torch.equal(toks_gpu, toks_cpu)}")
    # fp32 throughout; only the summation order differs (a few fp32 ulps of
    # the logit scale).
    if err > 2e-5 or not torch.equal(toks_gpu, toks_cpu):
        raise RuntimeError("the card's fp32 forward disagrees with the CPU's")

    smp.reset()
    return launches


def _inputs(B, T, S, H, hd, dtype, gen):
    q = torch.randn(B, T, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    return q, k, v


# (name, B, T, S, H, hd, kwargs). Tolerances below, per dtype.
CASES = [
    ("main_path_causal", 4, 512, 512, 12, 64, {}),
    ("t_lt_s_causal", 2, 200, 333, 4, 64, {}),
    ("t_gt_s_causal_sentinel_rows", 2, 300, 130, 4, 64, dict(block_q=128, block_k=128)),
    ("non_causal", 2, 256, 384, 4, 64, dict(causal=False)),
    ("causal_window", 2, 384, 384, 4, 64, dict(window=100, block_q=128, block_k=128)),
    ("symmetric_window", 2, 256, 320, 4, 64, dict(causal=False, window=70, block_q=128, block_k=128)),
    ("kpad_fully_padded_rows", 3, 160, 160, 4, 64, dict(kpad="left_and_full")),
    ("dropout_0.1", 2, 256, 256, 4, 64, dict(dropout_rate=0.1, seed=-123456789)),
    ("dropout_head_remap", 2, 256, 256, 4, 64, dict(dropout_rate=0.1, seed=77, head0=4, head_total=12,
                                                     counter_len=1000)),
    ("hd128", 2, 256, 256, 4, 128, {}),
    ("hd256_scale", 1, 128, 128, 2, 256, dict(scale=0.1)),
    ("ragged_t200", 2, 200, 200, 4, 48, {}),
]
# fp32: identical arithmetic, only the summation order and the online vs
# one-pass softmax differ (~1e-6 relative). bf16: the kernel rounds P to
# bf16 against its running row max, the plain version against the final
# max, so O differs by a few bf16 ulps; LSE stays fp32.
TOL = {torch.float32: dict(o=1e-4, lse=1e-4), torch.bfloat16: dict(o=2e-2, lse=1e-3)}


def phase_b():
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    saved = flash_attention.launches
    main_err, failures = None, []
    for name, B, T, S, H, hd, kw in CASES:
        dtypes = [torch.bfloat16] if name == "main_path_causal" else [torch.float32, torch.bfloat16]
        for dtype in dtypes:
            q, k, v = _inputs(B, T, S, H, hd, dtype, gen)
            kw = dict(kw)
            if kw.get("kpad") == "left_and_full":
                kpad = torch.zeros(B, S, device="cuda")
                kpad[1, :50] = -1e30   # left padding: rows < 50 see only pad keys
                kpad[2, :] = -1e30     # a fully padded sequence
                kw["kpad_bias"] = kpad
                del kw["kpad"]
            o, lse = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
            err_o = float((o.float() - o_ref.float()).abs().max())
            err_lse = float((lse - lse_ref).abs().max())
            tol = TOL[dtype]
            ok = err_o <= tol["o"] and err_lse <= tol["lse"] and bool(torch.isfinite(o).all())
            tag = str(dtype).removeprefix("torch.")
            log(f"[B] flash_fwd {name:32s} {tag:9s} max|dO| {err_o:.2e} (tol {tol['o']:.0e}) "
                f"max|dLSE| {err_lse:.2e} (tol {tol['lse']:.0e}) {'ok' if ok else 'FAIL'}")
            if name == "main_path_causal":
                main_err = err_o
            if not ok:
                failures.append(f"{name}/{tag}")
    flash_attention.launches = saved  # comparison launches do not count
    if failures:
        raise RuntimeError(f"kernel disagrees with its plain version: {failures}")
    return main_err


def phase_c():
    import torch.nn.functional as F

    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    B, T, S, H, hd, dtype = 4, 512, 512, 12, 64, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = _inputs(B, T, S, H, hd, dtype, gen)
    saved = flash_attention.launches
    ms = cuda_time_ms(lambda: flash_attention(q, k, v))
    flash_attention.launches = saved
    plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    esz = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * T * H * hd * esz + 2 * B * S * H * hd * esz + B * H * T * 4  # q, o, k, v, lse
    pairs = sum(min(S, r + (S - T) + 1) for r in range(T))  # causal (row, col) pairs
    flops = 4 * B * H * pairs * hd  # two products of 2 flops per (pair, d)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[C] flash_fwd B={B} T=S={T} H={H} hd={hd} bf16 causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def phase_p():
    """Where one greedy ``generate`` spends its time, by torch.profiler:
    device time by kernel and the device's idle share of the wall time."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from torch.profiler import ProfilerActivity, profile

    B, T, NEW = 4, 512, 32
    smp.init({"bf16": True})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = smp.DistributedModel(init_gpt2_weights_(gpt2_124m(device="cuda"), g), device="cuda")
    prompts = torch.randint(0, 50257, (B, T), generator=g, device="cuda")
    smp.generate(model, prompts, 2)
    for new in (1, NEW):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            smp.generate(model, prompts, new)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        log(f"[P] generate B={B} T={T} new={new}: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms, "
            f"idle share {1 - device_ms / wall_ms:.3f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[P]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    smp.reset()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="ABC",
                        help="phases to run: A, B, C (the default, all three) and P (a profile)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an H100.", file=sys.stderr)
        return 2
    import smdistributed_modelparallel_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    build()
    launches, err, timing = {}, None, None
    if "A" in args.phases:
        launches = phase_a()
    if "B" in args.phases:
        err = phase_b()
    if "C" in args.phases:
        timing = phase_c()
    if "P" in args.phases:
        phase_p()

    if not set("ABC") <= set(args.phases):
        return 0  # a partial run prints no result
    ms, plain_ms, library_ms, bound_ms, bound_by = timing
    kernels = [dict(
        name="flash_fwd", route="cuda",
        source="smdistributed_modelparallel_tpu_torch/csrc/flash_fwd.cu",
        replaces="smdistributed_modelparallel_tpu/ops/pallas_attention.py:162",
        launches=launches["flash_fwd"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
    )]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
