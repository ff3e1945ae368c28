#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --phases B # kernel-vs-plain comparisons only
    python3 chip_smoke.py --phases T # the training path only
    python3 chip_smoke.py --phases F # the capacity path (fused cross-entropy) only
    python3 chip_smoke.py --phases L # the smp.nn path (fused QKV, fused bias-GELU) only
    python3 chip_smoke.py --phases Q # the smp.nn path under matmul_precision: fp8 only
    python3 chip_smoke.py --phases R # context-parallel training (two ranks on one card) only
    python3 chip_smoke.py --phases N # the same with the ranks on two cards (NCCL); needs two cards

Builds the port's CUDA kernels from ``smdistributed_modelparallel_tpu_torch/
csrc`` (one nvcc per source, all started together), then:

  A. the main path: ``smp.generate`` on GPT-2 124M at full width (d 768,
     12 layers, 12 heads, vocab 50257) with random GPT-2-style weights from
     a seed, bf16, 4 prompts of 512 tokens, 32 new tokens, greedy and
     sampled; each kernel's launch count is set to 0 just before and read
     just after, and must show one launch per layer per prefill. A small
     fp32 model is also held against the same weights run on the CPU.
  T. the training path: ``@smp.step`` + ``smp.DistributedOptimizer`` on
     GPT-2 124M at full width with random weights from a seed, bf16, batch
     8 x 1024 tokens in 4 microbatches, AdamW(1e-4), loss mode,
     ``fused_step_donation`` (``bench.py``'s headline workload); warm-up
     steps, then timed steps whose kernel launches are counted (48 flash
     forward, dq and dk/dv launches a step; every flash-backward launch of
     T, F, L, Q and R on the tensor cores, none on the CUDA cores). The loss
     must fall and stay finite. A small fp32 model trains 3 steps on the card and on the CPU
     from the same weights; the losses must agree.
  F. the capacity path: the same training on 32 x 1024 tokens in one
     microbatch, where the logits would be 3.1 GB of bf16 and the default
     ``fused_ce: "auto"`` policy engages the fused cross-entropy kernels
     (1 forward, dx and dW launch and 12 of each flash kernel a step; dx and
     dW on their tensor-core route, none on the CUDA cores); the same steps
     with ``fused_ce: False`` (materialized logits) must give the same
     losses, and one step of the tied head the same hidden-state and
     ``wte.weight`` gradients; a small fp32 model under ``fused_ce: True``
     trains 3 steps on the card (kernels; dx and dW on the CUDA cores) and
     on the CPU (materialized), losses agreeing.
  L. the ``smp.nn`` path: ``smp.nn.DistributedTransformerLMHead`` at GPT-2
     124M's published widths (the kwargs ``nn/huggingface/gpt2.config_to_smp``
     gives, ``fused_bias_gelu=True``, dropouts 0) with random weights from a
     seed, trained by ``@smp.step`` in logits mode under ``fused_qkv: True``,
     bf16, 8 x 1024 tokens in 4 microbatches, AdamW; warm-up steps, then
     timed steps whose launches are counted (48 ``matmul_bias`` launches a
     step on its tensor-core route and none on its CUDA-core route, 48
     ``bias_gelu_fwd`` and ``bias_gelu_bwd`` on their "vec" route and none
     on "simt", and 48 of each flash kernel).
     The loss must fall and stay finite. Its unfused twin (``fused_qkv:
     False``, ``fused_bias_gelu=False``) from the same weights
     launches none of the three, and its losses and one step's qkv and fc
     gradients must agree; a small fp32 model under both knobs trains 3
     steps on the card (kernels) and on the CPU (the unfused path, the same
     function in fp32), losses agreeing.
  Q. fp8 delayed-scaling training: phase L's model, weights and batch under
     ``matmul_precision: "fp8"`` with both fused knobs; warm-up steps, then
     timed steps whose launches are counted (48 ``matmul_fp8`` launches a
     step on its tensor-core route, none on its CUDA-core route and no
     ``matmul_bias`` launch, 48 of each bias-GELU and flash kernel).
     The loss must fall, stay finite and stay within 2e-2 of the bf16 fused
     step's from the same weights at every step (the JAX package's gate);
     after the steps the 11 slots the path observes have left scale 1.0 and
     the other 8 have not. A small fp32 model under fp8 trains 3 steps on
     the card (kernel) and on the CPU (its plain version, through the fused
     branch), losses and quant state agreeing.
  R. context-parallel training: two ranks spawned on cuda:0 (the spawn
     start method, after the kernels are built here; gloo between them,
     with host copies of CUDA tensors) train GPT-2 124M at full width with
     learned positions for 4096 tokens (``gpt2_124m(max_len=4096)``, random
     weights from a seed, bf16, B 2, 2048 tokens a rank, one microbatch,
     AdamW, a masked-mean loss) for 3 steps under
     ``context_parallel_impl: ring``, then one step under Ulysses; this
     process trains the same weights and batch at cp = 1. The losses must
     agree within 1e-2 at every step, and each rank must launch each
     ids-mode kernel (the ring's forward, dq and dk/dv) 24 times a step (12
     layers x 2 ring steps); the Ulysses step launches the plain flash
     kernels instead.
  B. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes and over a feature sweep, within stated tolerances;
     the ids-mode kernels on phase R's ring pairs (each rank's diagonal and
     off-diagonal step, key padding, dropout with a head remap) and a sweep.
     Every kernel with two routes (``matmul_bias``, ``matmul_fp8``, the
     flash forward and backward in plain and ids mode, the fused-CE forward
     and backward, the bias-GELU forward and backward: "vec" or "simt")
     prints the route each case took (tensor cores or CUDA cores), which must
     be its ``_route``'s: the flash kernels take the
     tensor cores for fp16 and bf16 at hd 64, the CE forward for fp16 and
     bf16, the CE backward for bf16; there each is also held against its
     CUDA-core kernel forced on the same inputs (a bound stated beside its
     tolerance) and a repeat launch must give equal bits. ``matmul_bias``
     runs its sweep in fp32, bf16 and fp16, the flash kernels FP16_CASES in
     fp16, the CE forward every case in fp16. The bias-GELU wrappers run
     GELU_CASES in fp32, bf16 and fp16: y and dx within GELU_TOL, db within
     the fp32 summation-order bound (``gelu_db_tol``), repeats bit-equal.
  C. times: kernel, plain version and the one PyTorch library call that
     computes the same function; and the bound (the least time the card
     could take for the same work; the ids-mode kernels against SDPA with
     the mask built from the ids). Kernels of tens of microseconds, less
     than the host needs to launch one from Python (``matmul_bias``,
     ``matmul_fp8``, ``bias_gelu``, the flash forward and backward), are
     timed by CUDA-graph replay, their plain versions and library calls too:
     the wrapper the path calls (``ms``), the matrix products' bare kernel
     launch (``kernel_ms``) and the CUDA-core kernel (``simt_ms``); a
     library backward is captured on the stream its forward ran on. The
     fused-CE kernels (milliseconds) by CUDA events, each also held against
     its plain version on the timed inputs, the capacity path's N = 32768
     included. Every kernel with two routes is timed on its route and forced
     onto the CUDA cores in the same call, with its TFLOP/s.
  N. (on request, on a machine with two cards) phase R with the ranks on
     cuda:0 and cuda:1, which then talk over NCCL.
  P. (on request) torch.profiler breakdowns of a generate, a training step,
     a capacity step (fused and materialized) and the smp.nn path's fused,
     unfused and fp8 steps:
     device time by kernel and the device's idle share.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is absent, the package is missing, or any phase
fails.
"""

import argparse
import contextlib
import copy
import json
import math
import multiprocessing as mp
import os
import re
import socket
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, at a 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12, torch.float8_e4m3fn: 1979e12}

KERNEL_SOURCES = ["flash_fwd", "flash_bwd", "fused_ce", "matmul_bias", "bias_gelu", "matmul_fp8"]
DEFAULT_PHASES = "ATFLQRBC"
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


def cuda_graph_time_ms(fn, iters=20, replays=5, stream=None):
    """Mean device time of ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. For kernels of a
    few tens of microseconds, whose eager launches from Python (tens of
    microseconds of host work each) would leave the card idle between them,
    so ``cuda_time_ms`` would time the host. ``stream``: the stream to warm
    up and capture on (a new one by default); autograd runs a backward on
    its forward's stream, so a backward is captured there (sdpa_bwd_ms)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def rotating(fn, sets):
    """A call of ``fn`` on each argument tuple of ``sets`` in turn, one a
    call. With copies of the inputs that together exceed the card's 50 MB
    L2, each call finds its inputs cold, as the path finds a tensor it wrote
    long before (replaying one set would time reads from L2)."""
    turn = [0]

    def call():
        turn[0] += 1
        return fn(*sets[turn[0] % len(sets)])

    return call


def copies_of(tensors, n):
    """``n`` argument tuples: ``tensors`` and ``n - 1`` clones of them."""
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def library_bwd_ms(forward, inputs, grad, copies=1):
    """Device ms of the autograd backward of ``forward(*inputs)`` (the
    gradients of every input) for the output gradient ``grad``, by graph
    replay: the forward runs on a side stream, where autograd then runs the
    backward, so the capture holds only the backward's kernels. ``copies``
    > 1: as many forwards on copies of the inputs, their backwards in turn
    (``rotating``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    runs = []
    with torch.cuda.stream(side):
        for args in copies_of([*inputs, grad], copies):
            xs = [x.detach().requires_grad_() for x in args[:-1]]
            runs.append((forward(*xs), xs, args[-1]))
    return cuda_graph_time_ms(rotating(lambda out, xs, g: torch.autograd.grad(out, xs, g, retain_graph=True), runs),
                              stream=side)


def sdpa_bwd_ms(q, k, v, do, **sdpa_kw):
    """Device ms of the backward of one ``scaled_dot_product_attention``
    (dq, dk and dv together) on [B, L, H, hd] q, k, v and dO, by graph
    replay (``library_bwd_ms``)."""
    import torch.nn.functional as F

    return library_bwd_ms(lambda *x: F.scaled_dot_product_attention(*x, **sdpa_kw),
                          [x.transpose(1, 2) for x in (q, k, v)], do.transpose(1, 2))


def flash_times(kernel, plain, args, kw):
    """Device ms by graph replay of a flash wrapper (forward or backward) on
    its route (``ms``), forced onto the CUDA-core route (``simt_ms``), and
    its plain version (``plain_ms``; fewer calls a graph: it materializes
    [B, H, T, S])."""
    from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa

    ms = cuda_graph_time_ms(lambda: kernel(*args, **kw))
    with mock.patch.object(fa, "_route", lambda *a: "simt"):
        simt_ms = cuda_graph_time_ms(lambda: kernel(*args, **kw))
    return dict(ms=ms, simt_ms=simt_ms, plain_ms=cuda_graph_time_ms(lambda: plain(*args, **kw), iters=5, replays=2))


def build():
    from smdistributed_modelparallel_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(KERNEL_SOURCES)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = _kernel_name(line)
            elif any(w in line for w in ("registers", "spill", "warning", "Performance")):
                log(f"[build] {name}: {kernel}: {line.strip()}")
    log(f"[build] {len(KERNEL_SOURCES)} source(s) built in {secs:.1f} s")
    # Tensor-core instructions in each kernel's machine code (HGMMA: wgmma on
    # 16-bit operands, QGMMA: on fp8), where the toolkit has cuobjdump.
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        for name in KERNEL_SOURCES:
            sass = subprocess.run([cuobjdump, "-sass", str(_build._target(name)[1])], capture_output=True,
                                  text=True).stdout
            log(f"[build] {name}: {sass.count('HGMMA')} HGMMA, {sass.count('QGMMA')} QGMMA instructions (cuobjdump)")
            for section in sass.split("Function : ")[1:]:
                if "GMMA" in section:
                    log(f"[build] {name}:   {_kernel_name(section.splitlines()[0])}: {section.count('HGMMA')} HGMMA, "
                        f"{section.count('QGMMA')} QGMMA")


def _kernel_name(mangled):
    """The kernel's name and template arguments from a mangled symbol in
    nvcc's or cuobjdump's output."""
    m = re.search(r"_ZN?(\d+)", mangled)
    if not m:
        return mangled.strip()[:80]
    at = m.end() + int(m.group(1))
    name = mangled[m.end():at]
    if name.startswith("_GLOBAL__N"):  # an anonymous namespace: the kernel's name follows
        m = re.match(r"\d+", mangled[at:])
        name, at = mangled[at + m.end():at + m.end() + int(m.group())], at + m.end() + int(m.group())
    targs = re.match(r"I((?:13__nv_bfloat16|6__half|f|Li\d+E|Lb[01]E)+)E", mangled[at:])
    if not targs:
        return name
    names = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32", "Lb0E": "false", "Lb1E": "true"}
    args = [names.get(a, a[2:-1]) for a in re.findall(r"13__nv_bfloat16|6__half|Li\d+E|Lb[01]E|f", targs.group(1))]
    return f"{name}<{', '.join(args)}>"


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

    flash_attention.launches = flash_attention.simt_launches = 0
    _, prefill_ms = timed(lambda: smp.generate(model, prompts, 1))
    greedy, greedy_ms = timed(lambda: smp.generate(model, prompts, NEW))
    sampled, sampled_ms = timed(lambda: smp.generate(
        model, prompts, NEW, rng=torch.Generator(device="cuda").manual_seed(SEED), **sample_kw))
    launches = {"flash_fwd": flash_attention.launches, "flash_fwd_simt": flash_attention.simt_launches}
    n_prefills = 3

    decode_ms_per_token = (greedy_ms - prefill_ms) / (NEW - 1)
    tokens_per_s = B * NEW / (greedy_ms / 1e3)
    log(f"[A] prefill (generate, 1 new token) {prefill_ms:.2f} ms  B={B} T={T}")
    log(f"[A] greedy generate {NEW} tokens {greedy_ms:.2f} ms; decode {decode_ms_per_token:.3f} ms/token; "
        f"{tokens_per_s:.1f} tokens/s")
    log(f"[A] sampled generate {NEW} tokens {sampled_ms:.2f} ms")
    log(f"[A] launches on the main path: {launches} over {n_prefills} prefills of {n_layers} layers")

    if launches["flash_fwd"] < n_layers * n_prefills:
        raise RuntimeError(f"flash_fwd launched {launches['flash_fwd']} times on the tensor cores, expected >= "
                           f"{n_layers * n_prefills}")
    _check_route("serving path", launches)
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


TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB = 8, 1024, 4
TRAIN_WARMUP, TRAIN_STEPS = 2, 12


def _train_setup(module, microbatches, bf16, device, **cfg):
    """``bench.py``'s framework training: smp.init (with ``cfg`` added), the
    model, AdamW with optax.adamw's defaults (weight decay 1e-4, eps 1e-8),
    and the loss-mode step (mean loss over the predicted positions)."""
    import smdistributed_modelparallel_tpu_torch as smp

    smp.init({"microbatches": microbatches, "bf16": bf16, "fused_step_donation": True, **cfg})
    model = smp.DistributedModel(module, device=device)
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, batch_ids):
        tgt = torch.cat([batch_ids[:, 1:], torch.full_like(batch_ids[:, :1], -100)], dim=1)
        per = model(batch_ids, targets=tgt)
        loss = per.sum() / (per.shape[0] * (per.shape[1] - 1))
        model.backward(loss)
        return loss

    return model, optimizer, train_step


def phase_t():
    """The training path through the public entry points."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_124m, init_gpt2_weights_

    g = torch.Generator(device="cuda").manual_seed(SEED)
    module = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
    model, optimizer, train_step = _train_setup(module, TRAIN_MB, True, "cuda")
    n_layers = len(module.layers)
    ids = torch.randint(0, module.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(train_step(model, ids).reduce_mean())
        optimizer.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {**_flash_counters(), **_flash_simt_counters()}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(train_step(model, ids).reduce_mean())
        optimizer.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    per_step = n_layers * TRAIN_MB
    log(f"[T] GPT-2 124M bf16 training, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} microbatches: "
        f"{ms:.2f} ms/step, {1e3 / ms:.3f} steps/s, {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tokens/s "
        f"(mean of {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up); peak device memory {peak_gib:.2f} GiB")
    log(f"[T] loss: first {losses[0]:.4f}, last {losses[-1]:.4f} over {len(losses)} steps")
    log(f"[T] launches on the main path: {launches} over {TRAIN_STEPS} steps "
        f"(expected {per_step} each per step: {n_layers} layers x {TRAIN_MB} microbatches)")
    for name in _flash_counters():  # .launches: the tensor-core route's counts
        if launches[name] != per_step * TRAIN_STEPS:
            raise RuntimeError(f"{name} launched {launches[name]} times in {TRAIN_STEPS} steps, "
                               f"expected {per_step * TRAIN_STEPS}")
    _check_route("training path", launches)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training loss did not fall or is not finite: {losses}")

    # Small fp32 model: 3 steps on the card (kernel path, T = 128) and on the
    # CPU (plain path) from the same weights and batch.
    small = init_gpt2_weights_(gpt2("gpt2_124m", max_len=128, d_model=128, n_layers=2, n_heads=4),
                               torch.Generator().manual_seed(SEED))
    ids_s = torch.randint(0, small.vocab_size, (4, 128), generator=torch.Generator().manual_seed(SEED))
    runs = {}
    for device in ("cuda", "cpu"):
        m, opt, step_fn = _train_setup(copy.deepcopy(small), 4, False, device)
        ls = []
        for _ in range(3):
            ls.append(float(step_fn(m, ids_s).reduce_mean()))
            opt.step()
        runs[device] = (ls, {k: v.detach().cpu() for k, v in m.state_dict().items()})
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    param_err = max(float((runs["cuda"][1][k] - v).abs().max()) for k, v in runs["cpu"][1].items())
    log(f"[T] fp32 small model (d 128, 2 layers, seq 128), 3 steps, card vs CPU: losses {runs['cuda'][0]} vs "
        f"{runs['cpu'][0]}, max rel diff {loss_rel:.3e} (limit 1e-4); params max |diff| {param_err:.3e}")
    # fp32 throughout; only the summation order differs. The parameters are
    # reported, not limited: AdamW's first steps move a parameter by ~lr
    # whatever its gradient's size, so a gradient that is zero but for
    # rounding (the key bias: softmax ignores a per-row shift) moves by up
    # to lr in a direction the rounding picks, without moving the loss.
    if loss_rel > 1e-4:
        raise RuntimeError("the card's fp32 training step disagrees with the CPU's")
    smp.reset()
    return launches, dict(ms=ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, first_loss=losses[0],
                          last_loss=losses[-1])


CAP_BATCH, CAP_SEQ = 32, 1024  # one microbatch of 32k tokens: 3.1 GB of bf16 logits
CAP_WARMUP, CAP_STEPS = 1, 3


def _ce_counters():
    from smdistributed_modelparallel_tpu_torch.ops.fused_ce import (
        fused_ce_bwd_dw,
        fused_ce_bwd_dx,
        fused_ce_fwd,
    )

    return {"fused_ce_fwd": fused_ce_fwd, "fused_ce_bwd_dx": fused_ce_bwd_dx, "fused_ce_bwd_dw": fused_ce_bwd_dw}


def _ce_simt_counters():
    """The CUDA-core routes of the fused-CE kernels (forward, dx, dW): the
    capacity path's bf16 shapes take the tensor cores and launch none of
    them."""
    return {k + "_simt": _SimtCounter(fn) for k, fn in _ce_counters().items()}


def _flash_counters():
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def _capacity_run(init, ids, **cfg):
    """Train a copy of ``init`` on ``ids`` in one microbatch: warm-up steps,
    then timed steps whose kernel launches are counted."""
    model, optimizer, train_step = _train_setup(copy.deepcopy(init), 1, True, "cuda", **cfg)
    losses = []
    for _ in range(CAP_WARMUP):
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
    counters = {**_flash_counters(), **_ce_counters(), **_ce_simt_counters(), **_flash_simt_counters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(CAP_STEPS):
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / CAP_STEPS
    out = dict(ms=ms, tokens_per_s=ids.numel() / ms * 1e3, losses=losses,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={name: fn.launches for name, fn in counters.items()})
    del model, optimizer, train_step
    torch.cuda.empty_cache()
    return out


def phase_f():
    """The capacity path: GPT-2 124M trained on 32 x 1024 tokens in one
    microbatch, where the default ``fused_ce: "auto"`` policy engages the
    fused cross-entropy kernels; the same steps with ``fused_ce: False``
    (materialized logits); and a small fp32 model under ``fused_ce: True``
    on the card and on the CPU."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.nn import cross_entropy as port_ce
    from smdistributed_modelparallel_tpu_torch.ops.fused_ce import fused_ce_ok

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
    n_layers = len(init.layers)
    ids = torch.randint(0, init.vocab_size, (CAP_BATCH, CAP_SEQ), generator=g, device="cuda")
    tokens = CAP_BATCH * CAP_SEQ

    smp.init({"microbatches": 1, "bf16": True})
    probe = torch.empty((tokens, init.config["d_model"]), dtype=torch.bfloat16, device="cuda")
    logits_mb = tokens * init.vocab_size * 2 / 2**20
    if not (port_ce._want_fused_ce(probe, init.wte.weight) and fused_ce_ok(probe, init.wte.weight)):
        raise RuntimeError(f"the default fused_ce policy does not engage the kernels at {logits_mb:.0f} MB of logits")
    log(f"[F] default fused_ce \"auto\" engages the fused CE kernels: [{tokens}, {init.vocab_size}] bf16 "
        f"logits would be {logits_mb:.1f} MB > {smp.state.cfg.fused_ce_auto_threshold_mb} MB")
    del probe

    fused = _capacity_run(init, ids)
    materialized = _capacity_run(init, ids, fused_ce=False)
    for label, run in (("fused (auto)", fused), ("materialized (fused_ce: False)", materialized)):
        log(f"[F] GPT-2 124M bf16, {CAP_BATCH} x {CAP_SEQ} tokens in 1 microbatch, {label}: {run['ms']:.2f} ms/step, "
            f"{run['tokens_per_s']:.1f} tokens/s (mean of {CAP_STEPS} steps after {CAP_WARMUP} warm-up); "
            f"peak device memory {run['peak_gib']:.2f} GiB; losses {run['losses']}")
    launches = fused["launches"]
    log(f"[F] launches on the capacity path: {launches} over {CAP_STEPS} steps (expected per step: "
        f"{n_layers} of each flash kernel, 1 of each CE kernel, all on the tensor cores)")
    want = {**{k: n_layers * CAP_STEPS for k in _flash_counters()}, **{k: CAP_STEPS for k in _ce_counters()},
            **{k: 0 for k in {**_ce_simt_counters(), **_flash_simt_counters()}}}  # all on the tensor cores
    if launches != want:
        raise RuntimeError(f"capacity path launches {launches}, expected {want}")
    if any(materialized["launches"][k] for k in _ce_counters()):
        raise RuntimeError(f"fused_ce: False launched CE kernels: {materialized['launches']}")
    losses = fused["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"capacity training loss did not fall or is not finite: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, materialized["losses"])]
    log(f"[F] fused vs materialized losses: step 1 rel diff {rel[0]:.3e} (limit 2e-3), max over "
        f"{len(rel)} steps {max(rel):.3e} (limit 1e-2)")
    # Step 1 differs only in the CE: the materialized path rounds the logits
    # to bf16 before its fp32 softmax, the kernels keep them fp32. Later
    # steps add bf16 gradients summed in other orders, moved by AdamW. This
    # is a smoke check only: at initialization the logits are ~0.02-scale,
    # so a wrong kernel could still pass it; the head gradients below, and
    # phase C's comparison at this shape, hold the kernels themselves.
    if rel[0] > 2e-3 or max(rel) > 1e-2:
        raise RuntimeError("the fused and materialized capacity runs disagree")
    head_err = _capacity_head_grads(init, ids)

    # Small fp32 model, fused_ce: True: the kernels on the card, the
    # materialized path (with its warning) on the CPU.
    small = init_gpt2_weights_(gpt2("gpt2_124m", max_len=128, d_model=128, n_layers=2, n_heads=4),
                               torch.Generator().manual_seed(SEED))
    ids_s = torch.randint(0, small.vocab_size, (4, 128), generator=torch.Generator().manual_seed(SEED))
    runs = {}
    ce = {**_ce_counters(), **_ce_simt_counters()}
    for device in ("cuda", "cpu"):
        before = {k: fn.launches for k, fn in ce.items()}
        m, opt, step_fn = _train_setup(copy.deepcopy(small), 4, False, device, fused_ce=True)
        ls = []
        for _ in range(3):
            ls.append(float(step_fn(m, ids_s).reduce_mean()))
            opt.step()
        runs[device] = (ls, {k: fn.launches - before[k] for k, fn in ce.items()})
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    log(f"[F] fp32 small model (d 128, 2 layers, seq 128), fused_ce: True, 3 steps, card (CE kernels, launches "
        f"{runs['cuda'][1]}) vs CPU (materialized): losses {runs['cuda'][0]} vs {runs['cpu'][0]}, max rel diff "
        f"{loss_rel:.3e} (limit 1e-4)")
    # fp32 throughout; only the summation order differs. fp32 runs all three
    # CE kernels on the CUDA cores: 12 launches each there, none on the
    # tensor cores.
    want_small = {k: 12 if k.endswith("_simt") else 0 for k in ce}
    if loss_rel > 1e-4 or runs["cuda"][1] != want_small:
        raise RuntimeError("the card's fp32 fused-CE training disagrees with the CPU's")
    smp.reset()
    return launches, dict(fused=fused, materialized=materialized, head_err=head_err)


def _capacity_head_grads(init, ids):
    """One step of the tied head at the capacity shape, from the model's own
    bf16 hidden states: the loss gradient of the hidden states and of
    ``wte.weight`` under the default policy (the fused-CE kernels) against
    ``fused_ce: False`` (materialized logits). Returns the relative errors."""
    import smdistributed_modelparallel_tpu_torch as smp

    module = copy.deepcopy(init).to(torch.bfloat16)
    smp.init({"microbatches": 1, "bf16": True})
    with torch.no_grad():
        h = module.embed(ids)
        for layer in module.layers:
            h = layer(h)
    tgt = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)], dim=1)
    ce = {**_ce_counters(), **_ce_simt_counters()}
    grads = {}
    for label, cfg in (("fused", {}), ("materialized", {"fused_ce": False})):
        smp.init({"microbatches": 1, "bf16": True, **cfg})
        before = {k: fn.launches for k, fn in ce.items()}
        hx = h.detach().requires_grad_()
        per = module.head(hx, tgt)
        loss = per.sum() / (ids.shape[0] * (ids.shape[1] - 1))
        grads[label] = [float(loss.detach())] + list(torch.autograd.grad(loss, (hx, module.wte.weight)))
        ran = {k: fn.launches - before[k] for k, fn in ce.items()}
        for k, fn in ce.items():
            fn.launches = before[k]  # comparison launches do not count
        want = {k: int(label == "fused" and not k.endswith("_simt")) for k in ce}  # dx, dW on tensor cores
        if ran != want:
            raise RuntimeError(f"{label} head launched CE kernels {ran}, expected {want}")
        del per, loss, hx
    errs = {}
    for i, name in ((1, "hidden"), (2, "wte.weight")):
        a, b = grads["fused"][i].float(), grads["materialized"][i].float()
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"non-finite fused {name} gradient")
        errs[name] = float((a - b).abs().max() / b.abs().max())
    loss_rel = abs(grads["fused"][0] - grads["materialized"][0]) / abs(grads["materialized"][0])
    log(f"[F] tied head, one step at [{ids.numel()}, {init.vocab_size}], fused vs materialized: loss rel diff "
        f"{loss_rel:.3e}; max |dgrad| / max |grad|: hidden {errs['hidden']:.3e}, wte.weight "
        f"{errs['wte.weight']:.3e} (limit 2e-2)")
    # Both gradients come back in bf16; the materialized path also rounds the
    # logits and their gradient to bf16, so a few bf16 ulps of the largest
    # gradient. A kernel that dropped the target term or scaled g would be
    # off by the gradient's own size.
    if max(errs.values()) > 2e-2:
        raise RuntimeError(f"the fused head's gradients disagree with the materialized head's: {errs}")
    del grads, h, module
    torch.cuda.empty_cache()
    return errs


# GPT-2 124M as nn/huggingface/gpt2.config_to_smp gives it for GPT-2 small,
# with the fused bias-GELU on and the dropouts off (bench.py:641-649).
LM_CFG = dict(
    num_layers=12, num_attention_heads=12, attention_head_size=64, hidden_size=768, intermediate_size=3072,
    vocab_size=50257, num_positions=1024, causal_mask_size=1024, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, activation="gelu", layernorm_epsilon=1e-5, initializer_range=0.02,
    attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
# Gradients held fused against unfused after one step, from the same weights.
LM_GRADS = [f"transformer.seq_layers.{i}.{m}.{p}" for i in (0, 11) for m in ("attention.qkv", "output.fc")
            for p in ("weight", "bias")]
# Fused against unfused, bf16: the fused QKV rounds x w + b once, the
# unfused product and its bias add round twice, and the fused GELU rounds
# gelu(x + b) once from fp32 where the unfused add rounds x + b first; so
# the two runs differ by bf16 roundings (2**-8 relative) of every qkv and fc
# output, compounded over 12 layers. Step 1's loss: 5e-3 relative; over the
# steps AdamW moves each parameter by ~lr whatever its gradient's size, so
# 2e-2. Gradients: 5e-2 of their largest value (a transposed or wrong kernel
# is off by the gradient's own size).
LM_LOSS1_TOL, LM_LOSS_TOL, LM_GRAD_TOL = 5e-3, 2e-2, 5e-2


def _new_counters():
    from smdistributed_modelparallel_tpu_torch.ops.bias_gelu import bias_gelu_bwd, bias_gelu_fwd
    from smdistributed_modelparallel_tpu_torch.ops.matmul_bias import matmul_bias_fwd

    return {"matmul_bias": matmul_bias_fwd, "bias_gelu_fwd": bias_gelu_fwd, "bias_gelu_bwd": bias_gelu_bwd}


def _fp8_counters():
    from smdistributed_modelparallel_tpu_torch.ops.matmul_fp8 import matmul_fp8

    return {"matmul_fp8": matmul_fp8}


class _SimtCounter:
    """The CUDA-core route's launch count of a wrapper (``.simt_launches``),
    read and set as ``.launches`` like the other counters."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.simt_launches

    @launches.setter
    def launches(self, n):
        self.fn.simt_launches = n


def _simt_counters():
    """The CUDA-core routes of ``matmul_bias``, ``matmul_fp8`` and the flash
    kernels (forward and backward, plain and ids mode): the main paths'
    shapes must take the tensor cores and launch none of them."""
    wrappers = (*_new_counters().items(), *_fp8_counters().items(), *_flash_route_counters().items())
    return {k + "_simt": _SimtCounter(fn) for k, fn in wrappers if hasattr(fn, "simt_launches")}


def _flash_route_counters():
    """The flash wrappers, forward and backward, plain and ids mode (two
    routes each)."""
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention, flash_fwd_with_ids

    return {"flash_fwd": flash_attention, "flash_fwd_ids": flash_fwd_with_ids, **_bwd_counters()}


def _bwd_counters():
    """The flash backward wrappers, plain and ids mode (two routes each)."""
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_ids,
        flash_bwd_dq,
        flash_bwd_dq_ids,
    )

    return {"flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv, "flash_bwd_dq_ids": flash_bwd_dq_ids,
            "flash_bwd_dkv_ids": flash_bwd_dkv_ids}


def _flash_simt_counters():
    """The flash wrappers' CUDA-core routes (forward and backward, plain and
    ids mode): every main path's flash kernels run on the tensor cores, so
    these stay at 0."""
    return {k: c for k, c in _simt_counters().items() if k.startswith("flash_")}


def _check_route(label, launches):
    """Raise unless ``launches`` (counts by name) holds no CUDA-core launch
    (no ``*_simt`` count above 0)."""
    simt = {k: n for k, n in launches.items() if k.endswith("_simt") and n}
    if simt:
        raise RuntimeError(f"{label}: launches on the CUDA-core route: {simt}")


def _route_taken(fn, before, fast="wgmma"):
    """Which route ``fn`` (a wrapper with ``.launches``, counting its route
    ``fast``, and ``.simt_launches``) launched since its counts were
    ``before``."""
    moved = (fn.launches - before[0], fn.simt_launches - before[1])
    return {(1, 0): fast, (0, 1): "simt"}.get(moved, f"launches moved by {moved}")


def _lm_setup(init_state, fused, device, cfg=LM_CFG, microbatches=TRAIN_MB, bf16=True, **smp_cfg):
    """``smp.nn.DistributedTransformerLMHead`` of ``cfg`` loaded with
    ``init_state``, under ``fused_qkv`` and ``fused_bias_gelu`` = ``fused``
    (and ``smp_cfg``'s keys), with AdamW (optax.adamw's defaults) and the
    smp.nn training step of bench.py:653-660 (logits mode, mean CE of the
    shifted tokens)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn import vocab_parallel_cross_entropy

    smp.init({"microbatches": microbatches, "bf16": bf16, "fused_qkv": fused, **smp_cfg})
    module = smp.nn.DistributedTransformerLMHead(**cfg, fused_bias_gelu=fused, device="meta")
    module.load_state_dict({k: v.clone() for k, v in init_state.items()}, assign=True)
    model = smp.DistributedModel(module, device=device)
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids):
        logits = model(ids)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    return model, optimizer, train_step


def _lm_run(init_state, ids, fused, **smp_cfg):
    """Train from ``init_state`` on ``ids``: the first step's gradients of
    LM_GRADS, then warm-up and timed steps whose launches are counted; the
    quant state after the last step (None outside fp8)."""
    import smdistributed_modelparallel_tpu_torch as smp

    model, optimizer, train_step = _lm_setup(init_state, fused, "cuda", **smp_cfg)
    losses = [float(train_step(model, ids).reduce_mean())]
    grads = {n: model.grads[n].detach().clone() for n in LM_GRADS}
    optimizer.step()
    for _ in range(TRAIN_WARMUP - 1):
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
    counters = {**_flash_counters(), **_new_counters(), **_fp8_counters(), **_simt_counters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(train_step(model, ids).reduce_mean())
        optimizer.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    qs = smp.state.quant_state
    out = dict(ms=ms, tokens_per_s=ids.numel() / ms * 1e3, losses=[float(x) for x in losses], grads=grads,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={name: fn.launches for name, fn in counters.items()},
               quant=None if qs is None else qs.state_dict())
    del model, optimizer, train_step
    torch.cuda.empty_cache()
    return out


def phase_l():
    """The smp.nn path: GPT-2 124M as ``smp.nn.DistributedTransformerLMHead``
    trained under ``fused_qkv`` and ``fused_bias_gelu`` (the matmul_bias and
    bias_gelu kernels), its unfused twin, and a small fp32 model on the card
    and on the CPU."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    n_layers = LM_CFG["num_layers"]
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")

    fused = _lm_run(init_state, ids, True)
    unfused = _lm_run(init_state, ids, False)
    for label, run in (("fused (fused_qkv, fused_bias_gelu)", fused), ("unfused twin", unfused)):
        log(f"[L] smp.nn GPT-2 124M bf16 training, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} "
            f"microbatches, {label}: {run['ms']:.2f} ms/step, {run['tokens_per_s']:.1f} tokens/s (mean of "
            f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up); peak device memory {run['peak_gib']:.2f} GiB")
        log(f"[L]   losses {run['losses']}")
        log(f"[L]   launches over {TRAIN_STEPS} steps: {run['launches']}")
    per_step = n_layers * TRAIN_MB
    want = {**{k: per_step * TRAIN_STEPS for k in {**_flash_counters(), **_new_counters()}}, "matmul_fp8": 0,
            **{k: 0 for k in _simt_counters()}}  # the tensor-core route: no CUDA-core launch
    if fused["launches"] != want:
        raise RuntimeError(f"smp.nn path launches {fused['launches']}, expected {want}")
    if any(unfused["launches"][k] for k in {**_new_counters(), **_fp8_counters(), **_simt_counters()}):
        raise RuntimeError(f"the unfused twin launched fused kernels: {unfused['launches']}")
    losses = fused["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"smp.nn training loss did not fall or is not finite: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, unfused["losses"])]
    grad_err = {n: float((fused["grads"][n] - unfused["grads"][n]).abs().max() / unfused["grads"][n].abs().max())
                for n in LM_GRADS}
    log(f"[L] fused vs unfused losses: step 1 rel diff {rel[0]:.3e} (limit {LM_LOSS1_TOL:.0e}), max over "
        f"{len(rel)} steps {max(rel):.3e} (limit {LM_LOSS_TOL:.0e})")
    log(f"[L] fused vs unfused step-1 gradients, max |d| / max |grad|: "
        + ", ".join(f"{n.removeprefix('transformer.seq_layers.')} {e:.3e}" for n, e in grad_err.items())
        + f" (limit {LM_GRAD_TOL:.0e})")
    if rel[0] > LM_LOSS1_TOL or max(rel) > LM_LOSS_TOL or max(grad_err.values()) > LM_GRAD_TOL:
        raise RuntimeError("the fused and unfused smp.nn runs disagree")
    if not all(bool(torch.isfinite(g).all()) for g in fused["grads"].values()):
        raise RuntimeError("non-finite fused gradients")

    # Small fp32 model under both knobs: the kernels on the card, the unfused
    # path on the CPU (the gates are off there; in fp32 it computes the same
    # function). T = 128 so the flash kernels run on the card too.
    small_cfg = dict(LM_CFG, num_layers=2, num_attention_heads=4, attention_head_size=32, hidden_size=128,
                     intermediate_size=512, vocab_size=97, num_positions=128, causal_mask_size=128)
    small = init_weights_(smp.nn.DistributedTransformerLMHead(**small_cfg), 0.02,
                          torch.Generator().manual_seed(SEED))
    small_state = small.state_dict()
    ids_s = torch.randint(0, 97, (4, 128), generator=torch.Generator().manual_seed(SEED))
    runs = {}
    new = {**_new_counters(),
           **{k: c for k, c in _simt_counters().items() if k.startswith(("matmul_bias", "bias_gelu"))}}
    for device in ("cuda", "cpu"):
        before = {k: fn.launches for k, fn in new.items()}
        m, opt, step_fn = _lm_setup(small_state, True, device, small_cfg, microbatches=2, bf16=False)
        ls = []
        for _ in range(3):
            ls.append(float(step_fn(m, ids_s).reduce_mean()))
            opt.step()
        runs[device] = (ls, {k: v.detach().cpu() for k, v in m.state_dict().items()},
                        {k: fn.launches - before[k] for k, fn in new.items()})
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    param_err = max(float((runs["cuda"][1][k] - v).abs().max()) for k, v in runs["cpu"][1].items())
    log(f"[L] fp32 small smp.nn model (d 128, 2 layers, seq 128), both knobs, 3 steps, card (launches "
        f"{runs['cuda'][2]}) vs CPU: losses {runs['cuda'][0]} vs {runs['cpu'][0]}, max rel diff {loss_rel:.3e} "
        f"(limit 1e-4); params max |diff| {param_err:.3e} (limit 1e-3)")
    # fp32 throughout; only the summation order differs. AdamW moves a
    # parameter whose gradient is zero but for rounding (the key bias) by up
    # to ~lr a step in a direction the rounding picks: 3 steps, 2 lr each.
    # fp32 operands take matmul_bias's CUDA-core route (no TF32); the
    # bias-GELU kernels their "vec" route (rows of 2048 bytes).
    want_small = {k: 3 * 2 * 2 if k in ("matmul_bias_simt", "bias_gelu_fwd", "bias_gelu_bwd") else 0 for k in new}
    if loss_rel > 1e-4 or param_err > 1e-3 or runs["cuda"][2] != want_small or any(runs["cpu"][2].values()):
        raise RuntimeError("the card's fp32 smp.nn training disagrees with the CPU's")
    smp.reset()
    return fused["launches"], dict(fused=fused, unfused=unfused)


# The 11 slots the smp.nn path observes under fp8 (SITE_SLOTS less the
# linear_* and ring_* seams of the tensor-parallel layers).
FP8_LIVE_SLOTS = {"qkv.x", "qkv.w", "attn_proj.x", "attn_proj.w", "mlp_fc.x", "mlp_fc.w", "mlp_proj.x",
                  "mlp_proj.w", "gelu_in.x", "attn_q.x", "attn_k.x"}
# fp8 against bf16, every step: the JAX package's gate (tests/test_quant.py,
# rtol 2e-2 on the loss trajectory).
FP8_LOSS_TOL = 2e-2
# The small fp32 model, card against CPU, 3 AdamW steps. Only the fp32
# summation order differs, but that can move an activation across an e4m3 or
# e5m2 rounding boundary, and AdamW then moves a parameter whose gradient
# differs in sign by up to 2 lr a step whatever the gradient's size: after
# two updates up to 4e-4 against weights whose largest is ~0.1, so their
# maxima, and the activations', by up to ~0.5%. Losses 1e-3 relative; the
# first step's amax column (the same weights) 1e-5; the whole quant state
# 2e-2 (measured 8.9e-3 on an H100).
FP8_SMALL_TOL = dict(loss=1e-3, first=1e-5, state=2e-2)


@contextlib.contextmanager
def _fused_branch_on_cpu():
    """Send CPU tensors down the fused branch (the ``_is_cuda`` seams of the
    fused QKV and bias-GELU gates), so the CPU runs the kernels' plain
    versions where the card runs the kernels."""
    from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
    from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

    with mock.patch.object(mb, "_is_cuda", lambda t: True), mock.patch.object(bg, "_is_cuda", lambda t: True):
        yield


def phase_q():
    """fp8 delayed-scaling training on the smp.nn path: phase L's model,
    weights and batch under ``matmul_precision: fp8`` with both fused knobs
    (the fused QKV's fp8 product through ``matmul_fp8``), against the bf16
    fused step from the same weights; and a small fp32 model under fp8 on the
    card and on the CPU."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    n_layers = LM_CFG["num_layers"]
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")

    base = _lm_run(init_state, ids, True)
    fp8 = _lm_run(init_state, ids, True, matmul_precision="fp8")
    for label, run in (("fp8 (matmul_precision: fp8)", fp8), ("bf16", base)):
        log(f"[Q] smp.nn GPT-2 124M training, both fused knobs, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
            f"{TRAIN_MB} microbatches, {label}: {run['ms']:.2f} ms/step, {run['tokens_per_s']:.1f} tokens/s (mean "
            f"of {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up); peak device memory {run['peak_gib']:.2f} GiB")
        log(f"[Q]   losses {run['losses']}")
        log(f"[Q]   launches over {TRAIN_STEPS} steps: {run['launches']}")
    per_step = n_layers * TRAIN_MB
    want = {**{k: per_step * TRAIN_STEPS for k in {**_flash_counters(), **_new_counters(), **_fp8_counters()}},
            "matmul_bias": 0, **{k: 0 for k in _simt_counters()}}  # the tensor-core route only
    if fp8["launches"] != want:
        raise RuntimeError(f"fp8 smp.nn path launches {fp8['launches']}, expected {want}")
    losses = fp8["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"fp8 training loss did not fall or is not finite: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, base["losses"])]
    log(f"[Q] fp8 vs bf16 losses: max rel diff over {len(rel)} steps {max(rel):.3e} (limit {FP8_LOSS_TOL:.0e}); "
        f"per step {[float(f'{r:.3e}') for r in rel]}")
    if max(rel) > FP8_LOSS_TOL:
        raise RuntimeError("the fp8 loss trajectory leaves the bf16 one")
    qs = fp8["quant"]
    moved = {s for s, sc in zip(qs["slots"], qs["scale"]) if sc != 1.0}
    idle = [i for i, s in enumerate(qs["slots"]) if s not in FP8_LIVE_SLOTS]
    log("[Q] quant state after the steps, newest amax / scale: " + ", ".join(
        f"{s} {h[0]:.4g}/{sc:.4g}" for s, h, sc in zip(qs["slots"], qs["amax_history"], qs["scale"])
        if s in FP8_LIVE_SLOTS))
    if moved != FP8_LIVE_SLOTS or (qs["amax_history"][idle] != 0).any():
        raise RuntimeError(f"fp8 slots that moved: {sorted(moved)}, expected {sorted(FP8_LIVE_SLOTS)}")

    # Small fp32 model under fp8 and both knobs: the kernels on the card, their
    # plain versions on the CPU (the fused branch, through the _is_cuda seams).
    small_cfg = dict(LM_CFG, num_layers=2, num_attention_heads=4, attention_head_size=32, hidden_size=128,
                     intermediate_size=512, vocab_size=97, num_positions=128, causal_mask_size=128)
    small = init_weights_(smp.nn.DistributedTransformerLMHead(**small_cfg), 0.02,
                          torch.Generator().manual_seed(SEED))
    small_state = small.state_dict()
    ids_s = torch.randint(0, 97, (4, 128), generator=torch.Generator().manual_seed(SEED))
    runs = {}
    counter = _fp8_counters()["matmul_fp8"]
    for device in ("cuda", "cpu"):
        before = counter.launches
        with _fused_branch_on_cpu() if device == "cpu" else contextlib.nullcontext():
            m, opt, step_fn = _lm_setup(small_state, True, device, small_cfg, microbatches=2, bf16=False,
                                        matmul_precision="fp8")
            ls = []
            for _ in range(3):
                ls.append(float(step_fn(m, ids_s).reduce_mean()))
                opt.step()
        runs[device] = (ls, smp.state.quant_state.state_dict(), counter.launches - before)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    q_gpu, q_cpu = runs["cuda"][1], runs["cpu"][1]

    def rel(a, b):
        return float((abs(a - b) / np.where(b != 0, abs(b), 1.0)).max())

    first_rel = rel(q_gpu["amax_history"][:, 2], q_cpu["amax_history"][:, 2])  # newest first: column 2 is step 1
    q_rel = max(rel(q_gpu[k], q_cpu[k]) for k in ("amax_history", "scale"))
    tol = FP8_SMALL_TOL
    log(f"[Q] fp32 small smp.nn model (d 128, 2 layers, seq 128) under fp8, 3 steps, card (matmul_fp8 launches "
        f"{runs['cuda'][2]}) vs CPU: losses {runs['cuda'][0]} vs {runs['cpu'][0]}, max rel diff {loss_rel:.3e} "
        f"(limit {tol['loss']:.0e}); quant state max rel diff: step 1's amax {first_rel:.3e} (limit "
        f"{tol['first']:.0e}), all {q_rel:.3e} (limit {tol['state']:.0e})")
    if loss_rel > tol["loss"] or first_rel > tol["first"] or q_rel > tol["state"] or runs["cuda"][2] != 3 * 2 * 2 \
            or runs["cpu"][2]:
        raise RuntimeError("the card's fp32 fp8 training disagrees with the CPU's")
    smp.reset()
    return fp8["launches"], dict(fp8=fp8, bf16=base)


def _inputs(B, T, S, H, hd, dtype, gen):
    q = torch.randn(B, T, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    return q, k, v


# (name, B, T, S, H, hd, kwargs). Tolerances below, per dtype.
CASES = [
    ("main_path_causal", 4, 512, 512, 12, 64, {}),
    ("train_path_causal", 2, 1024, 1024, 12, 64, {}),
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
# max, so O differs by a few bf16 ulps; LSE stays fp32. fp16 (FP16_CASES;
# the forward takes the tensor cores in fp16 too): the same flips move O by
# fp16 ulps, 2**-11 against bf16's 2**-8, so the bf16 limit over 8.
TOL = {torch.float32: dict(o=1e-4, lse=1e-4), torch.bfloat16: dict(o=2e-2, lse=1e-3),
       torch.float16: dict(o=2.5e-3, lse=1e-3)}
# The forward's tensor-core route against its CUDA-core route on the same
# inputs. Both walk the same 64-column tiles, so their running maxima agree,
# and both round p to the operand dtype at the same point; only the fp32
# scores' summation order differs (a 64-term dot product), which can flip the
# rounding of a p by one ulp of p (2**-7 of it in bf16, 2**-10 in fp16). A
# flip moves o by that ulp times |v| / l, all of them together by at most one
# ulp of max|v| (sum p / l <= 1), times 1 / (1 - rate) under dropout; o's own
# rounding to the dtype adds one more. So o within 2 ulps of max|v| / (1 -
# rate): FWD_SIMT_ULP[dtype] * 2 * max|v| / (1 - rate). lse: the row max
# moves with the scores' order (~64 * 2**-24 * sum |q_d k_d| * scale, ~2e-5
# here) and l, a sum of up to S fp32 terms, by at most S * 2**-24 of itself
# (2.4e-4 at S 4096): 1e-3.
FWD_SIMT_ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
FWD_SIMT_LSE = 1e-3
# Backward, as a share of the largest |grad| of the plain version. fp32: the
# same arithmetic in another summation order (~1e-6). bf16: ds and p are
# rounded to bf16 after fp32 products summed in another order, so a rounding
# flip moves a grad by a bf16 ulp of its scale. fp16 (FP16_CASES): the same
# flips move it by an fp16 ulp, 2**-11 against bf16's 2**-8, so the bf16
# limit over 8.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
MAIN_CASES = ("main_path_causal", "train_path_causal")  # bf16 only
# Also in fp16, forward and backward: the training shape, T != S, a window,
# fully-masked rows, dropout and a head dim the tensor cores do not take.
FP16_CASES = ("train_path_causal", "t_lt_s_causal", "causal_window", "kpad_fully_padded_rows", "dropout_head_remap",
              "hd128")


def flash_route(dtype, hd):
    """The route ``ops.flash_attention._route`` gives contiguous q, k, v
    (and dO): the tensor cores for fp16 and bf16 at hd 64."""
    return "wgmma" if dtype in (torch.bfloat16, torch.float16) and hd == 64 else "simt"


def fwd_check(run, want, wrapper, route, dtype, tol, v_max, rate=0.0):
    """A forward wrapper (``run()`` gives (o, lse) through ``wrapper``,
    ``flash_attention`` or ``flash_fwd_with_ids``) against the plain
    version's ``want``: o in its dtype, o and lse within ``tol``, on
    ``route``. On the
    tensor-core route also against the CUDA-core route forced on the same
    inputs (o within FWD_SIMT_ULP[dtype] * 2 * v_max / (1 - rate), lse within
    FWD_SIMT_LSE) and a second launch for equal bits. Returns (max |error|
    of o against the plain version, ok, detail)."""
    from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa

    before = (wrapper.launches, wrapper.simt_launches)
    o, lse = run()
    torch.cuda.synchronize()
    taken = _route_taken(wrapper, before)
    err_o = float((o.float() - want[0].float()).abs().max())
    err_lse = float((lse - want[1]).abs().max())
    ok = (taken == route and o.dtype == want[0].dtype and bool(torch.isfinite(o).all()) and err_o <= tol["o"]
          and err_lse <= tol["lse"])
    detail = (f"route {taken}; max|dO| {err_o:.2e} (tol {tol['o']:.1e}) max|dLSE| {err_lse:.2e} "
              f"(tol {tol['lse']:.1e}) against the plain version")
    if route == "wgmma":
        again = run()
        with mock.patch.object(fa, "_route", lambda *a: "simt"):
            simt = run()
        torch.cuda.synchronize()
        equal = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        lim = FWD_SIMT_ULP[dtype] * 2 * v_max / (1.0 - rate)
        e_o = float((o.float() - simt[0].float()).abs().max())
        e_lse = float((lse - simt[1]).abs().max())
        ok = ok and equal and e_o <= lim and e_lse <= FWD_SIMT_LSE
        detail += (f"; {e_o:.2e} (tol {lim:.1e}), {e_lse:.2e} (tol {FWD_SIMT_LSE:.0e}) against the CUDA-core route, "
                   f"repeat {'bit-equal' if equal else 'DIFFERS'}")
    return err_o, ok, detail


def bwd_check(run, want, wrappers, route, tol, per_output=False):
    """The backward kernels' wrappers (``run()`` gives (dq, dk, dv) through
    ``wrappers``, the dq and dk/dv wrapper) against the plain version's
    ``want``: each within ``tol`` of the largest |grad| (of its kernel's
    outputs, or with ``per_output`` of its own), and on ``route``. On the
    tensor-core route also against the CUDA-core route forced on the same
    inputs (same limit), and a second launch for equal bits. Returns
    ({wrapper name: max |error| against the plain version}, ok, detail)."""
    from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa

    before = [(w.launches, w.simt_launches) for w in wrappers]
    got = run()
    torch.cuda.synchronize()
    taken = [_route_taken(w, b) for w, b in zip(wrappers, before)]
    scales = [float(w.float().abs().max()) for w in want]
    if not per_output:
        scales = [scales[0]] + [max(scales[1:])] * 2

    def rel(outs):  # the largest error of any output against the plain version, per its scale
        return max(float((g.float() - w.float()).abs().max()) / max(sc, 1e-6)
                   for g, w, sc in zip(outs, want, scales))

    err_plain = rel(got)
    ok = all(bool(torch.isfinite(x).all()) for x in got) and taken == [route, route] and err_plain <= tol
    detail = f"route {'/'.join(taken)}; {err_plain:.2e} of max|grad| against the plain version"
    if route == "wgmma":
        again = run()
        with mock.patch.object(fa, "_route", lambda *a: "simt"):
            simt = run()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        err_simt = max(float((g.float() - c.float()).abs().max()) / max(sc, 1e-6)
                       for g, c, sc in zip(got, simt, scales))
        ok = ok and equal and err_simt <= tol
        detail += f", {err_simt:.2e} against the CUDA-core route, repeat {'bit-equal' if equal else 'DIFFERS'}"
    errs = {wrappers[0].__name__: float((got[0].float() - want[0].float()).abs().max()),
            wrappers[1].__name__: max(float((g.float() - w.float()).abs().max()) for g, w in zip(got[1:], want[1:]))}
    return errs, ok, detail + f" (tol {tol:.1e})"


def phase_b():
    """Every kernel against its plain version: the forward on every case
    (fwd_check), then the dq and dk/dv kernels on the same inputs, fed the
    plain forward's O and LSE and a random output gradient (bwd_check): the
    route each case takes, and on the tensor cores the CUDA-core route and a
    repeat launch; both also in fp16 on FP16_CASES."""
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    counters = {**_flash_route_counters(), **_flash_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    main_err, bwd_main_err, failures = None, {}, []
    for name, B, T, S, H, hd, kw in CASES:
        dtypes = [torch.bfloat16] if name in MAIN_CASES else [torch.float32, torch.bfloat16]
        if name in FP16_CASES:
            dtypes.append(torch.float16)
        for dtype in dtypes:
            q, k, v = _inputs(B, T, S, H, hd, dtype, gen)
            kw = dict(kw)
            if kw.get("kpad") == "left_and_full":
                kpad = torch.zeros(B, S, device="cuda")
                kpad[1, :50] = -1e30   # left padding: rows < 50 see only pad keys
                kpad[2, :] = -1e30     # a fully padded sequence
                kw["kpad_bias"] = kpad
                del kw["kpad"]
            tag = str(dtype).removeprefix("torch.")
            o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
            err_o, ok, detail = fwd_check(lambda: flash_attention(q, k, v, **kw), (o_ref, lse_ref), flash_attention,
                                          flash_route(dtype, hd), dtype, TOL[dtype], float(v.float().abs().max()),
                                          kw.get("dropout_rate", 0.0))
            log(f"[B] flash_fwd {name:32s} {tag:9s} {detail} {'ok' if ok else 'FAIL'}")
            if name == "main_path_causal":
                main_err = err_o
            if not ok:
                failures.append(f"flash_fwd/{name}/{tag}")

            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            delta = attention_delta(o_ref, do)
            want = flash_attention_bwd_reference(q, k, v, o_ref, do, lse_ref, **kw)
            errs, ok, detail = bwd_check(
                lambda: (flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw),) + flash_bwd_dkv(q, k, v, do, lse_ref, delta,
                                                                                           **kw),
                want, (flash_bwd_dq, flash_bwd_dkv), flash_route(dtype, hd), BWD_TOL[dtype])
            log(f"[B] flash_bwd dq, dk/dv {name:32s} {tag:9s} {detail} {'ok' if ok else 'FAIL'}")
            if name == "train_path_causal" and dtype == torch.bfloat16:
                bwd_main_err = errs
            if not ok:
                failures.append(f"flash_bwd/{name}/{tag}")
    for key, fn in counters.items():
        fn.launches = saved[key]  # comparison launches do not count
    _phase_b_ce(failures)
    new_err = _phase_b_new(failures)
    new_err["matmul_fp8"] = _phase_b_fp8(failures)
    new_err.update(_phase_b_ids(failures))
    if failures:
        raise RuntimeError(f"kernel disagrees with its plain version: {failures}")
    return main_err, bwd_main_err, new_err


# (name, N, V, D, kwargs) of the fused cross-entropy kernels. D 1600 (GPT-2
# 1.5B's width) is wider than any one tile; V 200 and N 1000 leave ragged
# tiles; "oob" puts targets outside [0, V); "gzeros" zeroes g on every fifth
# row (ignored rows).
CE_CASES = [
    ("gpt2_head_n2048", 2048, 50257, 768, {}),
    ("d1600_smoothing", 1000, 50257, 1600, dict(smoothing=0.1)),
    ("d64_denom_oob_gzeros", 1000, 200, 64, dict(smoothing=0.1, smooth_denom=333, oob=True, gzeros=True)),
    ("v200_d1600", 2048, 200, 1600, {}),
    ("d64_oob_gzeros", 1000, 50257, 64, dict(oob=True, gzeros=True)),
    ("n2048_d1600_denom_gzeros", 2048, 50257, 1600, dict(smoothing=0.1, smooth_denom=50304, gzeros=True)),
]
# The forward statistics are fp32 in every dtype (bf16 and fp16 products are
# exact in fp32; only the summation order differs): CE_FWD_TOL, 1e-4 of the
# largest value (at least 1), against the plain version and, on the tensor
# cores, against the CUDA-core route on the same inputs. dx and dW: fp32
# 1e-4; bf16 2e-2 of the largest value (they come back rounded to bf16 after
# fp32 sums in another order).
CE_FWD_TOL = 1e-4
CE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The CE backward's tensor-core route against its CUDA-core route on the same
# inputs: both round an fp32 sum once to bf16, so one bf16 ulp at the largest
# value (2^-8 of it, 3.9e-3) plus the order of the sums and the hi/lo residual
# of dlog (~2^-17): 8e-3 of max|grad|.
CE_SIMT_TOL = 8e-3


def ce_route(dtype, D):
    """The backward route ``ops.fused_ce._route`` gives contiguous x and w:
    the tensor cores for bf16 with D a multiple of 8 up to 2048."""
    return "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 and 0 < D <= 2048 else "simt"


def ce_fwd_route(dtype, D):
    """The forward route ``ops.fused_ce._fwd_route`` gives contiguous x and
    w: the tensor cores for bf16 and fp16 with D a multiple of 8."""
    return "wgmma" if dtype in (torch.bfloat16, torch.float16) and D % 8 == 0 else "simt"


def ce_inputs(N, V, D, dtype, gen, kw):
    """(x, w, targets, g) of a fused-CE case on ``gen``'s device: x [N, D]
    and w [V, D] in ``dtype``, g in [0, 1) fp32; ``kw`` as in CE_CASES."""
    x = torch.randn(N, D, generator=gen, device=gen.device).to(dtype)
    w = (0.1 * torch.randn(V, D, generator=gen, device=gen.device)).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device=gen.device)
    if kw.get("oob"):
        t[::7] = -3
        t[3::7] = V + 100
    g = torch.rand(N, generator=gen, device=gen.device)
    if kw.get("gzeros"):
        g[::5] = 0.0
    return x, w, t, g


def _ce_stat_errs(got, want):
    """{statistic: (max |error|, CE_FWD_TOL of the largest |value|, at least
    1)} of the forward's (lse, tgt, logit_sum or None)."""
    return {k: (float((a - b).abs().max()), CE_FWD_TOL * max(1.0, float(b.abs().max())))
            for k, a, b in zip(("lse", "tgt", "logit_sum"), got, want) if b is not None}


def _ce_compare(x, w, t, g, eps=0.0, denom=None, backward=True):
    """Each fused-CE kernel against its plain version on one input (dx and
    dW from the plain forward's lse; ``backward=False``: the forward alone):
    {kernel name: (max abs error, ok, detail)}. Tolerances as CE_FWD_TOL and
    CE_TOL state. Each kernel must take its route (``ce_fwd_route``,
    ``ce_route``); on the tensor cores each is also held against its
    CUDA-core kernel forced on the same inputs (CE_FWD_TOL, CE_SIMT_TOL) and
    a second launch must give equal bits."""
    from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fc

    fwd = fc.fused_ce_fwd
    before = (fwd.launches, fwd.simt_launches)
    got = fwd(x, w, t, eps)
    torch.cuda.synchronize()
    taken = _route_taken(fwd, before)
    want = fc.fused_ce_fwd_reference(x, w, t, eps)
    errs = _ce_stat_errs(got, want)
    finite = all(bool(torch.isfinite(a).all()) for a in got if a is not None)
    route = ce_fwd_route(x.dtype, x.shape[1])
    ok = finite and taken == route and all(e <= tol for e, tol in errs.values())
    detail = f"route {taken}; " + ", ".join(f"max|d{k}| {e:.2e} (tol {tol:.1e})" for k, (e, tol) in errs.items())
    if route == "wgmma":
        again = fwd(x, w, t, eps)
        with mock.patch.object(fc, "_fwd_route", lambda *a_: "simt"):
            simt = fwd(x, w, t, eps)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        errs_simt = _ce_stat_errs(got, simt)
        ok = ok and equal and all(e <= tol for e, tol in errs_simt.values())
        detail += (", against the CUDA-core route " + ", ".join(f"{e:.2e}" for e, _ in errs_simt.values())
                   + f", repeat {'bit-equal' if equal else 'DIFFERS'}")
    out = {"fused_ce_fwd": (max(e for e, _ in errs.values()), ok, detail)}
    if not backward:
        return out
    lse = want[0]
    route = ce_route(x.dtype, x.shape[1])
    for kname, fn, plain in (("fused_ce_bwd_dx", fc.fused_ce_bwd_dx, fc.fused_ce_bwd_dx_reference),
                             ("fused_ce_bwd_dw", fc.fused_ce_bwd_dw, fc.fused_ce_bwd_dw_reference)):
        before = (fn.launches, fn.simt_launches)
        a = fn(x, w, t, lse, g, eps, denom)
        torch.cuda.synchronize()
        taken = _route_taken(fn, before)
        b = plain(x, w, t, lse, g, eps, denom)
        scale = max(float(b.float().abs().max()), 1e-6)
        err = float((a.float() - b.float()).abs().max())
        ok = bool(torch.isfinite(a).all()) and taken == route and err <= CE_TOL[x.dtype] * scale
        detail = f"route {taken}; max|d{kname[-2:]}| {err:.2e} (tol {CE_TOL[x.dtype] * scale:.1e})"
        if route == "wgmma":
            again = fn(x, w, t, lse, g, eps, denom)
            with mock.patch.object(fc, "_route", lambda *a_: "simt"):
                simt = fn(x, w, t, lse, g, eps, denom)
            torch.cuda.synchronize()
            equal = torch.equal(a, again)
            err_simt = float((a.float() - simt.float()).abs().max()) / max(float(simt.float().abs().max()), 1e-6)
            ok = ok and equal and err_simt <= CE_SIMT_TOL
            detail += (f", {err_simt:.2e} of max|grad| against the CUDA-core route (tol {CE_SIMT_TOL:.0e}), "
                       f"repeat {'bit-equal' if equal else 'DIFFERS'}")
        out[kname] = (err, ok, detail)
    return out


def _phase_b_ce(failures):
    """The three fused-CE kernels against their plain versions over
    CE_CASES, in fp32 (all on the CUDA cores) and bf16 (all on the tensor
    cores), and the forward alone in fp16 (on the tensor cores)."""
    counters = {**_ce_counters(), **_ce_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, N, V, D, kw in CE_CASES:
        eps, denom = float(kw.get("smoothing", 0.0)), kw.get("smooth_denom")
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            tag = str(dtype).removeprefix("torch.")
            x, w, t, g = ce_inputs(N, V, D, dtype, gen, kw)
            for kname, (_, ok, detail) in _ce_compare(x, w, t, g, eps, denom, dtype != torch.float16).items():
                log(f"[B] {kname:15s} {name:26s} N={N} V={V} D={D} {tag:9s} {detail} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{kname}/{name}/{tag}")
    for k, fn in counters.items():
        fn.launches = saved[k]  # comparison launches do not count


# (name, N, D, F, kwargs) of the matmul_bias kernels: the fused QKV of the
# smp.nn path, no bias, few rows (a decode step's), ragged N, D and F (D 33:
# the CUDA-core route), GPT-2 1.5B's width (D 1600, F 4800), a bias with
# zeros, and ragged N and F on the tensor-core route (a partial last tile both
# ways; a partial last row tile at the path's F).
MB_CASES = [
    ("qkv_path", 2048, 768, 2304, {}),
    ("qkv_path_no_bias", 2048, 768, 2304, dict(bias=False)),
    ("few_rows_n8", 8, 768, 2304, {}),
    ("ragged_1000x33x17", 1000, 33, 17, {}),
    ("d1600_f4800", 512, 1600, 4800, {}),
    ("bias_zeros", 300, 64, 96, dict(zeros=True)),
    ("ragged_1000x768x2300", 1000, 768, 2300, {}),
    ("qkv_path_n2047", 2047, 768, 2304, {}),
]
# (name, N, F, kwargs) of the bias_gelu kernels: the MLP epilogue of the
# smp.nn path, few rows, ragged N and F (F % 8 != 0: the "simt" route),
# GPT-2 1.5B's intermediate width, b and g with zeros, x a view one element
# off a 16-byte base ("simt"), N not a multiple of the backward's band of
# rows, and an fp32 bias beside x of each dtype.
GELU_CASES = [
    ("mlp_path", 2048, 3072, {}),
    ("few_rows_n8", 8, 3072, {}),
    ("ragged_1000x17", 1000, 17, {}),
    ("d1600_f6400", 512, 6400, {}),
    ("b_g_zeros", 300, 96, dict(zeros=True)),
    ("x_offset_1", 1000, 3072, dict(offset=1)),
    ("n2047_band_tail", 2047, 3072, {}),
    ("fp32_bias", 2048, 3072, dict(b_dtype=torch.float32)),
]
GELU_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
GELU_COPIES = 6  # input sets timed in turn at the path's shape: 151 MB of x, b and g, 3x the L2
# matmul_bias, as a share of the plain version's largest |y|: fp32 1e-5 (the
# same fp32 sum in another order); bf16 1e-2 (both round that sum to bf16, so
# a rounding flip moves one element by a bf16 ulp, 2**-8 of its size); fp16
# 1e-3 (the same with an fp16 ulp, at most 2**-10 of an element's size: one
# flip passes, an operand rounded to bf16 on the way, ~2**-9 of each product,
# does not).
# bias_gelu's y and dx, per element against the plain version's |value|, in
# x's dtype: fp32 1e-5 + 1e-5 |y| (tanhf against torch's tanh, an ulp or two),
# bf16 1e-5 + 2**-7 |y| (one rounding to bf16 flipped), fp16 1e-5 + 2**-10 |y|
# (one rounding to fp16 flipped). db: gelu_db_tol.
MB_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
GELU_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2**-7), torch.float16: (1e-5, 2**-10)}  # (abs, rel)


def mb_inputs(N, D, F, dtype, gen, kw):
    """(x [N, D], w [F, D], b [F] or None) of a MB_CASES case on ``gen``'s
    device, in ``dtype``."""
    x = torch.randn(N, D, generator=gen, device=gen.device).to(dtype)
    w = (0.05 * torch.randn(F, D, generator=gen, device=gen.device)).to(dtype)
    b = None
    if kw.get("bias", True):
        b = torch.randn(F, generator=gen, device=gen.device).to(dtype)
        if kw.get("zeros"):
            b[::3] = 0
    return x, w, b


def gelu_inputs(N, F, dtype, gen, kw):
    """(x [N, F], b [F], g [N, F]) of a GELU_CASES case on ``gen``'s device,
    in ``dtype`` (b in ``kw["b_dtype"]`` if given; x a contiguous view
    ``kw["offset"]`` elements into its storage if given)."""
    off = kw.get("offset", 0)
    x = (2.0 * torch.randn(N * F + off, generator=gen, device=gen.device)).to(dtype)[off:].view(N, F)
    b = torch.randn(F, generator=gen, device=gen.device).to(kw.get("b_dtype", dtype))
    g = torch.randn(N, F, generator=gen, device=gen.device).to(dtype)
    if kw.get("zeros"):
        b[::3] = 0
        g[:, ::4] = 0
    return x, b, g


def mb_compare(x, w, b):
    """matmul_bias against its plain version: (max abs error, ok, detail).
    The route the wrapper took (which counter moved) must be ``_route``'s."""
    from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb

    want = mb._route(x.dtype, x.shape[1], x.data_ptr(), w.data_ptr())
    before = (mb.matmul_bias_fwd.launches, mb.matmul_bias_fwd.simt_launches)
    y = mb.matmul_bias_fwd(x, w, b)
    torch.cuda.synchronize()
    taken = _route_taken(mb.matmul_bias_fwd, before)
    ref = mb.reference_matmul_bias(x, w, b)
    err = float((y.float() - ref.float()).abs().max())
    scale = max(float(ref.float().abs().max()), 1e-6)
    ok = taken == want and y.dtype == x.dtype and bool(torch.isfinite(y).all()) and err <= MB_TOL[x.dtype] * scale
    return err, ok, (f"route {taken:5s} (_route: {want}) max|dy| {err:.2e} of max|y| {scale:.2e} "
                     f"(tol {MB_TOL[x.dtype]:.0e} of it)")


def gelu_db_tol(dpre, db_ref):
    """Per-column bound on |db - db_ref| for db summed from the same fp32
    dpre [..., F] in another order: each fp32 sum of N terms lies within
    (N - 1) 2**-24 sum|dpre| of the exact one whatever its order, so two orders
    within 2 N 2**-24 sum|dpre|; each then rounds once to db's dtype, which
    may flip one ulp of it (GELU_TOL's terms; none for fp32). The kernel's
    dpre equals the plain version's element for element (the same fp32
    operations in the same order), so only the order differs."""
    d = dpre.reshape(-1, dpre.shape[-1]).float()
    tol = 2 * d.shape[0] * 2**-24 * d.abs().sum(0)
    if db_ref.dtype != torch.float32:
        atol, rtol = GELU_TOL[db_ref.dtype]
        tol = tol + atol + rtol * db_ref.float().abs()
    return tol


def gelu_compare(x, b, g):
    """The two bias_gelu wrappers against their plain versions on one input:
    {kernel name: (max abs error, ok, detail)}. y and dx within GELU_TOL of
    x's dtype, db within gelu_db_tol; each wrapper must take ``_route``'s
    route and give equal bits on a repeat."""
    from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg

    F = x.shape[-1]
    out = {}
    for name, fn, args, route in (
        ("bias_gelu_fwd", bg.bias_gelu_fwd, (x, b), bg._route(x.dtype, F, x.data_ptr())),
        ("bias_gelu_bwd", bg.bias_gelu_bwd, (x, b, g), bg._route(x.dtype, F, x.data_ptr(), g.data_ptr())),
    ):
        before = (fn.launches, fn.simt_launches)
        got = fn(*args)
        torch.cuda.synchronize()
        taken = _route_taken(fn, before, "vec")
        again = fn(*args)
        torch.cuda.synchronize()
        if name == "bias_gelu_fwd":
            got, again = (got,), (again,)
            want = (bg.reference_bias_gelu(x, b),)
            tols = (GELU_TOL[x.dtype],)
        else:
            want = bg.reference_bias_gelu_grads(x, b, g)
            tols = (GELU_TOL[x.dtype], None)
        equal = all(torch.equal(a, c) for a, c in zip(got, again))
        ok, errs, parts = taken == route and equal, [], []
        for label, a, w, tol in zip(("y",) if len(got) == 1 else ("dx", "db"), got, want, tols):
            d = (a.float() - w.float()).abs()
            bound = (gelu_db_tol(bg.reference_bias_gelu_bwd(x, b, g), w) if tol is None
                     else tol[0] + tol[1] * w.float().abs())
            ok = ok and a.dtype == w.dtype and a.shape == w.shape and bool(torch.isfinite(a).all()) and bool(
                (d <= bound).all())
            errs.append(float(d.max()))
            share = float((d / bound.clamp_min(torch.finfo(torch.float32).tiny)).max())
            parts.append(f"max|d{label}| {float(d.max()):.2e} (worst share of tol {share:.2f})")
        out[name] = (max(errs), ok, f"route {taken:4s} (_route: {route}) " + ", ".join(parts)
                     + f", repeat {'bit-equal' if equal else 'DIFFERS'}")
    return out


def _phase_b_new(failures):
    """matmul_bias and the bias_gelu kernels against their plain versions
    over MB_CASES (fp32, bf16, fp16) and GELU_CASES (GELU_DTYPES). Returns the
    errors at the smp.nn path's shapes in bf16."""
    counters = {**_new_counters(), **_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    path_err = {}
    for name, N, D, F, kw in MB_CASES:
        for dtype in MB_TOL:
            tag = str(dtype).removeprefix("torch.")
            err, ok, detail = mb_compare(*mb_inputs(N, D, F, dtype, gen, kw))
            log(f"[B] matmul_bias     {name:20s} N={N} D={D} F={F} {tag:9s} {detail} {'ok' if ok else 'FAIL'}")
            if name == "qkv_path" and dtype == torch.bfloat16:
                path_err["matmul_bias"] = err
            if not ok:
                failures.append(f"matmul_bias/{name}/{tag}")
    for name, N, F, kw in GELU_CASES:
        for dtype in GELU_DTYPES:
            tag = str(dtype).removeprefix("torch.")
            for kname, (err, ok, detail) in gelu_compare(*gelu_inputs(N, F, dtype, gen, kw)).items():
                log(f"[B] {kname:15s} {name:20s} N={N} F={F} {tag:9s} {detail} {'ok' if ok else 'FAIL'}")
                if name == "mlp_path" and dtype == torch.bfloat16:
                    path_err[kname] = err
                if not ok:
                    failures.append(f"{kname}/{name}/{tag}")
    for k, fn in counters.items():
        fn.launches = saved[k]  # comparison launches do not count
    return path_err


# (name, N, D, F, kwargs) of the matmul_fp8 kernels: the fused QKV of the
# smp.nn path under fp8 (activation-like operands cast with a delayed scale,
# and every e4m3 code but NaN: magnitudes up to 448, subnormals, zeros), few
# rows, ragged N, D and F (D not a multiple of 16: the CUDA-core route's byte
# loads), GPT-2 1.5B's width, rows of zeros, and ragged N and F on the
# tensor-core route (a partial last tile both ways; a partial last row tile
# at the path's F, every code).
FP8_CASES = [
    ("qkv_path", 2048, 768, 2304, {}),
    ("qkv_path_all_codes", 2048, 768, 2304, dict(values="codes")),
    ("few_rows_n8", 8, 768, 2304, {}),
    ("ragged_1000x33x17", 1000, 33, 17, dict(values="codes")),
    ("d1600_f4800", 512, 1600, 4800, {}),
    ("zero_rows", 300, 64, 96, dict(values="codes", zeros=True)),
    ("ragged_1000x768x2300", 1000, 768, 2300, {}),
    ("n2047_all_codes", 2047, 768, 2304, dict(values="codes")),
]
E4M3_NAN_CODES = (0x7F, 0xFF)


def fp8_inputs(N, D, F, gen, kw):
    """(x8 [N, D], w8 [F, D]) float8_e4m3fn of a FP8_CASES case on
    ``gen``'s device: activation-like N(0, 3) and weight-like N(0, 0.02)
    values divided by amax / 448 (a delayed scale at its running max) and
    cast, or with ``values="codes"`` every non-NaN e4m3 code drawn uniformly;
    ``zeros`` zeroes every third row of x8 and of w8."""
    if kw.get("values") == "codes":
        u = torch.randint(0, 256, (N + F, D), generator=gen, device=gen.device, dtype=torch.uint8)
        for code in E4M3_NAN_CODES:
            u[u == code] = 0
        f8 = u.view(torch.float8_e4m3fn)
        x8, w8 = f8[:N].contiguous(), f8[N:].contiguous()
    else:
        x = 3.0 * torch.randn(N, D, generator=gen, device=gen.device)
        w = 0.02 * torch.randn(F, D, generator=gen, device=gen.device)
        x8 = (x / (x.abs().max() / 448.0)).clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
        w8 = (w / (w.abs().max() / 448.0)).clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    if kw.get("zeros"):
        x8.view(torch.uint8)[::3] = 0
        w8.view(torch.uint8)[::3] = 0
    return x8, w8


def fp8_bound(x8, w8, y):
    """``y`` against the plain version of ``x8 @ w8^T``: (max abs error,
    within the bound, largest share of an element's bound). Each product of
    two e4m3 values is exact in fp32, so only the order of the fp32 sums
    differs; any order of a sum of D terms is within D * 2**-24 times the sum
    of their magnitudes of the exact sum, so each element is held to 2 D
    2**-24 (|x8| @ |w8|^T) of its own."""
    from smdistributed_modelparallel_tpu_torch.ops.matmul_fp8 import reference_matmul_fp8

    ref = reference_matmul_fp8(x8, w8)
    absdot = x8.float().abs().double() @ w8.float().abs().double().t()
    tol = 2 * x8.shape[1] * 2.0**-24 * absdot
    d = (y.double() - ref.double()).abs()
    ok = y.dtype == torch.float32 and bool(torch.isfinite(y).all()) and bool((d <= tol).all())
    return float(d.max()), ok, float((d / tol.clamp_min(1e-300)).max())


def fp8_compare(x8, w8):
    """matmul_fp8 against its plain version (``fp8_bound``): (max abs error,
    ok, detail). The route the wrapper took must be ``_route``'s."""
    from smdistributed_modelparallel_tpu_torch.ops import matmul_fp8 as mf

    want = mf._route(x8.shape[1], x8.data_ptr(), w8.data_ptr())
    before = (mf.matmul_fp8.launches, mf.matmul_fp8.simt_launches)
    y = mf.matmul_fp8(x8, w8)
    torch.cuda.synchronize()
    taken = _route_taken(mf.matmul_fp8, before)
    err, ok, share = fp8_bound(x8, w8, y)
    return err, ok and taken == want, (f"route {taken:5s} (_route: {want}) max|dy| {err:.2e}, at most {share:.3f} "
                                       f"of its element's bound")


def _phase_b_fp8(failures):
    """matmul_fp8 against its plain version over FP8_CASES. Returns the error
    at the smp.nn path's shape."""
    from smdistributed_modelparallel_tpu_torch.ops import matmul_fp8 as mf

    counter = _fp8_counters()["matmul_fp8"]
    saved = (counter.launches, counter.simt_launches)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    path_err = None
    for name, N, D, F, kw in FP8_CASES:
        x8, w8 = fp8_inputs(N, D, F, gen, kw)
        err, ok, detail = fp8_compare(x8, w8)
        log(f"[B] matmul_fp8      {name:20s} N={N} D={D} F={F} e4m3fn    {detail} {'ok' if ok else 'FAIL'}")
        if name == "qkv_path":
            path_err = err
        if not ok:
            failures.append(f"matmul_fp8/{name}")
    counter.launches, counter.simt_launches = saved  # comparison launches do not count
    return path_err


# ----------------------------------------------------------------------
# Ids mode: kernels 1-3 over one (q block, kv block) pair of a cp ring step
# ----------------------------------------------------------------------


def zig_ids(dev, Tl, n, device="cuda"):
    """Global row ids of rank ``dev``'s zigzag block (half-chunks dev and
    2n-1-dev of Tl / 2 rows each)."""
    half = Tl // 2
    ar = torch.arange(half, device=device)
    return torch.cat([dev * half + ar, (2 * n - 1 - dev) * half + ar])


# (name, B, Tl, H, hd, n ranks, q's rank, kv's rank, kwargs). The first six
# are phase R's ring pairs at its shape (B 2, Tl 2048 of T 4096, 12 heads,
# hd 64): each rank's diagonal and off-diagonal step, key padding, and
# dropout with the global stride and a head remap; then n = 4, non-causal,
# hd 128 and 256, and a ragged contiguous (non-zigzag) block.
IDS_CASES = [
    ("r0_diag", 2, 2048, 12, 64, 2, 0, 0, {}),
    ("r0_off", 2, 2048, 12, 64, 2, 0, 1, {}),
    ("r1_diag", 2, 2048, 12, 64, 2, 1, 1, {}),
    ("r1_off", 2, 2048, 12, 64, 2, 1, 0, {}),
    ("r0_diag_kpad", 2, 2048, 12, 64, 2, 0, 0, dict(kpad=True)),
    ("r1_off_dropout_head_remap", 2, 2048, 12, 64, 2, 1, 0,
     dict(dropout_rate=0.1, seed=20261017, counter_len=4096, head0=6, head_total=24)),
    ("n4_r1_src2", 1, 256, 4, 64, 4, 1, 2, {}),
    ("noncausal_hd128", 2, 384, 4, 128, 2, 1, 0, dict(causal=False)),
    ("hd256", 1, 256, 2, 256, 2, 0, 0, {}),
    ("ragged_tl200_contiguous", 1, 200, 3, 64, 2, 1, 0, dict(contiguous=True)),
]
IDS_PATH_CASES = ("r0_diag", "r0_off", "r1_diag", "r1_off", "r0_diag_kpad", "r1_off_dropout_head_remap")
# Also in fp16 (TOL, BWD_TOL): a diagonal pair, key padding, dropout and a
# ragged contiguous block.
IDS_FP16_CASES = ("r0_diag", "r0_diag_kpad", "r1_off_dropout_head_remap", "ragged_tl200_contiguous")


def ids_inputs(B, Tl, H, hd, n, me, src, dtype, gen, kw):
    """(q, k, v, dO, kpad, q_ids, kv_ids, kernel kwargs) of one ring pair."""
    kw = dict(kw, scale=1.0 / math.sqrt(hd))
    kw.setdefault("causal", True)
    q, k, v, do = (torch.randn(B, Tl, H, hd, generator=gen, device="cuda").to(dtype) for _ in range(4))
    if kw.pop("contiguous", False):
        qi = me * Tl + torch.arange(Tl, device="cuda")
        ki = src * Tl + torch.arange(Tl, device="cuda")
    else:
        qi, ki = zig_ids(me, Tl, n), zig_ids(src, Tl, n)
    kpad = None
    if kw.pop("kpad", False):
        kpad = torch.zeros(B, Tl, device="cuda")
        kpad[0, 1024:1200] = -1e30  # rows whose kept keys are all padded
        kpad[1, ::7] = -1e30
    return q, k, v, do, kpad, qi, ki, kw


def ids_compare(q, k, v, do, kpad, qi, ki, kw):
    """Each ids-mode kernel against its plain version on one pair (the
    forward by fwd_check, the backward by bwd_check: routes, the CUDA-core
    route and a repeat launch); the backward fed the plain forward's o (as
    the global output) and lse. Returns ({kernel: error}, ok, detail)."""
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_bwd_dkv_ids,
        flash_bwd_dkv_ids_reference,
        flash_bwd_dq_ids,
        flash_bwd_dq_ids_reference,
        flash_fwd_with_ids,
        flash_fwd_with_ids_reference,
    )

    dtype = q.dtype
    o_ref, lse_ref = flash_fwd_with_ids_reference(q, k, v, kpad, qi, ki, **kw)  # o in fp32, as the ring merges it
    err_o, ok_fwd, detail_fwd = fwd_check(lambda: flash_fwd_with_ids(q, k, v, kpad, qi, ki, **kw), (o_ref, lse_ref),
                                          flash_fwd_with_ids, flash_route(dtype, q.shape[-1]), dtype, TOL[dtype],
                                          float(v.float().abs().max()), kw.get("dropout_rate", 0.0))
    o_in = o_ref.to(dtype)
    delta = attention_delta(o_in, do)
    args = (q, k, v, do, lse_ref, delta, kpad, qi, ki)
    want = (flash_bwd_dq_ids_reference(*args, **kw),) + flash_bwd_dkv_ids_reference(*args, **kw)
    outs = []

    def run():
        outs[:] = (flash_bwd_dq_ids(*args, **kw),) + flash_bwd_dkv_ids(*args, **kw)
        return tuple(outs)

    errs, ok_bwd, detail_bwd = bwd_check(run, want, (flash_bwd_dq_ids, flash_bwd_dkv_ids), flash_route(dtype, q.shape[-1]),
                                         BWD_TOL[dtype], per_output=True)
    ok = ok_fwd and ok_bwd and all(x.dtype == torch.float32 and bool(torch.isfinite(x).all()) for x in outs)
    detail = f"o, lse: {detail_fwd}; dq, dk, dv: {detail_bwd}"
    return {"flash_fwd_ids": err_o, **errs}, ok, detail


def _ids_counters():
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_ids,
        flash_bwd_dq_ids,
        flash_fwd_with_ids,
    )

    return {"flash_fwd_ids": flash_fwd_with_ids, "flash_bwd_dq_ids": flash_bwd_dq_ids,
            "flash_bwd_dkv_ids": flash_bwd_dkv_ids}


def _phase_b_ids(failures):
    """The ids-mode kernels against their plain versions over IDS_CASES:
    phase R's pairs in bf16, the others in fp32 and bf16, IDS_FP16_CASES
    also in fp16. Returns the largest error over phase R's four plain ring
    pairs (bf16)."""
    counters = {**_ids_counters(), **_flash_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    path_err = {k: 0.0 for k in _ids_counters()}
    for name, B, Tl, H, hd, n, me, src, kw in IDS_CASES:
        dtypes = [torch.bfloat16] if name in IDS_PATH_CASES else [torch.float32, torch.bfloat16]
        if name in IDS_FP16_CASES:
            dtypes.append(torch.float16)
        for dtype in dtypes:
            tag = str(dtype).removeprefix("torch.")
            errs, ok, detail = ids_compare(*ids_inputs(B, Tl, H, hd, n, me, src, dtype, gen, kw))
            log(f"[B] flash ids {name:26s} B={B} Tl={Tl} H={H} hd={hd} {tag:9s} {detail} {'ok' if ok else 'FAIL'}")
            if name in IDS_PATH_CASES[:4]:
                path_err = {k: max(path_err[k], errs[k]) for k in path_err}
            if not ok:
                failures.append(f"flash_ids/{name}/{tag}")
    for k, fn in counters.items():
        fn.launches = saved[k]  # comparison launches do not count
    return path_err


def _kept_pairs(qi, ki):
    """(row, col) pairs a causal ids-mode call keeps: the operations it
    needs (the bound counts what these inputs need)."""
    return int((ki[None, :] <= qi[:, None]).sum())


def _phase_c_ids():
    """The ids-mode kernels at phase R's shape (B 2, Tl 2048, H 12, hd 64,
    bf16), each the mean of rank 0's two ring steps (the diagonal and the
    off-diagonal pair): kernel, plain version and the one library call that
    computes the same function, SDPA with the boolean mask built from the
    ids; the bound from the kept pairs' products and the bytes each input
    and output moves once. All by CUDA-graph replay: the forward
    and the backward on their route (flash_times) and forced onto
    the CUDA cores, against SDPA's forward and backward (dq, dk and dv
    together, timed once per ring step)."""
    import torch.nn.functional as F

    from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_bwd_dkv_ids,
        flash_bwd_dkv_ids_reference,
        flash_bwd_dq_ids,
        flash_bwd_dq_ids_reference,
        flash_fwd_with_ids,
        flash_fwd_with_ids_reference,
    )

    counters = {**_ids_counters(), **_flash_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, Tl, H, hd, n = 2, CP_T // CP_N, 12, 64, CP_N
    dtype, esz = torch.bfloat16, 2
    acc = {k: dict(ms=0.0, simt_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0) for k in _ids_counters()}
    bound_by, route = {}, None
    for src in range(n):
        q, k, v, do, kpad, qi, ki, kw = ids_inputs(B, Tl, H, hd, n, 0, src, dtype, gen, {})
        o, lse = flash_fwd_with_ids_reference(q, k, v, kpad, qi, ki, **kw)
        o_in = o.to(dtype)
        delta = attention_delta(o_in, do)
        args = (q, k, v, do, lse, delta, None, qi, ki)
        mask = ki[None, :] <= qi[:, None]
        route = fa._route(q, k, v, do)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fwd = dict(flash_times(flash_fwd_with_ids, flash_fwd_with_ids_reference, (q, k, v, None, qi, ki), kw),
                   library_ms=cuda_graph_time_ms(
                       lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=kw["scale"])))
        lib_bwd_ms = sdpa_bwd_ms(q, k, v, do, attn_mask=mask, scale=kw["scale"])
        pairs = _kept_pairs(qi, ki)
        product = 2 * B * H * pairs * hd  # one [kept pairs x hd] product
        in_bytes = 4 * B * Tl * H * hd * esz + 2 * Tl * 4  # q, k, v, (dO) and the ids
        rows = (
            ("flash_fwd_ids", fwd, 2 * product,
             3 * B * Tl * H * hd * esz + 2 * Tl * 4 + B * Tl * H * hd * 4 + B * H * Tl * 4),
            ("flash_bwd_dq_ids", dict(flash_times(flash_bwd_dq_ids, flash_bwd_dq_ids_reference, args, kw),
                                      library_ms=lib_bwd_ms),
             3 * product, in_bytes + 2 * B * H * Tl * 4 + B * Tl * H * hd * 4),
            ("flash_bwd_dkv_ids", dict(flash_times(flash_bwd_dkv_ids, flash_bwd_dkv_ids_reference, args, kw),
                                       library_ms=lib_bwd_ms),
             4 * product, in_bytes + 2 * B * H * Tl * 4 + 2 * B * Tl * H * hd * 4),
        )
        for name, t, flops, nbytes in rows:
            bound_ms, bound_by[name] = _bound(nbytes, flops, dtype)
            t = dict(t, bound_ms=bound_ms)
            how = (f"CUDA-graph replay: the wrapper ({route}); CUDA-core kernel {t['simt_ms']:.4f} ms "
                   f"({flops / t['simt_ms'] / 1e9:.2f} TFLOP/s)")
            log(f"[C] {name} ring step {src} of rank 0 (B={B} Tl={Tl} H={H} hd={hd} bf16, {pairs} kept pairs of "
                f"{Tl * Tl}; {how}): kernel {t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.2f} TFLOP/s), plain "
                f"{t['plain_ms']:.4f} ms, library (SDPA with the ids mask{'' if name == 'flash_fwd_ids' else ', its backward'}) "
                f"{t['library_ms']:.4f} ms; bound {bound_ms:.4f} ms by {bound_by[name]} ({nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.3f} GFLOP)")
            for key in acc[name]:
                acc[name][key] += t[key] / n
        log(f"[C] ring step {src} of rank 0: dq + dk/dv {rows[1][1]['ms'] + rows[2][1]['ms']:.4f} ms against SDPA's "
            f"backward with the ids mask {lib_bwd_ms:.4f} ms")
    for key, fn in counters.items():
        fn.launches = saved[key]  # timing launches do not count
    return {name: dict(acc[name], bound_by=bound_by[name], path_route=route) for name in acc}


# ----------------------------------------------------------------------
# Phase R: context-parallel training, two ranks on one card
# ----------------------------------------------------------------------

CP_B, CP_T, CP_N, CP_MB, CP_STEPS = 2, 4096, 2, 1, 3
CP_LOSS_TOL = 1e-2


def _cp_model_and_batch(device):
    """GPT-2 124M at 4096 positions with random weights from SEED, and the
    batch: ids and targets shifted by one (-100 last)."""
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_

    g = torch.Generator(device=device).manual_seed(SEED)
    module = init_gpt2_weights_(gpt2_124m(max_len=CP_T, device=device), g)
    ids = torch.randint(0, module.vocab_size, (CP_B, CP_T), generator=g, device=device)
    tgt = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)], dim=1)
    return module, ids, tgt


def _cp_train(cfg, device, steps):
    """``steps`` AdamW steps of the masked-mean loss through the public
    entry points: (losses, ms per step, launches by kernel)."""
    import smdistributed_modelparallel_tpu_torch as smp

    from smdistributed_modelparallel_tpu_torch.backend.state import state

    smp.init({"microbatches": CP_MB, "bf16": True, **cfg}, device=device)
    group = state.group("cp")
    module, ids, tgt = _cp_model_and_batch(state.device)
    model = smp.DistributedModel(module)
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids_, tgt_):
        count = (tgt_ != -100).sum()
        loss = model(ids_, targets=tgt_).sum() / count
        model.backward(loss, num_tokens=count)
        return loss

    counters = {**_flash_counters(), **_ids_counters(), **_flash_simt_counters()}
    for fn in counters.values():
        fn.launches = 0
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(model, ids, tgt).reduce_mean()))
        optimizer.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    smp.reset()
    return losses, ms, launches, group.transport if group is not None else None


def _free_port():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _rank_main(rank, world, port, fn, args, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.set_num_threads(1)
        queue.put((rank, fn(rank, world, *args), None))
    except BaseException:  # reported to the parent, which raises; the rank exits non-zero
        import traceback

        queue.put((rank, None, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world, fn, *args, timeout=600):
    """Run ``fn(rank, world, *args)`` in ``world`` processes started with
    the spawn method (a forked child must not inherit a CUDA context), each
    holding the launcher variables of one torch.distributed world
    (``LOCAL_RANK`` = rank); return the results by rank. Raises if a rank
    raised, died or did not exit."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, fn, args, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, res, err = queue.get(timeout=timeout)
            results[rank] = res
            if err:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                errors.append(f"rank process {p.pid} did not exit")
            elif p.exitcode != 0:
                errors.append(f"rank process {p.pid} exited with {p.exitcode}")
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]


def _cp_rank(rank, world, device):
    """One cp rank on ``device`` (cuda:0 named explicitly for ranks that
    share the card, since LOCAL_RANK 1 names no card there; None for
    cuda:LOCAL_RANK): the ring run, then one Ulysses step, then the
    breakdown."""
    out = {impl: _cp_train({"context_parallel_degree": world, "ddp": True, "context_parallel_impl": impl},
                           device, steps)
           for impl, steps in (("ring", CP_STEPS), ("ulysses", 1))}
    out["breakdown"] = _cp_breakdown(world, device)
    return out


def _cp_breakdown(world, device):
    """This rank's wall ms, at phase R's shapes, of one layer's ring
    attention (forward and backward, exchanges included) and of the step's
    gradient all-reduce (GPT-2 124M at 4096 positions, fp32)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m
    from smdistributed_modelparallel_tpu_torch.ops.context_parallel import cp_attention

    smp.init({"context_parallel_degree": world, "ddp": True}, device=device)
    gen = torch.Generator(device=state.device).manual_seed(SEED + state.rank)
    q, k, v, do = (torch.randn(CP_B, CP_T // world, 12, 64, generator=gen, device=state.device).to(torch.bfloat16)
                   for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    n_params = sum(p.numel() for p in gpt2_124m(max_len=CP_T, device="meta").parameters())
    grads = torch.zeros(n_params, device=state.device)

    def wall_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    def layer():
        o = cp_attention(q, k, v, scale=0.125, causal=True)
        torch.autograd.grad(o, (q, k, v), do)

    out = dict(ring_layer_ms=wall_ms(layer, 3), all_reduce_ms=wall_ms(lambda: state.group("cp").all_reduce(grads), 2),
               n_params=n_params)
    smp.reset()
    return out


def phase_r(device="cuda:0"):
    """Context-parallel training: two spawned cp ranks on ``device`` (one
    card, gloo with host copies between them), or with ``device=None`` on
    cuda:0 and cuda:1 (NCCL; phase N, on a machine with two cards), train
    GPT-2 124M at 4096 tokens (B 2, Tl 2048 a rank) for CP_STEPS AdamW steps
    on the ring, then one step under Ulysses; this process runs the same
    weights and batch at cp = 1. The losses must agree within CP_LOSS_TOL
    and each rank must launch each ids-mode kernel 12 layers x 2 ring steps
    x microbatches a step."""
    if device is None and torch.cuda.device_count() < CP_N:
        raise RuntimeError(f"cp ranks on separate cards need {CP_N} cards, found {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    results = run_ranks(CP_N, _cp_rank, device)
    ranks_s = time.perf_counter() - t0
    base_losses, base_ms, base_launches, _ = _cp_train({}, "cuda", CP_STEPS)

    n_layers = 12
    per_step = n_layers * CP_N * CP_MB
    launches = dict(base_launches)
    for rank in range(CP_N):
        for impl in ("ring", "ulysses"):
            for k, n in results[rank][impl][2].items():
                launches[k] += n
    transport = results[0]["ring"][3]
    where = f"{CP_N} ranks on {device}" if device else f"ranks on cuda:0-{CP_N - 1}"
    log(f"[R] GPT-2 124M bf16, B={CP_B} x T={CP_T} ({CP_T // CP_N} tokens a rank), {CP_MB} microbatch, AdamW; "
        f"{where}, transport {transport}{' (host copies of CUDA tensors)' if transport == 'gloo' else ''}; "
        f"ranks took {ranks_s:.1f} s with start-up")
    worst = 0.0
    for rank in range(CP_N):
        losses, ms, counts, _ = results[rank]["ring"]
        gap = max(abs(a - b) for a, b in zip(losses, base_losses))
        worst = max(worst, gap)
        log(f"[R] rank {rank} ring: losses {losses}, cp = 1 {base_losses}, largest difference {gap:.3e} "
            f"(limit {CP_LOSS_TOL:.0e}); ms/step {[round(x, 2) for x in ms]}; launches {counts}")
        for k in _ids_counters():
            if counts[k] != per_step * CP_STEPS:
                raise RuntimeError(f"rank {rank}: {k} launched {counts[k]} times in {CP_STEPS} steps, "
                                   f"expected {per_step * CP_STEPS}")
        u_losses, u_ms, u_counts, _ = results[rank]["ulysses"]
        u_gap = abs(u_losses[0] - base_losses[0])
        worst = max(worst, u_gap)
        log(f"[R] rank {rank} ulysses: step-1 loss {u_losses[0]}, cp = 1 {base_losses[0]}, difference "
            f"{u_gap:.3e}; {u_ms[0]:.2f} ms; launches {u_counts}")
        if u_counts["flash_fwd"] != n_layers * CP_MB or u_counts["flash_fwd_ids"] != 0:
            raise RuntimeError(f"rank {rank}: Ulysses launches {u_counts}")
        _check_route(f"rank {rank} ring", counts)
        _check_route(f"rank {rank} ulysses", u_counts)
    for rank in range(CP_N):
        bd = results[rank]["breakdown"]
        log(f"[R] rank {rank} breakdown: one layer's ring attention, forward and backward with its exchanges, "
            f"{bd['ring_layer_ms']:.2f} ms ({n_layers} layers: {n_layers * bd['ring_layer_ms']:.1f} ms a step); "
            f"the gradient all-reduce ({bd['n_params']} fp32) {bd['all_reduce_ms']:.2f} ms")
    cp_ms = sum(results[0]["ring"][1][1:]) / (CP_STEPS - 1)
    one_ms = sum(base_ms[1:]) / (CP_STEPS - 1)
    log(f"[R] ms/step (mean of steps 2-{CP_STEPS}): cp = 2 {cp_ms:.2f}, cp = 1 {one_ms:.2f}; "
        f"cp = 1 launches {base_launches}")
    _check_route("cp = 1", base_launches)
    if worst > CP_LOSS_TOL or not all(math.isfinite(x) for x in base_losses):
        raise RuntimeError(f"cp = 2 losses differ from cp = 1 by {worst:.3e} (limit {CP_LOSS_TOL})")
    return launches, dict(cp_ms=cp_ms, one_ms=one_ms, gap=worst, transport=transport)


def _bound(nbytes, flops, dtype):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _causal_pairs(T, S):
    return sum(min(S, r + (S - T) + 1) for r in range(T))  # kept (row, col) pairs


def phase_c():
    """Kernel, plain and library times at the main paths' shapes: the
    forward at the serving prefill's (B=4, T=512; the kernels line) and the
    training microbatch's (B=2, T=1024), the backward at the training
    microbatch's."""
    import torch.nn.functional as F

    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention,
        flash_attention_reference,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
    )

    from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa

    counters = {**_flash_route_counters(), **_flash_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtype = torch.bfloat16
    esz = torch.finfo(dtype).bits // 8
    out = {}

    # The forward by CUDA-graph replay in one call: the wrapper on its route
    # and forced onto the CUDA-core route, the plain version and SDPA's
    # forward, at the prefill's shape and at the training microbatch's.
    for label, B, T in (("prefill", 4, 512), ("training microbatch", 2, 1024)):
        S, H, hd = T, 12, 64
        q, k, v = _inputs(B, T, S, H, hd, dtype, gen)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t = dict(flash_times(flash_attention, flash_attention_reference, (q, k, v), {}),
                 library_ms=cuda_graph_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)))
        nbytes = 2 * B * T * H * hd * esz + 2 * B * S * H * hd * esz + B * H * T * 4  # q, o, k, v, lse
        flops = 4 * B * H * _causal_pairs(T, S) * hd  # two products of 2 flops per (pair, d)
        bound_ms, bound_by = _bound(nbytes, flops, dtype)
        route = fa._route(q, k, v)
        log(f"[C] flash_fwd {label} B={B} T=S={T} H={H} hd={hd} bf16 causal, device times by CUDA-graph replay: "
            f"the wrapper ({route}) {t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.2f} TFLOP/s), CUDA-core kernel "
            f"{t['simt_ms']:.4f} ms ({flops / t['simt_ms'] / 1e9:.2f} TFLOP/s), plain {t['plain_ms']:.4f} ms, SDPA "
            f"{t['library_ms']:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
        if label == "prefill":  # the kernels line's shape
            out["flash_fwd"] = dict(t, bound_ms=bound_ms, bound_by=bound_by, path_route=route)
        else:
            out["flash_fwd"].update({"train_" + key: val for key, val in dict(t, bound_ms=bound_ms).items()})

    B, T, S, H, hd = 2, 1024, 1024, 12, 64
    q, k, v = _inputs(B, T, S, H, hd, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o, lse = flash_attention_reference(q, k, v)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta)
    # The backward by CUDA-graph replay in one call: each wrapper on its route
    # and forced onto the CUDA-core route, the plain versions, and one library
    # call computing dq, dk and dv together, the yardstick of both kernels
    # (compare it with their sum).
    route = fa._route(q, k, v, do)
    sdpa_ms = sdpa_bwd_ms(q, k, v, do, is_causal=True)
    delta_ms = cuda_graph_time_ms(lambda: attention_delta(o, do))
    product = 2 * B * H * _causal_pairs(T, S) * hd  # one [pairs x hd] product
    in_bytes = (2 * B * T + 2 * B * S) * H * hd * esz + 2 * B * H * T * 4  # q, do, k, v, lse, delta
    for name, kernel, plain, n_products, out_bytes in (
        ("flash_bwd_dq", flash_bwd_dq, flash_bwd_dq_reference, 3, B * T * H * hd * esz),      # s, dp, dq
        ("flash_bwd_dkv", flash_bwd_dkv, flash_bwd_dkv_reference, 4, 2 * B * S * H * hd * esz),  # s, dp, dv, dk
    ):
        t = flash_times(kernel, plain, args, {})
        bound_ms, bound_by = _bound(in_bytes + out_bytes, n_products * product, dtype)
        out[name] = dict(t, bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_ms, path_route=route)
        log(f"[C] {name} B={B} T=S={T} H={H} hd={hd} bf16 causal, device times by CUDA-graph replay: the wrapper "
            f"({route}) {t['ms']:.4f} ms ({n_products * product / t['ms'] / 1e9:.2f} TFLOP/s), CUDA-core kernel "
            f"{t['simt_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA backward (dq, dk, dv) {sdpa_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({(in_bytes + out_bytes) / 1e6:.2f} MB, "
            f"{n_products * product / 1e9:.3f} GFLOP)")
    pair_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    log(f"[C] backward per layer and microbatch: delta {delta_ms:.4f} ms + dq + dk/dv {pair_ms:.4f} ms "
        f"({out['flash_bwd_dq']['simt_ms'] + out['flash_bwd_dkv']['simt_ms']:.4f} ms on CUDA cores) against SDPA "
        f"backward {sdpa_ms:.4f} ms")
    for key, fn in counters.items():
        fn.launches = saved[key]  # timing launches do not count
    out.update(_phase_c_ce())
    out.update(_phase_c_new())
    out.update(_phase_c_fp8())
    out.update(_phase_c_ids())
    return out


def _phase_c_fp8():
    """matmul_fp8 at the smp.nn path's fused QKV under fp8 (N 2048, D 768, F
    2304), all by CUDA-graph replay (``cuda_graph_time_ms``) in one call: the
    wrapper as the path calls it, its tensor-core kernel's bare launch, the
    CUDA-core kernel, the plain version and one library call computing the
    same function, ``torch._scaled_mm`` with unit scales and an fp32 output,
    which the port never calls; the wrapper's eager time beside them (CUDA
    events, host launch cost included); the bound from the bytes of x8, w8
    and the fp32 y and the operations at the fp8 peak."""
    from smdistributed_modelparallel_tpu_torch.ops import matmul_fp8 as mf

    N, D, Fo = 2048, 768, 2304
    x8, w8 = fp8_inputs(N, D, Fo, torch.Generator(device="cuda").manual_seed(SEED), {})
    route = mf._route(D, x8.data_ptr(), w8.data_ptr())
    y = torch.empty((N, Fo), device="cuda")
    one = torch.ones((), device="cuda")
    saved = (mf.matmul_fp8.launches, mf.matmul_fp8.simt_launches)
    ms = cuda_graph_time_ms(lambda: mf.matmul_fp8(x8, w8))
    kernel_ms = cuda_graph_time_ms(lambda: mf._launch(route, x8, w8, y))
    simt_ms = cuda_graph_time_ms(lambda: mf._launch("simt", x8, w8, y))
    plain_ms = cuda_graph_time_ms(lambda: mf.reference_matmul_fp8(x8, w8))
    library_ms = cuda_graph_time_ms(
        lambda: torch._scaled_mm(x8, w8.t(), scale_a=one, scale_b=one, out_dtype=torch.float32))
    eager_ms = cuda_time_ms(lambda: mf.matmul_fp8(x8, w8))
    mf.matmul_fp8.launches, mf.matmul_fp8.simt_launches = saved  # timing launches do not count
    nbytes = N * D + Fo * D + 4 * N * Fo
    flops = 2 * N * D * Fo
    bound_ms, bound_by = _bound(nbytes, flops, torch.float8_e4m3fn)
    log(f"[C] matmul_fp8 N={N} D={D} F={Fo} e4m3fn -> fp32, device times by CUDA-graph replay: the wrapper "
        f"({route}) {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), its bare kernel {kernel_ms:.4f} ms, CUDA-core "
        f"kernel {simt_ms:.4f} ms, plain {plain_ms:.4f} ms, library (torch._scaled_mm) {library_ms:.4f} ms; the "
        f"wrapper eager {eager_ms:.4f} ms (CUDA events); bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"matmul_fp8": dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                               kernel_ms=kernel_ms, simt_ms=simt_ms, path_route=route, eager_ms=eager_ms)}


def _phase_c_new():
    """matmul_bias at the smp.nn path's fused QKV (N 2048, D 768, F 2304)
    and the bias_gelu wrappers at its MLP epilogue ([2048, 3072]), bf16:
    kernel on its route and forced onto the CUDA-core one, plain version and
    one library call computing the same function (``torch.addmm``;
    ``F.gelu(x + b, approximate="tanh")`` and its autograd backward, dx and
    db), which the port never calls, all by CUDA-graph replay (the library
    backward captured on its forward's stream); the bound from the bytes each
    input and output moves once and the operations at their type's peak."""
    import torch.nn.functional as F

    from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
    from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb
    from smdistributed_modelparallel_tpu_torch.ops.matmul_bias import matmul_bias_fwd, reference_matmul_bias

    counters = {**_new_counters(), **_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtype, esz = torch.bfloat16, 2
    out = {}

    # matmul_bias: device times by CUDA-graph replay in one call: the wrapper
    # as the path calls it (its bf16 bias read by the kernel as it is), its
    # tensor-core kernel's bare launch, the CUDA-core kernel, the plain
    # version and torch.addmm; the wrapper's eager time (CUDA events, host
    # launch cost included) beside.
    N, D, Fo = 2048, 768, 2304
    x, w, b = mb_inputs(N, D, Fo, dtype, gen, {})
    y = torch.empty((N, Fo), dtype=dtype, device="cuda")
    route = mb._route(dtype, D, x.data_ptr(), w.data_ptr())
    ms = cuda_graph_time_ms(lambda: matmul_bias_fwd(x, w, b))
    kernel_ms = cuda_graph_time_ms(lambda: mb._launch(route, x, w, b, y))
    simt_ms = cuda_graph_time_ms(lambda: mb._launch("simt", x, w, b, y))
    plain_ms = cuda_graph_time_ms(lambda: reference_matmul_bias(x, w, b))
    library_ms = cuda_graph_time_ms(lambda: torch.addmm(b, x, w.t()))
    eager_ms = cuda_time_ms(lambda: matmul_bias_fwd(x, w, b))
    nbytes = (N * D + Fo * D + Fo + N * Fo) * esz
    flops = 2 * N * D * Fo
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    out["matmul_bias"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                              kernel_ms=kernel_ms, simt_ms=simt_ms, path_route=route, eager_ms=eager_ms)
    log(f"[C] matmul_bias N={N} D={D} F={Fo} bf16, device times by CUDA-graph replay: the wrapper ({route}) "
        f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), its bare kernel {kernel_ms:.4f} ms, CUDA-core kernel "
        f"{simt_ms:.4f} ms, plain {plain_ms:.4f} ms, library (torch.addmm) {library_ms:.4f} ms; the wrapper eager "
        f"{eager_ms:.4f} ms (CUDA events); bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")

    # bias_gelu at the MLP epilogue, bf16 x, g and b as the path passes them:
    # each wrapper on its route ("vec") and forced onto "simt" (the backward
    # there is the dpre kernel, the b widening, the cast and the row sum), the
    # simt dpre kernel alone, the plain version and the library call. Bounds:
    # the forward reads x (and b) and writes y; the whole backward reads x, g
    # (and b) and writes dx (and db). Replaying one input set reads it from
    # L2 (x and g are 25 MB of its 50), so the wrappers and the library are
    # also timed cold, over GELU_COPIES copies of the inputs in turn.
    N, Fo = 2048, 3072
    x, b, g = gelu_inputs(N, Fo, dtype, gen, {})
    dpre = torch.empty((N, Fo), device="cuda")
    sets = copies_of((x, b, g), GELU_COPIES)

    def gelu(x_, b_):
        return F.gelu(x_ + b_, approximate="tanh")

    # Operations per element, as the kernels do them in fp32: the forward's
    # add, cube (3), add, scale, tanh (counted as 1), add, 2 multiplies; the
    # backward's add, inner (5), tanh, sech2 (2), dinner (4), left (2),
    # right (3), sum, the product with g and db's add.
    rows = (
        ("bias_gelu_fwd", bg.bias_gelu_fwd, (x, b), bg.reference_bias_gelu, 2 * N * Fo * esz + Fo * esz,
         10 * N * Fo, "F.gelu(x + b, approximate='tanh')", bg._route(dtype, Fo, x.data_ptr()),
         cuda_graph_time_ms(lambda: gelu(x, b)), cuda_graph_time_ms(rotating(lambda x_, b_, g_: gelu(x_, b_), sets))),
        ("bias_gelu_bwd", bg.bias_gelu_bwd, (x, b, g), bg.reference_bias_gelu_grads, 3 * N * Fo * esz + 2 * Fo * esz,
         21 * N * Fo, "its autograd backward, dx and db", bg._route(dtype, Fo, x.data_ptr(), g.data_ptr()),
         library_bwd_ms(gelu, (x, b), g), library_bwd_ms(gelu, (x, b), g, GELU_COPIES)),
    )
    for name, wrapper, args, plain, nbytes, flops, what, route, library_ms, library_cold_ms in rows:
        n_args = len(args)
        ms = cuda_graph_time_ms(lambda: wrapper(*args))
        cold_ms = cuda_graph_time_ms(rotating(lambda *a: wrapper(*a[:n_args]), sets))
        with mock.patch.object(bg, "_route", lambda *a: "simt"):
            simt_ms = cuda_graph_time_ms(lambda: wrapper(*args))
            simt_cold_ms = cuda_graph_time_ms(rotating(lambda *a: wrapper(*a[:n_args]), sets))
        plain_ms = cuda_graph_time_ms(lambda: plain(*args))
        eager_ms = cuda_time_ms(lambda: wrapper(*args))
        bound_ms, bound_by = _bound(nbytes, flops, torch.float32)  # the operations are fp32
        out[name] = dict(ms=ms, simt_ms=simt_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, path_route=route, eager_ms=eager_ms, cold_ms=cold_ms,
                         simt_cold_ms=simt_cold_ms, library_cold_ms=library_cold_ms)
        extra = ""
        if name == "bias_gelu_bwd":
            out[name]["simt_kernel_ms"] = cuda_graph_time_ms(lambda: bg._launch("simt", x, b, g, dpre))
            extra = f" (its dpre kernel alone {out[name]['simt_kernel_ms']:.4f})"
        log(f"[C] {name} N={N} F={Fo} bf16, device ms by CUDA-graph replay, inputs in L2 / cold: the wrapper "
            f"({route}) {ms:.4f} / {cold_ms:.4f} ({bound_ms / cold_ms:.1%} of the bound cold), forced onto simt "
            f"{simt_ms:.4f} / {simt_cold_ms:.4f}{extra}, library ({what}) {library_ms:.4f} / {library_cold_ms:.4f}; "
            f"plain {plain_ms:.4f}; the wrapper eager {eager_ms:.4f} (CUDA events); bound {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
    for k, fn in counters.items():
        fn.launches = saved[k]  # timing launches do not count
    return out


CE_TIMING_N = (2048, CAP_BATCH * CAP_SEQ)  # phase T's microbatch; the capacity path's


def _phase_c_ce():
    """The fused-CE kernels at the GPT-2 124M head (D 768, V 50257, bf16) at
    N = 2048 and at the capacity path's N = 32768 (fewer iterations): each
    kernel against its plain version on the timed inputs (phase B's
    tolerances; the capacity shape's error goes into the kernels line), then
    kernel, plain version and the library yardstick, two PyTorch calls (the
    logits GEMM and ``F.cross_entropy``; for dx and dW together, their
    autograd backward), since no single call computes this function. Each
    wrapper runs on its route (the tensor cores) and forced onto the CUDA
    cores in the same call."""
    import torch.nn.functional as F

    from smdistributed_modelparallel_tpu_torch.ops import fused_ce as fc

    counters = {**_ce_counters(), **_ce_simt_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtype = torch.bfloat16
    D, V = 768, 50257
    for dw in (False, True):
        log(f"[C] fused_ce_bwd_{'dw' if dw else 'dx'} tensor-core route at D={D}: clusters of {-(-D // 256)} CTAs, "
            f"{fc.max_clusters(torch.device('cuda'), dw, D)} resident at once (cudaOccupancyMaxActiveClusters)")
    out, failures = {}, []
    for N in CE_TIMING_N:
        iters, warmup = (5, 1) if N <= 2048 else (2, 1)
        x, w, t, _ = ce_inputs(N, V, D, dtype, gen, {})
        g = torch.full((N,), 1.0 / N, device="cuda")  # the mean loss's cotangent
        for kname, (err, ok, detail) in _ce_compare(x, w, t, g).items():
            log(f"[C] {kname:15s} N={N} V={V} D={D} bf16 against its plain version: {detail} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{kname}/N={N}")
            if N == CAP_BATCH * CAP_SEQ:
                out[kname] = dict(max_abs_err=err)
        lse = fc.fused_ce_fwd_reference(x, w, t)[0]
        xr, wr = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        lib_loss = F.cross_entropy(xr @ wr.t(), t, reduction="none")
        lib_fwd_ms = cuda_time_ms(lambda: F.cross_entropy(x @ w.t(), t, reduction="none"), iters, warmup)
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(lib_loss, (xr, wr), g, retain_graph=True),
                                  iters, warmup)
        del lib_loss
        esz = 2
        in_bytes = (N + V) * D * esz + N * t.element_size()  # x, w, targets
        flop = 2 * N * V * D  # one [N x V x D] product
        rows = (
            ("fused_ce_fwd", lambda: fc.fused_ce_fwd(x, w, t), lambda: fc.fused_ce_fwd_reference(x, w, t),
             in_bytes + 2 * N * 4, flop, lib_fwd_ms, "logits GEMM + F.cross_entropy"),      # lse, tgt out
            ("fused_ce_bwd_dx", lambda: fc.fused_ce_bwd_dx(x, w, t, lse, g),
             lambda: fc.fused_ce_bwd_dx_reference(x, w, t, lse, g),
             in_bytes + 2 * N * 4 + N * D * esz, 2 * flop, lib_bwd_ms,                       # lse, g in; dx out
             "their autograd backward, dx and dW together"),
            ("fused_ce_bwd_dw", lambda: fc.fused_ce_bwd_dw(x, w, t, lse, g),
             lambda: fc.fused_ce_bwd_dw_reference(x, w, t, lse, g),
             in_bytes + 2 * N * 4 + V * D * esz, 2 * flop, lib_bwd_ms, "the same call"),   # dW out
        )
        for name, kernel, plain, nbytes, flops, library_ms, what in rows:
            ms = cuda_time_ms(kernel, iters, warmup)
            plain_ms = cuda_time_ms(plain, iters, warmup)
            bound_ms, bound_by = _bound(nbytes, flops, dtype)
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
            seam = "_fwd_route" if name == "fused_ce_fwd" else "_route"  # its route, and the CUDA-core kernel forced
            with mock.patch.object(fc, seam, lambda *a: "simt"):
                timing["simt_ms"] = cuda_time_ms(kernel, iters, warmup)
            timing["path_route"] = getattr(fc, seam)(x, w)
            # The tensor-core backward issues 3 products of 2 N V D (z, dlog's hi and lo parts).
            issued = "" if name == "fused_ce_fwd" else f", {1.5 * flops / ms / 1e9:.2f} issued"
            line = (f"wrapper ({timing['path_route']}) {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s of the "
                    f"function's{issued}), CUDA-core kernel {timing['simt_ms']:.4f} ms "
                    f"({flops / timing['simt_ms'] / 1e9:.2f} TFLOP/s)")
            log(f"[C] {name} N={N} V={V} D={D} bf16: {line}, plain {plain_ms:.4f} ms, library ({what}) "
                f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.1f} GFLOP)")
            if N == CAP_BATCH * CAP_SEQ:  # the capacity path's shape goes into the kernels line
                out[name].update(timing)
        del x, w, t, g, lse, xr, wr
        torch.cuda.empty_cache()
    for k, fn in counters.items():
        fn.launches = saved[k]  # comparison and timing launches do not count
    if failures:
        raise RuntimeError(f"fused-CE kernel disagrees with its plain version at the timed shapes: {failures}")
    return out


def _profile_report(label, prof, wall_ms, top):
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[P] {label}: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms, "
        f"idle share {1 - device_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[P]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def phase_p():
    """Where one greedy ``generate``, one training step, one capacity step
    (fused CE and materialized logits) and the smp.nn path's steps spend
    their time, by torch.profiler: device time by kernel and the device's
    idle share of the wall time."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    B, T, NEW = 4, 512, 32
    smp.init({"bf16": True})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = smp.DistributedModel(init_gpt2_weights_(gpt2_124m(device="cuda"), g), device="cuda")
    prompts = torch.randint(0, 50257, (B, T), generator=g, device="cuda")
    smp.generate(model, prompts, 2)
    for new in (1, NEW):
        prof, wall_ms = profiled(lambda: smp.generate(model, prompts, new))
        _profile_report(f"generate B={B} T={T} new={new}", prof, wall_ms, 8)

    model, optimizer, train_step = _train_setup(init_gpt2_weights_(gpt2_124m(device="cuda"), g),
                                                TRAIN_MB, True, "cuda")
    ids = torch.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    for _ in range(TRAIN_WARMUP):
        train_step(model, ids)
        optimizer.step()

    def one_step():
        train_step(model, ids)
        optimizer.step()

    prof, wall_ms = profiled(one_step)
    _profile_report(f"training step batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MB} microbatches", prof, wall_ms, 14)
    del model, optimizer, train_step

    # The capacity step, under the default policy (fused CE kernels) and with
    # materialized logits (its yardstick), from the same weights.
    cap_init = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
    ids = torch.randint(0, 50257, (CAP_BATCH, CAP_SEQ), generator=g, device="cuda")
    for label, cfg in (("fused CE", {}), ("materialized, fused_ce: False", {"fused_ce": False})):
        model, optimizer, train_step = _train_setup(copy.deepcopy(cap_init), 1, True, "cuda", **cfg)
        for _ in range(CAP_WARMUP):
            train_step(model, ids)
            optimizer.step()
        prof, wall_ms = profiled(one_step)
        _profile_report(f"capacity step batch {CAP_BATCH} x {CAP_SEQ}, 1 microbatch, {label}", prof, wall_ms, 14)
        del model, optimizer, train_step
        torch.cuda.empty_cache()
    del cap_init

    # The smp.nn path's step, fused and unfused, from the same weights.
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    lm = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    lm_state = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    del lm
    ids = torch.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    for label, fused, smp_cfg in (("fused", True, {}), ("unfused", False, {}),
                                  ("fused, matmul_precision: fp8", True, {"matmul_precision": "fp8"})):
        model, optimizer, train_step = _lm_setup(lm_state, fused, "cuda", **smp_cfg)
        for _ in range(TRAIN_WARMUP):
            train_step(model, ids)
            optimizer.step()
        prof, wall_ms = profiled(one_step)
        _profile_report(f"smp.nn step batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MB} microbatches, {label}", prof,
                        wall_ms, 16)
        del model, optimizer, train_step
    smp.reset()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=DEFAULT_PHASES,
                        help="phases to run: A, T, F, L, Q, R, B, C (the default, all eight), P (profiles) and N (phase R's "
             "ranks on two cards, over NCCL)")
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
    serve_launches, train_launches, cap_launches, lm_launches, q_launches, cp_launches = {}, {}, {}, {}, {}, {}
    errs = timing = None
    if "A" in args.phases:
        serve_launches = phase_a()
    if "T" in args.phases:
        train_launches, _ = phase_t()
    if "F" in args.phases:
        cap_launches, _ = phase_f()
    if "L" in args.phases:
        lm_launches, _ = phase_l()
    if "Q" in args.phases:
        q_launches, _ = phase_q()
    if "R" in args.phases:
        cp_launches, _ = phase_r()
    if "N" in args.phases:
        phase_r(device=None)
    if "B" in args.phases:
        errs = phase_b()
    if "C" in args.phases:
        timing = phase_c()
    if "P" in args.phases:
        phase_p()

    if not set(DEFAULT_PHASES) <= set(args.phases):
        return 0  # a partial run prints no result
    fwd_err, bwd_err, new_err = errs
    # Launches on the main paths: serving's prefills (A), training (T), the
    # capacity path (F), the smp.nn path (L), its fp8 run (Q) and the
    # context-parallel run (R: both ranks and the cp = 1 run), each counted
    # from 0 just before it.
    paths = (serve_launches, train_launches, cap_launches, lm_launches, q_launches, cp_launches)
    launches = {k: sum(p.get(k, 0) for p in paths)
                for k in {**cap_launches, **lm_launches, **q_launches, **cp_launches}}
    src = "smdistributed_modelparallel_tpu_torch/csrc/"
    tpu = "smdistributed_modelparallel_tpu/ops/pallas_attention.py:"
    tpu_ce = "smdistributed_modelparallel_tpu/ops/pallas_ce.py:"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=src + "flash_fwd.cu", replaces=tpu + "162",
             launches=launches["flash_fwd"], max_abs_err=fwd_err, **timing["flash_fwd"]),
        dict(name="flash_bwd_dq", route="cuda", source=src + "flash_bwd.cu", replaces=tpu + "266",
             launches=launches["flash_bwd_dq"], max_abs_err=bwd_err["flash_bwd_dq"],
             **timing["flash_bwd_dq"]),
        dict(name="flash_bwd_dkv", route="cuda", source=src + "flash_bwd.cu", replaces=tpu + "351",
             launches=launches["flash_bwd_dkv"], max_abs_err=bwd_err["flash_bwd_dkv"],
             **timing["flash_bwd_dkv"]),
    ] + [  # max_abs_err and times at the capacity path's shape (phase C)
        dict(name=name, route="cuda", source=src + "fused_ce.cu", replaces=tpu_ce + line,
             launches=launches[name], **timing[name])
        for name, line in (("fused_ce_fwd", "46"), ("fused_ce_bwd_dx", "95"), ("fused_ce_bwd_dw", "130"))
    ] + [  # max_abs_err at the smp.nn path's shapes (bf16; e4m3 for matmul_fp8; phase B), times there (C)
        dict(name=name, route="cuda", source=src + source, replaces="smdistributed_modelparallel_tpu/ops/" + replaces,
             launches=launches[name], max_abs_err=new_err[name], **timing[name])
        for name, source, replaces in (("matmul_bias", "matmul_bias.cu", "pallas_qkv.py:54"),
                                       ("bias_gelu_fwd", "bias_gelu.cu", "pallas_gelu.py:54"),
                                       ("bias_gelu_bwd", "bias_gelu.cu", "pallas_gelu.py:59"),
                                       ("matmul_fp8", "matmul_fp8.cu", "pallas_qkv.py:162"))
    ] + [  # max_abs_err over phase R's ring pairs (bf16; phase B), times there (C)
        dict(name=name, route="cuda", source=src + source, replaces=tpu + line, launches=launches[name],
             max_abs_err=new_err[name], **timing[name])
        for name, source, line in (("flash_fwd_ids", "flash_fwd.cu", "796"),
                                   ("flash_bwd_dq_ids", "flash_bwd.cu", "821"),
                                   ("flash_bwd_dkv_ids", "flash_bwd.cu", "821"))
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
