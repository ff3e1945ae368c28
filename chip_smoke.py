#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py --phases B # kernel-vs-plain comparisons only
    python3 chip_smoke.py --phases S # the serving engine (continuous batching, paged KV cache) only
    python3 chip_smoke.py --phases G # generation through the smp.nn LM head and int8 serving only
    python3 chip_smoke.py --phases T # the training path only
    python3 chip_smoke.py --phases F # the capacity path (fused cross-entropy) only
    python3 chip_smoke.py --phases L # the smp.nn path (fused QKV, fused bias-GELU) only
    python3 chip_smoke.py --phases D # the smp.nn path with GPT-2's dropouts 0.1 only
    python3 chip_smoke.py --phases M # activation checkpointing (GPT-2 124M and 1.5B) only
    python3 chip_smoke.py --phases Q # the smp.nn path under matmul_precision: fp8 only
    python3 chip_smoke.py --phases R # context-parallel training (two ranks on one card) only
    python3 chip_smoke.py --phases K # checkpoints and the data loader on the smp.nn path only
    python3 chip_smoke.py --phases H # HuggingFace models through smp.from_hf only
    python3 chip_smoke.py --phases E # the encoder-decoder, T5 through smp.from_hf and MoE only
    python3 chip_smoke.py --phases O # observability (telemetry, timeline, goodput, profiling, time series) only
    python3 chip_smoke.py --phases V # resilience (sentinel, OOM post-mortem, preemption, chaos, fleet) only
    python3 chip_smoke.py --phases r # phase R with the ranks on two cards (NCCL); needs two cards
    python3 chip_smoke.py --phases W # data parallelism at rdp = 2 (two ranks on one card) only
    python3 chip_smoke.py --phases Y # the same with the ranks on two cards (NCCL); needs two cards
    python3 chip_smoke.py --phases U # expert parallelism at ep = 2 (two ranks on one card) only
    python3 chip_smoke.py --phases Z # the same with the ranks on two cards (NCCL); needs two cards
    python3 chip_smoke.py --phases N # tensor parallelism at tp = 2 (two ranks on one card) only
    python3 chip_smoke.py --phases I # phase N (a) and (g) with the ranks on two cards (NCCL); needs two cards
    python3 chip_smoke.py --phases p # pipeline parallelism at pp = 2 (two stages on one card) only
    python3 chip_smoke.py --phases t # phase p (a) with the stages on two cards (NCCL); needs two cards
    python3 chip_smoke.py --phases J # serving replicas, the router and the controller (two processes) only
    python3 chip_smoke.py --phases X # GPT-2 1.5B at 16 x 1024 with checkpointing off (its peak or OOM)

Builds the port's CUDA kernels from ``smdistributed_modelparallel_tpu_torch/
csrc`` (one nvcc per source, all started together), then:

  A. the main path: ``smp.generate`` on GPT-2 124M at full width (d 768,
     12 layers, 12 heads, vocab 50257) with random GPT-2-style weights from
     a seed, bf16, 4 prompts of 512 tokens, 32 new tokens, greedy and
     sampled (temperature 0.8, top-k 50, top-p 0.95, a key from the seed);
     each kernel's launch count is set to 0 just before and read just after,
     and must show one flash launch per layer per prefill and one
     ``threefry_bits`` launch (the Gumbel draw over [4, 50257]) per sampled
     token. A repeat with the same key gives the same tokens, and the
     Gumbel bits equal the plain version's. A small fp32 model is also held
     against the same weights run on the CPU.
  S. the serving engine: ``smp.serving.ServingEngine`` on phase A's model
     and weights (GPT-2 124M, bf16) with 8 slots and a pool of 129 blocks of
     16 tokens (a quarter of full provisioning, so admission waits for blocks
     that finished streams release) serves 16 requests arriving at once
     (prompts of 32-512 tokens and 16-128 new tokens drawn from the seed; 4
     sampled with temperature 0.8, top-k 50, top-p 0.95, seeds 0-3),
     ticked from outside: tokens/s and requests/s over the burst, TTFT
     p50/p90/p99 and ITL p50/p99 from the slots' token times, mean decode-
     step and prefill-chunk ms, peak blocks used and the ticks admission
     waited on blocks, against the same requests through ``smp.generate``
     one at a time (the yardstick). The burst launches no flash kernel (the
     prefill mask varies along the chunk, decode has T = 1: the plain path,
     as in the JAX package) and ``threefry_bits`` once a sampled token.
     Gates: (a) every greedy token within 5e-2 of max |logit| of its row's
     maximum in a teacher-forced bf16 forward on the plain attention path;
     (b) a small fp32 model (phase A's, learned and rotary) serves 6 ragged
     requests with the same tokens on the card, on the CPU and through the
     card's ``smp.generate``; (c) the pool drained; (d) the sampled streams
     repeat from their seeds; (e) admission waited on blocks in some tick.
  G. generation through ``smp.nn.DistributedTransformerLMHead`` (GPT-2 124M
     widths as phase L, ``fused_bias_gelu=True``, ``fused_qkv: True``, bf16,
     random weights from the seed): G1, 4 prompts of 64-512 tokens drawn from
     the seed, left-padded with ``attention_mask``, 32 new tokens greedy and
     sampled (phase A's filters, a key from the seed): prefill ms, decode
     ms/token, tokens/s, and 12 ``flash_fwd`` launches a prefill (the key-
     padding bias), 12 ``matmul_bias`` and 12 ``bias_gelu_fwd`` a forward call
     (decode steps at N = 4 rows); G2, 2 prompts of 128 tokens, 4 beams, 2
     returned, 32 new tokens, without EOS and with the EOS-free beams' most
     frequent token as EOS: ms/token and each returned beam's teacher-forced fp32
     log-prob sum beside the greedy continuation's (reported); G3, G1's
     prompts under ``SMP_SHAPE_BUCKETS="seq:64,128,256,512"`` with 20 new
     tokens (64 steps run); G4, G1's greedy under ``SMP_DECODE_WEIGHTS=int8``,
     then phase S's burst through the zoo engine under both int8 knobs:
     tokens/s, TTFT and ITL beside phase S's bf16 burst of the same call, the
     pools' MiB, the greedy tokens' agreement with the bf16 burst. Gates: (a)
     every greedy token of G1, G3 and the int8 runs within 5e-2 of max |logit|
     of its row's maximum in a teacher-forced forward on the plain attention
     path (fake-quantized weights for int8; for the burst a one-slot paged
     forward through the int8 pools); (b) small fp32 smp.nn heads (learned and
     NeoX rotary, std 0.5) give the CPU's tokens with padded prompts, beams
     with and without EOS, buckets and int8 weights, a padded row its prompt's
     alone, the small zoo engine under int8 weights ``smp.generate``'s tokens
     under them and under both int8 knobs the CPU engine's (its agreement with
     generate reported: the int8 pools round K and V); (c) sampled G1 and the
     beams repeat; (d) no launch of G1-G4 on a CUDA-core route.
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
  D. the ``smp.nn`` path with dropout: phase L's model, weights and batch
     (fused knobs, bf16, 8 x 1024 tokens in 4 microbatches, AdamW) with
     attention, hidden and embedding dropout 0.1 (GPT-2's published
     ``attn_pdrop``, ``resid_pdrop`` and ``embd_pdrop``), against the
     dropout-0 step from the same weights, 2 warm-up steps each, then 12
     timed steps each in interleaved blocks of 6 (dropout, dropout 0,
     dropout 0, dropout). Each step of the dropout run launches the flash
     kernels 48 times each on the tensor cores with their dropout hash, and
     ``dropout_fwd`` and ``dropout_bwd`` 100 times each (the embedding's and
     each layer's attention-output and MLP-output dropout, 25 sites, in 4
     microbatches); the dropout-0 run none of them. The kept share of one
     embedding mask and one hidden mask lies within 0.9 +- 0.002; the
     losses are finite and fall; two 3-step runs from the same weights and
     ``tensor_parallel_seed`` give equal losses, another seed other losses.
     A small fp32 model (2 layers, T 64: attention on the plain path, its
     dropout through the kernel over the probabilities) with all three
     dropouts takes one step on the card and on the CPU from the same
     weights and seed: losses within rtol 2e-4 / atol 2e-5 and gradients
     within rtol 2e-3 / atol 2e-4 (``tests/test_torch_step.py``'s fp32
     tolerances).
  M. activation checkpointing (``activation_checkpointing=True`` on the LM
     head; ``recompute`` and ``offload_activations`` from the config), with
     phase L's AdamW, step and fused knobs, bf16. (a) Phase L's model,
     weights and batch: at dropout 0, checkpointing off against ``full``;
     with GPT-2's dropouts 0.1, the five modes (off, full, stash_weight,
     stash_all, offload) in interleaved blocks A B C D E E D C B A, each a
     fresh ``smp.init`` and model from the same weights, 2 warm-up and 3
     timed steps. Step 1's gradients of every parameter agree with full's to
     1e-6 of each tensor's largest value (bit-equality is printed) and every
     layer parameter has one; a recompute drawing other masks fails here.
     Launches a step under full (and stash_weight, offload): 96 flash
     forwards, 48 dq and dk/dv, 96 ``matmul_bias`` and ``bias_gelu_fwd``, 48
     ``bias_gelu_bwd``, 196 ``dropout_fwd`` (4 embedding + 96 + 96
     recomputed), 100 ``dropout_bwd``; off and stash_all launch each forward
     kernel once a layer. ms/step, tokens/s and peak memory of each mode.
     One fp8 step on and off: equal finalized quant state (1e-6). (b) GPT-2
     1.5B (48 layers, 25 heads, d 1600, vocab 50257, GPT-2 XL's dropouts
     0.1) as ``smp.nn.DistributedTransformerLMHead``, one microbatch: at 4 x
     1024, off, stash_all and full (2 AdamW steps each; step 1's gradients
     as in (a); peaks over step 2); at 16 x 1024, full and offload (1
     warm-up and 3 timed steps: ms/step, tokens/s, peak, losses finite and
     falling, offload's peak lower at the same losses and its layer inputs
     moved to pinned host memory); every 1.5B run launches what ``_m_want``
     counts each step, none on a CUDA-core route; the off case at 16 x 1024
     is not run, its peak is predicted from the per-token slopes (phase X
     runs it).
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
     kernels instead. Then rdp 2 x cp 2: four ranks on cuda:0, each handed
     its rdp coordinate's row (``smp.shard_batches``), 2 ring steps at full
     depth against the same cp = 1 losses within 1e-2, the four replicas'
     parameter fingerprints equal after every step, 24 launches of each
     ids-mode kernel a step and rank, all on ``wgmma``.
  U. expert parallelism at ep = 2: two ranks spawned on cuda:0 (gloo with
     pinned host copies) train phase E3's MoE model (GPT-2 124M widths, 4
     experts a layer, top-2, capacity 1.25, bf16, ``fused_qkv``, phase T's
     global batch of 8 x 1024 in 4 microbatches, 4 rows a rank, AdamW) for 3
     steps, each rank holding two experts of every layer, against this
     process's ep = 1 run of the same weights and batch (laid out so that
     each microbatch holds the same rows). Holds: the losses within 1e-2 of
     ep = 1; the dense parameters bit-equal across the ranks after every
     step; 48 launches a step of each flash kernel and of ``matmul_bias``
     per rank, all on ``wgmma``; a 2-layer fp32 MoE (capacity 0.5, so
     assignments drop) at ep = 2 on the card against the CPU within 1e-5.
     Prints ms/step, global tokens/s, the all-to-alls' and the gradient
     all-reduce's host ms a step and the peak a rank.
  W. data parallelism at rdp = 2: two ranks spawned on cuda:0 (gloo with
     pinned host copies, as in phase R; the native host bus built from
     ``native/src`` into ``_build/``) train GPT-2 124M (bf16, AdamW, phase
     T's global batch of 8 x 1024 in 4 microbatches: 4 x 1024 a rank, 1 x
     1024 a microbatch), against this process's rdp = 1 run of the same
     weights and batch. In one two-rank world: (a) the control plane
     (ordered ``smp.send``/``recv_from``, a 1 MB ``smp.broadcast``,
     ``smp.allgather``, the barriers, the rank queries; the round trip and
     the broadcast timed); (b) 6 steps whose losses agree with rdp = 1
     within 1e-2, the replicas' parameter fingerprints equal after every
     step and their bits equal at the end, 48 launches of each flash kernel
     a step and rank, all on ``wgmma``, the step's and the gradient
     all-reduce's times, and a 2-layer fp32 model at rdp = 2 on the card
     against the CPU within 1e-5; (c) a checkpoint after step 3 (timed,
     sized); (d) SIGTERM to rank 1 at step edge 3: both save
     ``preempt_step_3`` and exit, rank 0 on rank 1's notice; (e) the fleet
     plane's merged ``smp_step_total`` against both registries; (f) the
     exit relay at ``smp.shutdown``. Here: the one-process elastic resume
     of (c)'s checkpoint. In a second two-rank world: (c) and (d)'s
     checkpoints resume and repeat (b)'s losses bit for bit, then (g) under
     ``SMP_SUPERVISOR=on`` rank 1 drops two heartbeats (classifying
     nothing) and is SIGKILLed at step edge 3; rank 0 classifies it dead,
     agrees on the newest committed checkpoint, re-forms a world of one and
     trains on within 1e-2 of rdp = 1 (MTTR and its phases printed).
  N. tensor parallelism at tp = 2: two ranks spawned on cuda:0 (gloo with
     pinned host copies), each handed the whole batch, against tp = 1 of
     the same weights and batch in this process. (a) phase L's model (GPT-2
     124M widths, ``fused_qkv`` and ``fused_bias_gelu``, bf16, 8 x 1024 in 4
     microbatches, AdamW) 3 steps in Megatron's layout (``optimize:
     "speed"``): losses within 1e-2 of tp = 1, the replicated parameters
     bit-equal across the ranks after every step, 48 launches a step and
     rank of each flash kernel (6 heads a rank) on ``wgmma`` and of each
     bias-GELU kernel on ``vec``, none of ``matmul_bias`` (the fused QKV is
     inert at tp > 1, as in the JAX package); (b) the same under ``optimize:
     "memory"`` (sequence-parallel residual stream); (c) a 2-layer fp32 model
     at tp = 2 in both layouts, card against CPU within 1e-5 (losses and the
     first step's gradients); (d) vocab 50304 (nanoGPT's padded GPT-2
     vocabulary), loss mode, 8 x 1024 tokens in one microbatch, ``fused_ce:
     True`` (the vocab-parallel fused CE: one launch a step and rank of each
     fused-CE kernel on ``wgmma``) against ``False``, losses within 1e-2,
     ms/step and peak of both; (e) ``smp.generate`` on phase G1's padded
     batch, 32 new tokens greedy: every token within 5e-2 of max |logit| of
     its row's maximum in a tp = 1 forward, the ranks' tokens equal, a small
     fp32 model's tokens equal on card and CPU, prefill ms and decode
     ms/token; (f) (a)'s partial checkpoint after step 2, resumed in a fresh
     pair of processes: step 3's loss bit-equal. (g) ``tp_overlap: "ring"``
     with the fused QKV, 2 steps in each layout: losses within 1e-2 of tp =
     1, 96 ``wgmma`` launches of ``matmul_bias`` a step and rank (layers x
     microbatches x tp: one a ring chunk); (h) GPT-2's dropouts 0.1 in the
     memory layout under the ring, 2 steps: the first microbatch's keep masks
     equal tp = 1's (the rank's T half where the activation is sharded, drawn
     by the index-mapped ``dropout_fwd``), every attention call of it
     hands the flash kernels the rank's global heads (head0 = rank x 6 of
     12) and tp = 1's seed, losses within 1e-3; a control run whose flash
     kernels hash the rank's local heads must land outside that bound; (i)
     activation checkpointing of (a) and of (h): losses within 1e-6 of the
     runs without it, the step's peak above what it found allocated below
     theirs; (j) fp16 (loss scale from 4096) beside
     ``SMP_HEALTH_CHECK=cheap``, and fp8, 2 steps each against tp = 1:
     losses within 1e-2 (fp8: 2e-2 relative), the same overflow flags and
     scales, the amax history within 5e-2 (the first step's weight slots
     equal), the sentinel's words' counts equal and maxima within 5e-2.
     Replicated parameters bit-equal after every step of every run. Prints
     ms/step and global tokens/s of (a), (b) and (g), the tp regions' host
     ms a step and the peak a rank.
  p. pipeline parallelism at pp = 2: two stages spawned on cuda:0 (gloo
     with pinned host copies), 6 layers a stage, against pp = 1 of the same
     weights and batch in this process, phase T's batch (8 x 1024 in 4
     microbatches), bf16, AdamW, the loss from the logits. (a) GPT-2 124M, 3
     steps under the default 1F1B schedule, then one forward-only step
     (fill-drain); its control drops microbatch 0's backward (the last
     stage seeds its loss with 0) and must land outside the loss bound; (b)
     the same under ``pipeline: "simple"`` (fill-drain), 2 steps; (c) phase
     L's smp.nn head (``fused_qkv``, ``fused_bias_gelu``), 3 steps; (d) a
     2-layer fp32 GPT-2 at pp = 2, card against CPU within 1e-5. Gates:
     losses within 1e-4 relative of pp = 1, both stages returning the same
     losses, the replicated parameters bit-equal across the stages after
     every step, each stage holding its 6 layers only, 24 launches a step
     and stage of each flash kernel (and of ``matmul_bias`` and the bias-
     GELU kernels for the head) on ``wgmma`` or ``vec``, and the bubble
     gauges equal to ``schedule_occupancy`` of the grid. Prints ms/step and
     global tokens/s, the P2P transfers' host ms a step, each stage's peak
     and parameter bytes.
  J. serving replicas: two processes on cuda:0 over the native host bus,
     each with a GPT-2 124M ``ServingEngine`` (4 slots, 65 blocks). World 1
     (bf16): (c) ``SMP_AUTOSCALE``: 12 requests on rank 0's replica breach a
     queue depth of 2, the controller activates rank 1's parked
     ``ReplicaServer`` (its warm start loads the threefry library from disk:
     no ``nvcc`` build), routes the rest there and drains it back; every
     request finishes once with all its tokens; (a) phase S's 16-request
     burst through ``RequestRouter`` over both replicas, every greedy token
     within 5e-2 of its row's max |logit|; (d) on rank 0 a canary with
     unchanged weights promotes and one with perturbed weights rolls back.
     World 2 (fp32, so that tokens compare exactly across batch
     compositions): (b) ``SMP_CHAOS=kill_replica@request=2:rank=1``: rank 1
     dies mid-decode, rank 0 re-admits its requests from the mirror shadow
     and finishes all six (two sampled) with the tokens of a never-killed
     engine; MTTR and its phases printed.
  K. checkpoints and the data loader: phase L's model, widths and weights
     (fused knobs, bf16, 8 x 1024 tokens in 4 microbatches, AdamW) fed by
     ``smp.dataloader`` over a seeded host stream of token batches; 3 steps,
     then ``smp.save_checkpoint`` partial (with ``user_content``) and full,
     then 3 more steps (the uninterrupted run). A fresh interpreter
     (``--k-child``) runs ``smp.init``, ``resume_from_checkpoint`` before the
     model exists, builds the model from another seed and trains the same 3
     steps: its losses must equal the uninterrupted run's bit for bit, its
     ``user_content`` and ``step_count`` come back, and each of its launches
     is counted as phase L counts them (48 a step of each flash,
     ``matmul_bias`` and bias-GELU kernel, on the tensor-core or "vec"
     route). The full checkpoint resumes here to the same losses. A
     ``blocking=False`` save followed at once by a step (which updates the
     weights in place) must hold the submission's bits after
     ``wait_for_checkpoints()``. Prints the checkpoint's bytes, save and
     restore seconds and GB/s, and phase L's step time with and without
     ``smp.dataloader`` prefetch, each with its device idle share
     (torch.profiler), stamped with the card's name and power limit. The
     checkpoints go to ``chip_smoke_ckpt/`` beside this script and are
     removed at the end.
  H. HuggingFace models through ``smp.from_hf``, each an ``HFModel`` (the
     source's config.json fields and HF-named tensors made from a random
     normal(0, 0.02) init by the port's own ``translate_state_dict_to_hf``;
     the card's machine has no ``transformers``), whose weights translated
     back must equal the source's bit for bit. H1: GPT-2 124M
     (openai-community/gpt2, dropouts 0.1) under bf16, ``fused_qkv`` and
     ``fused_bias_gelu``: (a) its fp32 logits on 2 x 512 tokens within atol
     2e-4, rtol 2e-3 of an independent plain fp32 GPT-2 forward over the HF
     dict; (b) 1 + 3 AdamW steps of 8 x 1024 tokens in 4 microbatches
     (logits mode): ms/step, tokens/s, losses finite and falling, 48 launches
     a step of each flash, ``matmul_bias`` and bias-GELU kernel on the
     tensor-core or "vec" route and 100 ``dropout_fwd``; (c) greedy
     ``smp.generate`` of 32 tokens after 4 prompts of 512: prefill ms, decode
     ms/token, each token within S_MARGIN of its row's maximum in a
     teacher-forced bf16 forward; (d) ``smp.save_checkpoint(partial=False)``:
     its ``model`` dict has exactly the source's HF keys and shapes, and a
     second ``from_hf`` over it gives bit-equal fp32 logits. H2: GPT-Neo
     125M, Pythia-160M (GPT-NeoX), GPT-J 6B (2 of its 28 layers), BERT base,
     RoBERTa base (4 right-padded rows of 128 to 512 tokens) and the ViT-B/16
     encoder (4 x 197 hidden states) at their published widths, one bf16
     forward each against fp32: decoders' argmax within S_MARGIN of the fp32
     row maximum, encoders' relative error within H_ENCODER_TOL; ms and flash
     launches by route (GPT-J's hd 256 on the CUDA cores; none for GPT-Neo,
     whose local/global switch keeps the plain path, as in the JAX package);
     the flash forward at GPT-J's shape against its plain version. (e) each family at the tiny widths of the CPU tests, fp32,
     card against CPU within 1e-5.
  E. the encoder-decoder and MoE, bf16, ``fused_qkv``, 4 microbatches,
     random normal(0, 0.02) weights from the seed. E1: ``t5_style()`` (the
     default dialect at T5-small's widths: d 512, 6 + 6 layers, 8 heads,
     d_kv 64, d_ff 2048, vocab 32128): (a) 1 + 3 AdamW steps on 16 encoder
     rows of 512 (right-padded to lengths in 128-512, a 2-D mask) and 16
     decoder rows of 128: ms/step, encoder and decoder tokens/s, peak, 18
     launches of each flash kernel (encoder, decoder self- and cross-
     attention) and 12 ``matmul_bias`` a microbatch, all on the tensor cores;
     (b) seq2seq ``smp.generate`` on 4 of those rows, 32 new tokens, greedy,
     sampled (a key from the seed; phase A's filters, which must repeat) and
     4 beams returning 2: each greedy token within S_MARGIN of its row's
     maximum in a teacher-forced bf16 forward; (c) the step of (a) under
     ``activation_checkpointing=True`` (ms/step, peak, the forward kernels
     launched twice), and a small fp32 copy's step-1 gradients equal to the
     unchecked ones within E_GRAD_TOL. E2: HF T5 through ``smp.from_hf``
     (an ``HFModel`` of the published config, as in phase H): t5-small (a)
     fp32 logits on 2 x (512, 128) within atol 2e-4 / rtol 2e-3 of an
     independent plain T5 forward over the HF dict (``plain_t5_logits``);
     (b) 1 + 3 steps of E1's batch with T5's dropouts 0.1 (flash in the
     cross-attention only: the relative bias keeps self-attention on the
     plain path); (c) generation as E1 (b); (d) the full checkpoint in HF
     names and a second ``from_hf`` over it with bit-equal fp32 logits;
     flan-T5-base (gated-gelu, untied): fp32 logits against the plain T5
     forward as in (a), a bf16 forward against fp32 (argmax within
     E_FLAN_MARGIN, and its drift from fp32 within E_FLAN_DRIFT times the
     plain forward's own in bf16) and greedy generation. E3: phase L's model
     with 4 experts a layer (top-2, capacity 1.25) beside the dense model:
     (a) 1 + 3 AdamW steps of 8 x 1024 tokens: ms/step, tokens/s, peak, each
     microbatch's folded aux, 48 launches of each flash kernel and of
     ``matmul_bias`` and none of the bias-GELU kernels a step; (b) a tiny
     fp32 MoE head, top-1 and top-2, card against CPU: logits and two steps'
     losses within E_SMALL_TOL, greedy tokens equal; (c) greedy generation of
     32 tokens after 4 prompts of 512, repeated equal. E4: ``t5_style_3b``
     at 2 + 2 layers (depth cut from 24 + 24): a bf16 forward on 4 x (512,
     128) against fp32 (argmax within S_MARGIN), its hd-128 flash launches
     on the CUDA cores, and that kernel at the encoder's shape against its
     plain version.
  O. observability, each run in a child process of its own (``--o-child``),
     so env vars, singletons and at-exit dumps stay apart. O1: phase L's
     model, weights and batch (``fused_qkv``, ``fused_bias_gelu``) trains 20
     steps with every observability variable off, then with
     ``SMP_TELEMETRY_PATH``, ``SMP_TIMELINE_PATH``,
     ``SMP_FLIGHT_RECORDER_PATH``, ``SMP_WRITE_STEP_MEMORY_METRICS=1``,
     ``SMP_GOODPUT=1``, ``SMP_PROFILE=steps=10:11`` and
     ``SMP_WATCHDOG_TIMEOUT=300``, then ``smp.shutdown()``. Holds: (a) the
     20 losses bit-equal to the off run's; (b) ``smp_step_total`` 20; (c) the
     peak-memory gauge equal to ``torch.cuda.max_memory_allocated()``; (d)
     the goodput states sum to the ledger's wall time; (e) the
     ``torch.profiler`` trace of steps 10-11 names the six kernels of the
     path as often as their wrappers counted launches there; (f) ``smp_mfu``
     in (0, 1] and the roofline's FLOPs within 2% of
     ``torch.utils.flop_counter``'s count of one plain-path step; (g)
     ``scripts/telemetry_report.py``, ``trace_fuse.py`` and ``perf_ledger.py``
     exit 0 on the dumps. Prints ms/step off and on (steps 2-9), and the
     overhead measured in one process (the off child then runs blocks of 8
     steps with the variables off, on, on, off, each after its own
     ``smp.init``), the goodput fractions and the region split of the
     captured steps (host regions, then device time by kernel). O2: phase S's burst with
     ``SMP_TIMESERIES_INTERVAL=0.5``, ``SMP_TIMESERIES_PATH``, ``SMP_SLO``
     and ``SMP_TELEMETRY_PATH``, and with them off (phase S's burst when it
     ran in the call, else a child of its own): the same tokens, the
     windows' generated-token deltas summing to the tokens served, and
     ``scripts/slo_report.py`` exiting 0 on the JSONL; prints the windows'
     rates and SLO verdicts.
  V. resilience on phase L's model (GPT-2 124M smp.nn, fused, bf16, 8 x
     1024 tokens in 4 microbatches, AdamW, dropout 0, weights from the seed)
     and phase S's burst. V1, the health sentinel: in one process, blocks of
     2 warm-up and 8 timed steps with ``SMP_HEALTH_CHECK`` off, cheap, cheap,
     off (each its own ``smp.init``, model and AdamW from the same weights),
     then 4 steps under full: (a) every block's losses bit-equal to the off
     block's; (b) cheap decodes one step behind, full at once; (c) the tags
     loss, outputs, grads (and params under full), none bad; (d) with
     ``torch.cuda.set_sync_debug_mode("warn")``, no cheap block makes more
     synchronizing calls than an off block; (e) one ``health_reduce`` launch a
     step. Prints ms/step off and cheap, the kernel's time on the last step's
     entries beside the plain version's, and the bytes the bisector keeps.
     V2: after a clean step, layer 5's MLP weight gets a NaN and one step
     runs under cheap; ``smp.shutdown``'s flush trips the sentinel and bisects:
     the ``SMP_HEALTH_PATH`` dump's attribution names microbatch 0 and the
     scanned stack's output (the CPU parity test's path), the telemetry dump
     ``smp_health_fault_total`` 1, the ring its health events; again with a
     NaN input row in microbatch 2 (``input:0/2``). V3: a step that allocates
     twice the free memory: the ``torch.OutOfMemoryError`` reaches the caller,
     the post-mortem names cuda:0's ``bytes_limit`` and the live tensors,
     ``smp_oom_total`` is 1. V4: ``wedge@step=2:ms=500`` puts 500 ms into the
     third step's dispatch region in the timeline (that region less 500 ms
     within 10% of the other steps'; the goodput ledger's ``wedged`` 500 ms); child
     processes (``--v-child``): ``SMP_CHAOS=sigterm@step=3`` (with
     ``SMP_SUPERVISOR=on``) writes the emergency checkpoint at step edge 3 and
     exits 0, a second child resumes it and its losses equal the
     uninterrupted run's calls 3-5 bit for bit; a third child saves when the
     phase touches its ``SMP_PREEMPTION_FILE``; ``resilience_probe.py`` reads
     both checkpoints; phase S's burst under ``SMP_FLEET_INTERVAL=0.5`` and
     ``SMP_METRICS_PORT=0`` gives phase S's tokens, its ``/metrics``,
     ``/metrics.json`` and ``/fleet`` answer 200 during the burst, the fleet
     report's TTFT and ITL percentiles equal ``telemetry_report.py``'s offline
     merge of the rank's dump, and ``corrupt_weights@version=1`` on an
     ``adopt_params`` of the same weights leaves every float leaf at x * 1.01
     + 0.01. Its files go to ``chip_smoke_resilience/`` (removed at the end).
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
     ``threefry_bits`` gives the plain version's bits exactly, at the path's
     mask size, odd sizes, offsets past 2**32 and keys from ``split`` and
     ``fold_in``; the dropout forward and backward give the plain version's
     bits exactly in fp32, bf16 and fp16 at rates 0.1, 0.5 and 0, and under
     the index map of phase N's tp shards (a rank's 6 heads of [2, 12, 1024,
     1024], its T block of [2, 1024, 768]) in fp32 and bf16; ``health_reduce``
     gives the plain version's health word exactly (``_phase_b_health``); the flash kernels run the
     training shape with the seeds phase D's first step derives. Phase M's
     GPT-2 1.5B microbatches (4 and 16 x 1024) have their own cases: flash
     at 25 heads of 64 with dropout 0.1, ``matmul_bias`` at N 4096 and 16384
     (D 1600, F 4800), bias-GELU at [N, 6400], dropout at [N, 1600]; phase
     G's decode step too: ``matmul_bias`` at N 4 and 8 (D 768, F 2304) and
     bias-GELU at [4, 3072] and [8, 3072].
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
     onto the CUDA cores in the same call, with its TFLOP/s. The dropout
     kernels at [2048, 768] bf16 by graph replay: forward, backward, the
     plain versions and ``F.dropout`` (Philox: other bits, the same bytes);
     ``threefry_bits`` at phase A's Gumbel draw; the index-mapped forward at
     a tp rank's T block [2, 512, 768] of [2, 1024, 768] (phase N (h)), with
     ``F.dropout`` on the block. Their bound takes the
     instructions of each kernel's compiled loop (cuobjdump) on its busiest
     pipe (PIPE_LANES). ``matmul_bias`` and ``bias_gelu_fwd`` also at phase
     G's decode shapes (N 4 and 8), with ``torch.addmm`` and ``F.gelu(x +
     b)`` (the kernels line's ``decode_n4``/``decode_n8``), and
     ``matmul_bias`` at the tp = 2 ring's QKV chunk ([1024, 768] x [768,
     1152]) with ``torch.addmm``. ``health_reduce``
     at V1's step (GPT-2 124M's 148 fp32 gradients, the losses and outputs;
     with the parameters under full) by graph replay, beside its plain
     version and the bytes it reads.
  r. (on request, on a machine with two cards) phase R with the ranks on
     cuda:0 and cuda:1, which then talk over NCCL.
  I. (on request, on a machine with two cards) phase N (a) and (g) with the
     tp ranks on cuda:0 and cuda:1 (the tp regions and the ring's hops over
     NCCL) against tp = 1.
  Z. (on request, on a machine with two cards) phase U's steps with the ep
     ranks on cuda:0 and cuda:1 (the all-to-alls over NCCL) against ep = 1.
  t. (on request, on a machine with two cards) phase p's (a) with the
     stages on cuda:0 and cuda:1 (the transfers over NCCL) against pp = 1.
  P. (on request) torch.profiler breakdowns of a generate, phase S's burst, a training step,
     a capacity step (fused and materialized), the smp.nn path's fused,
     unfused, fp8, dropout and checkpointed dropout steps, phase G's smp.nn
     generate (prefill and 32 new tokens) and phase H's ``from_hf`` GPT-2
     step:
     device time by kernel and the device's idle share.
  X. (on request) GPT-2 1.5B at 16 x 1024 with checkpointing off, phase M's
     model and step: its peak, or the allocation that fails.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is absent, the package is missing, or any phase
fails.
"""

import argparse
import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import math
import multiprocessing as mp
import os
import re
import signal
import socket
import subprocess
import sys
import time
import types
from unittest import mock

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, at a 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12, torch.float8_e4m3fn: 1979e12}

# Instruction issue of an H100 SXM, for kernels bound by integer work: 132
# SMs at the 1.98 GHz boost clock of the fp32 peak above (132 x 128 lanes x 2
# x 1.98e9 = 67e12). Results an SM per clock, by pipe (CUDA C Programming
# Guide, throughput of arithmetic instructions, compute capability 9.0): the
# integer ALU (IADD3, LOP3, SHF, ISETP, LEA, SEL, PRMT) 64; IMAD (and its
# IMAD.IADD / IMAD.MOV forms) on the FMA pipe's heavy half, 64; the FMA pipe
# as a whole (IMAD with FFMA, FADD, FMUL) 128; MUFU 16; and any instruction,
# 4 warps x 32 threads = 128 an SM per clock of issue. Counts come from the
# compiled loop of each kernel (``sass_loop_counts``).
H100_SMS = 132
H100_CLOCK_HZ = 67e12 / (H100_SMS * 128 * 2)
PIPE_LANES = {"alu": 64, "imad": 64, "fma": 128, "mufu": 16, "issue": 128}
_ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT")
_FP32_OPS = ("FFMA", "FADD", "FMUL")

KERNEL_SOURCES = ["flash_fwd", "flash_bwd", "fused_ce", "matmul_bias", "bias_gelu", "matmul_fp8", "dropout",
                  "health_reduce"]
DEFAULT_PHASES = "ASGTFLDMQRUWNpJKHEOVBC"
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
        # One cuobjdump a library, all started together, each into a file.
        import tempfile

        outs = {name: tempfile.TemporaryFile(mode="w+") for name in KERNEL_SOURCES}
        procs = {name: subprocess.Popen([cuobjdump, "-sass", str(_build._target(name)[1])], stdout=outs[name],
                                        stderr=subprocess.DEVNULL) for name in KERNEL_SOURCES}
        for name, proc in procs.items():
            proc.wait()
            outs[name].seek(0)
            sass = outs[name].read()
            outs[name].close()
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
    from smdistributed_modelparallel_tpu_torch.ops.dropout import reference_threefry_bits, threefry_bits
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention
    from smdistributed_modelparallel_tpu_torch.utils import random

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

    flash_attention.launches = flash_attention.simt_launches = threefry_bits.launches = 0
    _, prefill_ms = timed(lambda: smp.generate(model, prompts, 1))
    greedy, greedy_ms = timed(lambda: smp.generate(model, prompts, NEW))
    sampled, sampled_ms = timed(lambda: smp.generate(model, prompts, NEW, rng=random.key(SEED), **sample_kw))
    launches = {"flash_fwd": flash_attention.launches, "flash_fwd_simt": flash_attention.simt_launches,
                "threefry_bits": threefry_bits.launches}
    n_prefills = 3

    decode_ms_per_token = (greedy_ms - prefill_ms) / (NEW - 1)
    tokens_per_s = B * NEW / (greedy_ms / 1e3)
    log(f"[A] prefill (generate, 1 new token) {prefill_ms:.2f} ms  B={B} T={T}")
    log(f"[A] greedy generate {NEW} tokens {greedy_ms:.2f} ms; decode {decode_ms_per_token:.3f} ms/token; "
        f"{tokens_per_s:.1f} tokens/s")
    log(f"[A] sampled generate {NEW} tokens {sampled_ms:.2f} ms; decode {(sampled_ms - prefill_ms) / (NEW - 1):.3f} "
        f"ms/token")
    log(f"[A] launches on the main path: {launches} over {n_prefills} prefills of {n_layers} layers")

    if launches["flash_fwd"] < n_layers * n_prefills:
        raise RuntimeError(f"flash_fwd launched {launches['flash_fwd']} times on the tensor cores, expected >= "
                           f"{n_layers * n_prefills}")
    if launches["threefry_bits"] != NEW:  # the Gumbel draw of each sampled token
        raise RuntimeError(f"threefry_bits launched {launches['threefry_bits']} times, expected {NEW}")
    _check_route("serving path", launches)
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        if out.shape != (B, T + NEW):
            raise RuntimeError(f"{name} output shape {tuple(out.shape)}")
        if not torch.equal(out[:, :T], prompts):
            raise RuntimeError(f"{name} output does not start with the prompts")
        if int(out.min()) < 0 or int(out.max()) >= module.vocab_size:
            raise RuntimeError(f"{name} tokens out of range")
    again = smp.generate(model, prompts, NEW, rng=random.key(SEED), **sample_kw)
    if not torch.equal(again, sampled):
        raise RuntimeError("sampled generation is not reproducible from its key")
    # The first token's Gumbel bits over [B, V], kernel against plain version.
    gkey = random.split(random.key(SEED), NEW)[0]
    n = B * module.vocab_size
    gumbel_equal = torch.equal(threefry_bits(gkey, n, device="cuda"), reference_threefry_bits(gkey, n, device="cuda"))
    log(f"[A] sampled tokens repeat with the same key: True; Gumbel bits [{B}, {module.vocab_size}] equal to the "
        f"plain version's: {gumbel_equal}")
    if not gumbel_equal:
        raise RuntimeError("threefry_bits disagrees with its plain version at the Gumbel draw")

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


# Phase S: the serving engine (smp.serving.ServingEngine) on GPT-2 124M.
S_SLOTS, S_BLOCKS = 8, 129            # a quarter of full provisioning (1 + 8 x 64 blocks): the burst's
                                      # first 8 requests reserve 168 blocks, so admission waits
S_REQUESTS, S_SAMPLED = 16, 4
S_PROMPT, S_NEW = (32, 512), (16, 128)
S_SAMPLE_KW = dict(temperature=0.8, top_k=50, top_p=0.95)
S_MARGIN = 5e-2                       # phase A's bf16 bound, of max |logit| of the row


def s_requests(vocab, n=S_REQUESTS, n_sampled=S_SAMPLED, prompt=S_PROMPT, new=S_NEW, seed=SEED, prefix="r"):
    """A burst of ragged requests drawn from ``seed``, ids ``prefix`` + i:
    prompt lengths in ``prompt``, ``max_new_tokens`` in ``new``; every (n //
    n_sampled)-th request is sampled (``S_SAMPLE_KW``, seeds 0, 1, ...), the
    rest greedy."""
    from smdistributed_modelparallel_tpu_torch.serving import ServeRequest

    rng = np.random.default_rng(seed)
    every = n // n_sampled
    reqs = []
    for i in range(n):
        length, max_new = int(rng.integers(prompt[0], prompt[1] + 1)), int(rng.integers(new[0], new[1] + 1))
        ids = [int(t) for t in rng.integers(0, vocab, length)]
        kw = dict(S_SAMPLE_KW, seed=i // every) if i % every == every - 1 else {}
        reqs.append(ServeRequest(f"{prefix}{i}", ids, max_new, **kw))
    return reqs


def s_burst(engine, reqs, sync=None):
    """Submit ``reqs`` at once and tick ``engine.step()`` from outside until
    they finish. Returns the results and what the ticks saw: each stream's
    TTFT and inter-token gaps (its slot's ``t_first_token`` and successive
    ``t_last_token``, on the engine's clock), the wall seconds, the peak pool
    blocks used, the ticks in which admission waited on blocks (a free slot,
    but the next request's worst case does not fit), and the mean ms of the
    decode and prefill programs (``sync`` waits for the card after a prefill
    chunk that samples nothing, which does not wait by itself)."""
    times = {"decode": [], "prefill": []}

    def timed(kind, prog):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = prog(*args, **kw)
            if sync is not None and out is None:
                sync()
            times[kind].append((time.perf_counter() - t0) * 1e3)
            return out

        return call

    saved = {kind: engine._program(kind) for kind in ("decode", "prefill")}
    engine._programs = {kind: timed(kind, prog) for kind, prog in saved.items()}
    slots, last, gaps = {}, {}, []
    peak = waited = ticks = 0
    stats0 = dict(engine.stats)
    try:
        t0 = time.perf_counter()
        for req in reqs:
            engine.submit(req)
        while engine.busy:
            front = engine._queue[0] if engine._queue else None
            if front is not None and None in engine._slots and not engine.alloc.can_reserve(
                    len(front.prompt) + front.max_new_tokens):
                waited += 1
            engine.step()
            ticks += 1
            peak = max(peak, engine.alloc.used_blocks)
            for s in engine._slots:
                if s is not None:
                    slots.setdefault(s.sid, s)
            for rid, s in slots.items():  # at most one new token a slot a tick
                if s.t_last_token is not None and last.get(rid) != s.t_last_token:
                    if rid in last:
                        gaps.append(s.t_last_token - last[rid])
                    last[rid] = s.t_last_token
        wall = time.perf_counter() - t0
    finally:
        engine._programs = saved
    return dict(results={r.request_id: engine.results[r.request_id] for r in reqs}, wall=wall, ticks=ticks,
                peak=peak, waited=waited, stats={k: engine.stats[k] - stats0.get(k, 0) for k in engine.stats},
                ttft=[s.t_first_token - s.t_arrival for s in slots.values()], itl=gaps,
                decode_ms=float(np.mean(times["decode"])), prefill_ms=float(np.mean(times["prefill"])))


def _pct(values, q):
    return float(np.percentile(np.asarray(values) * 1e3, q))


def s_generate(model, req):
    """The port's ``smp.generate`` at batch 1 on ``req`` (its sampling and
    key, as the engine's): the parity oracle and yardstick of a stream."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.utils import random

    kw = {}
    if req.temperature > 0:
        kw = dict(temperature=req.temperature, top_k=req.top_k, top_p=req.top_p, rng=random.key(req.seed))
    out = smp.generate(model, torch.tensor([list(req.prompt)], device=model.device), req.max_new_tokens, **kw)
    return [int(t) for t in out[0, len(req.prompt):].cpu()]


def _s_small_exact():
    """Gate (b): a small fp32 zoo model (std 0.5, phase A's: vocab 97, 2
    layers, d 64, 4 heads), learned and rotary, serves 6 ragged requests on
    the card; the tokens must equal the CPU engine's and the card's
    ``smp.generate``'s, greedy and sampled, token for token."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    smp.init({})
    reqs = s_requests(97, n=6, n_sampled=3, prompt=(5, 60), new=(4, 20), seed=SEED + 1)
    for pos_type in ("learned", "rotary"):
        small = init_gpt2_weights_(gpt2("gpt2_124m", vocab_size=97, max_len=256, d_model=64, n_layers=2, n_heads=4,
                                        pos_type=pos_type), torch.Generator().manual_seed(SEED), std=0.5)
        engine_kw = dict(max_slots=3, num_blocks=25)
        cpu = ServingEngine(small, params=small.state_dict(), device="cpu", **engine_kw).run(reqs)
        gpu_model = smp.DistributedModel(small, device="cuda")
        gpu = ServingEngine(gpu_model, device="cuda", **engine_kw).run(reqs)
        gen = {r.request_id: s_generate(gpu_model, r) for r in reqs}
        equal = all(gpu[r.request_id] == cpu[r.request_id] == gen[r.request_id] for r in reqs)
        log(f"[S] (b) fp32 small model, {pos_type} positions, 6 requests ({sum(r.temperature > 0 for r in reqs)} "
            f"sampled): card engine == CPU engine == card generate, token for token: {equal}")
        if not equal:
            raise RuntimeError(f"(b) the fp32 engine on the card disagrees ({pos_type}): card {gpu}, CPU {cpu}, "
                               f"generate {gen}")


def phase_s():
    """The serving engine through its public entry points: a burst of ragged
    requests on GPT-2 124M, against ``smp.generate`` one request at a time."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.ops.dropout import threefry_bits
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    smp.init({"bf16": True})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    module = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
    model = smp.DistributedModel(module, device="cuda")
    engine = ServingEngine(model, max_slots=S_SLOTS, num_blocks=S_BLOCKS)
    reqs = s_requests(module.vocab_size)
    sampled = [r.request_id for r in reqs if r.temperature > 0]
    pool_mib = engine.kv_block_bytes * S_BLOCKS / 2**20
    log(f"[S] GPT-2 124M bf16, {S_SLOTS} slots, {S_BLOCKS} blocks of {engine.bt} tokens ({pool_mib:.4f} MiB of "
        f"pools, {engine.kv_block_bytes / 2**20:.4f} MiB a block), chunk {engine.chunk}; {len(reqs)} requests at "
        f"once, prompts {min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}, max_new_tokens "
        f"{min(r.max_new_tokens for r in reqs)}-{max(r.max_new_tokens for r in reqs)}, {len(sampled)} sampled")
    # Warm-up (cuBLAS handles, allocator), not counted: two short streams.
    engine.run(s_requests(module.vocab_size, n=2, n_sampled=1, prompt=(40, 40), new=(4, 4), seed=SEED + 2, prefix="warm"))

    flash_attention.launches = flash_attention.simt_launches = threefry_bits.launches = 0
    burst = s_burst(engine, reqs, sync=torch.cuda.synchronize)
    launches = {"flash_fwd": flash_attention.launches, "flash_fwd_simt": flash_attention.simt_launches,
                "threefry_bits": threefry_bits.launches}
    results = burst["results"]
    _S_BF16.update(numbers=_g_burst_numbers(burst, len(reqs)), results=results, pool_mib=pool_mib)  # for phase G
    n_tokens = sum(len(v) for v in results.values())
    sampled_tokens = sum(len(results[r]) for r in sampled)
    log(f"[S] burst: {burst['wall'] * 1e3:.2f} ms, {burst['ticks']} ticks, {n_tokens} tokens generated: "
        f"{n_tokens / burst['wall']:.1f} tokens/s, {len(reqs) / burst['wall']:.3f} requests/s; stats {burst['stats']}")
    log(f"[S] TTFT p50 {_pct(burst['ttft'], 50):.2f} p90 {_pct(burst['ttft'], 90):.2f} p99 {_pct(burst['ttft'], 99):.2f}"
        f" ms; ITL p50 {_pct(burst['itl'], 50):.3f} p99 {_pct(burst['itl'], 99):.3f} ms; decode step "
        f"{burst['decode_ms']:.3f} ms, prefill chunk {burst['prefill_ms']:.3f} ms (means)")
    log(f"[S] pool: peak {burst['peak']} of {S_BLOCKS - 1} blocks used; admission waited on blocks in "
        f"{burst['waited']} ticks")
    # (e) the burst ran the engine's block-gated admission.
    if not burst["waited"]:
        raise RuntimeError(f"admission never waited on blocks with {S_BLOCKS} blocks: the pool is not tight")
    log(f"[S] launches over the burst: {launches}; tokens the {len(sampled)} sampled streams drew: {sampled_tokens}")
    if launches["flash_fwd"] or launches["flash_fwd_simt"]:
        raise RuntimeError(f"the engine launched the flash kernel: {launches}")
    if launches["threefry_bits"] != sampled_tokens:
        raise RuntimeError(f"threefry_bits launched {launches['threefry_bits']} times, expected {sampled_tokens} "
                           "(one Gumbel draw a sampled token)")
    for r in reqs:
        toks = results[r.request_id]
        if len(toks) != r.max_new_tokens or min(toks) < 0 or max(toks) >= module.vocab_size:
            raise RuntimeError(f"{r.request_id}: {len(toks)} tokens (want {r.max_new_tokens}) or out of range")

    # (c) the pool drained.
    log(f"[S] (c) after the burst: {engine.alloc.used_blocks} blocks used, audit {engine.alloc.check()}")
    if engine.alloc.used_blocks or engine.alloc.check():
        raise RuntimeError("the pool did not drain")
    # (d) the sampled streams repeat from their seeds.
    again = engine.run([dataclasses.replace(r, request_id=r.request_id + "_again") for r in reqs
                        if r.request_id in sampled])
    repeat = all(again[rid + "_again"] == results[rid] for rid in sampled)
    log(f"[S] (d) sampled streams repeat from their seeds: {repeat}")
    if not repeat:
        raise RuntimeError("sampled streams are not reproducible from their seeds")

    # The yardstick: the same requests through smp.generate one at a time.
    s_generate(model, reqs[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = {r.request_id: s_generate(model, r) for r in reqs}
    gen_s = time.perf_counter() - t0
    n_gen = sum(len(v) for v in gen.values())
    log(f"[S] yardstick: smp.generate one request at a time (batch 1): {gen_s * 1e3:.2f} ms, {n_gen / gen_s:.1f} "
        f"tokens/s; the engine {n_tokens / burst['wall'] / (n_gen / gen_s):.2f}x")
    greedy = [r for r in reqs if r.temperature == 0]
    same = sum(results[r.request_id] == gen[r.request_id] for r in greedy)
    log(f"[S] greedy streams equal to smp.generate's token for token: {same} of {len(greedy)}; sampled: "
        f"{sum(results[r] == gen[r] for r in sampled)} of {len(sampled)}")

    # (a) every greedy token is within the bf16 margin of its row's maximum,
    # in one teacher-forced forward on the plain attention path.
    worst = 0.0
    with torch.inference_mode():
        bf16_module = copy.deepcopy(module).to(torch.bfloat16)
        os.environ["SMP_DISABLE_PALLAS_ATTN"] = "1"
        try:
            for r in greedy:
                toks = results[r.request_id]
                ids = torch.tensor([list(r.prompt) + toks[:-1]], device="cuda")
                rows = bf16_module(ids)[0, len(r.prompt) - 1:].float()
                picked = rows.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
                gap = (rows.amax(dim=1) - picked) / rows.abs().amax(dim=1)
                worst = max(worst, float(gap.max()))
        finally:
            del os.environ["SMP_DISABLE_PALLAS_ATTN"]
    log(f"[S] (a) greedy tokens against a teacher-forced bf16 forward (plain attention): largest gap to the row's "
        f"maximum {worst:.3e} of max |logit| (limit {S_MARGIN})")
    if worst > S_MARGIN:
        raise RuntimeError("a greedy token of the engine lies outside the bf16 margin of its row's maximum")
    del engine, model, module, bf16_module
    torch.cuda.empty_cache()

    _s_small_exact()
    smp.reset()
    return launches


# Phase G: generation through the smp.nn LM head (padded prompts, beams,
# decode-length buckets, int8 weights) and the int8 serving engine.
G_B, G_PROMPT, G_NEW = 4, (64, 512), 32
G_SAMPLE_KW = dict(temperature=0.8, top_k=50, top_p=0.95)
G_BEAM_B, G_BEAM_T, G_BEAMS, G_RETURN = 2, 128, 4, 2
G_BUCKETS, G_BUCKET_NEW = "seq:64,128,256,512", 20
G_SMALL = dict(num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64, intermediate_size=256,
               vocab_size=97, num_positions=256, causal_mask_size=256, attention_dropout_prob=0.0,
               hidden_dropout_prob=0.0, embedding_dropout_prob=0.0)
G_SMALL_ROTARY = dict(use_positional_embedding=False, rotary_dim=16, gpt_neox_type_rotary=True, pre_layernorm=True,
                      post_layernorm=False, final_layernorm=True)
_S_BF16 = {}  # phase S's bf16 burst (its numbers and tokens), for phase G's int8 burst in the same call


def _timed(fn):
    """(fn(), wall ms) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def _env(**values):
    """Environment variables set (or, None, unset) for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def g_prompts(vocab, n=G_B, lengths=G_PROMPT, seed=SEED, device="cuda"):
    """``n`` prompts of lengths drawn from ``lengths`` by ``seed``, LEFT-padded
    with 0 to the longest: (ids [n, T], mask [n, T] int, the unpadded prompts
    as lists)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lengths[0], lengths[1] + 1, n)
    rows = [[int(t) for t in rng.integers(1, vocab, int(L))] for L in lens]
    T = int(max(lens))
    ids = torch.tensor([[0] * (T - len(r)) + r for r in rows], device=device)
    mask = torch.tensor([[0] * (T - len(r)) + [1] * len(r) for r in rows], device=device)
    return ids, mask, rows


def _g_counters():
    return {**{"flash_fwd": _flash_counters()["flash_fwd"]}, **_new_counters(), **_simt_counters()}


def _g_launches(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _g_margin(forward, rows):
    """Largest gap of a greedy token to its row's maximum, as a share of the
    row's max |logit|, in teacher-forced logits: ``forward(ids [1, L])`` ->
    [L, V] on each unpadded prompt + its tokens."""
    worst = 0.0
    with torch.inference_mode(), _env(SMP_DISABLE_PALLAS_ATTN="1"):
        for prompt, toks in rows:
            ids = torch.tensor([list(prompt) + list(toks[:-1])], device="cuda")
            logits = forward(ids)[len(prompt) - 1:].float()
            picked = logits.gather(1, torch.tensor(list(toks), device="cuda")[:, None])[:, 0]
            worst = max(worst, float(((logits.amax(dim=1) - picked) / logits.abs().amax(dim=1)).max()))
    return worst


def _g_rows(prompts, out, T, new):
    return [(p, [int(t) for t in out[i, T:T + new].tolist()]) for i, p in enumerate(prompts)]


def _g_logprob(module32, prompt, toks, eos):
    """Teacher-forced fp32 log-prob sum of ``toks`` after ``prompt`` (up to
    and including the first EOS)."""
    toks = list(toks)
    if eos is not None and eos in toks:
        toks = toks[:toks.index(eos) + 1]
    ids = torch.tensor([list(prompt) + toks[:-1]], device="cuda")
    with torch.inference_mode():
        lp = torch.log_softmax(module32(ids)[0, len(prompt) - 1:].float(), dim=-1)
    return float(lp.gather(1, torch.tensor(toks, device="cuda")[:, None]).sum())


def _g_engine_margin(model, results, reqs):
    """Gate (a) for the int8 burst: each greedy stream teacher-forced through
    a one-slot paged engine under both knobs (int8 weights dequantized, its
    K/V through the int8 pools, one chunk, the plain attention path)."""
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    yard = ServingEngine(model, max_slots=1, num_blocks=1 + 64)
    mb = yard.max_blocks_per_seq

    def forward(ids):
        L = ids.shape[1]
        yard._init_cache()
        nblk = -(-L // yard.bt)
        table = torch.zeros((1, mb), dtype=torch.long, device="cuda")
        table[0, :nblk] = torch.arange(1, nblk + 1, device="cuda")
        paged = {"block_tables": table, "positions": torch.zeros(1, dtype=torch.long, device="cuda"),
                 "valid": torch.full((1,), L, dtype=torch.long, device="cuda")}
        return yard._run(ids, paged)[0]

    return _g_margin(forward, [(r.prompt, results[r.request_id]) for r in reqs if r.temperature == 0])


def _g_small_exact():
    """Gate (b): small fp32 smp.nn heads (std 0.5, learned and NeoX rotary)
    generate the same tokens on the card as on the CPU with padded prompts,
    beams (with and without EOS), buckets and int8 weights; a padded row
    equals its unpadded prompt alone; the small zoo engine under int8 weights
    gives ``smp.generate``'s tokens under them, and under both int8 knobs the
    CPU engine's."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    smp.init({})
    ids, mask, rows = g_prompts(97, n=3, lengths=(12, 60), seed=SEED + 3, device="cpu")
    T = ids.shape[1]
    failures = []
    for pos, extra in (("learned", {}), ("neox", G_SMALL_ROTARY)):
        small = init_weights_(smp.nn.DistributedTransformerLMHead(**G_SMALL, **extra), 0.5,
                              torch.Generator().manual_seed(SEED))
        cpu = smp.DistributedModel(copy.deepcopy(small), device="cpu")
        gpu = smp.DistributedModel(small, device="cuda")
        eos = int(smp.generate(cpu, ids, 8, attention_mask=mask)[0, T + 2])
        runs = {
            "padded": dict(attention_mask=mask),
            "beams": dict(attention_mask=mask, num_beams=4, num_return_sequences=2),
            "beams_eos": dict(attention_mask=mask, num_beams=4, num_return_sequences=2, eos_token_id=eos,
                              length_penalty=0.6),
        }
        for name, kw in runs.items():
            a, b = smp.generate(gpu, ids.cuda(), 8, **kw).cpu(), smp.generate(cpu, ids, 8, **kw)
            log(f"[G] (b) fp32 small head, {pos}, {name}: card == CPU {torch.equal(a, b)}")
            if not torch.equal(a, b):
                failures.append(f"{pos}/{name}")
        for name, env in (("buckets", dict(SMP_SHAPE_BUCKETS="seq:16,32,64")), ("int8", dict(SMP_DECODE_WEIGHTS="int8"))):
            with _env(**env):
                a, b = smp.generate(gpu, ids.cuda(), 10, attention_mask=mask).cpu(), smp.generate(
                    cpu, ids, 10, attention_mask=mask)
            log(f"[G] (b) fp32 small head, {pos}, {name}: card == CPU {torch.equal(a, b)}")
            if not torch.equal(a, b):
                failures.append(f"{pos}/{name}")
        padded = smp.generate(gpu, ids.cuda(), 8, attention_mask=mask).cpu()
        alone = [smp.generate(gpu, torch.tensor([r], device="cuda"), 8).cpu()[0, len(r):] for r in rows]
        same = all(torch.equal(padded[i, T:], alone[i]) for i in range(len(rows)))
        log(f"[G] (b) fp32 small head, {pos}: each padded row equals its prompt generated alone: {same}")
        if not same:
            failures.append(f"{pos}/padded_row")
    # The small zoo engine: under int8 weights it runs generate's values, so
    # its greedy streams equal smp.generate's under the knob; under both knobs
    # the int8 pools round K and V (generate keeps them exact), so the card's
    # engine is held to the CPU's and its agreement with generate reported.
    zoo = init_gpt2_weights_(gpt2("gpt2_124m", vocab_size=97, max_len=256, d_model=64, n_layers=2, n_heads=4),
                             torch.Generator().manual_seed(SEED), std=0.5)
    cpu_zoo = smp.DistributedModel(copy.deepcopy(zoo), device="cpu")
    gpu_zoo = smp.DistributedModel(zoo, device="cuda")
    reqs = [r for r in s_requests(97, n=6, n_sampled=3, prompt=(5, 60), new=(4, 20), seed=SEED + 1)
            if r.temperature == 0]
    with _env(SMP_DECODE_WEIGHTS="int8"):
        served = ServingEngine(gpu_zoo, max_slots=3, num_blocks=25).run(reqs)
        gen = {r.request_id: s_generate(gpu_zoo, r) for r in reqs}
    same = all(served[r.request_id] == gen[r.request_id] for r in reqs)
    with _env(SMP_DECODE_WEIGHTS="int8", SMP_KV_QUANT="int8"):
        both = ServingEngine(gpu_zoo, max_slots=3, num_blocks=25).run(reqs)
        both_cpu = ServingEngine(cpu_zoo, max_slots=3, num_blocks=25, device="cpu").run(reqs)
    card_cpu = both == both_cpu
    agree = sum(both[r.request_id] == gen[r.request_id] for r in reqs)
    log(f"[G] (b) small zoo engine, {len(reqs)} greedy requests: under SMP_DECODE_WEIGHTS=int8 equal to smp.generate "
        f"under it: {same}; under both int8 knobs card == CPU: {card_cpu}, streams equal to generate's (reported: "
        f"the int8 pools round K and V): {agree} of {len(reqs)}")
    if not same:
        failures.append("zoo_engine_int8_weights")
    if not card_cpu:
        failures.append("zoo_engine_int8_kv")
    if failures:
        raise RuntimeError(f"(b) the card disagrees with the CPU (or the engine with generate): {failures}")


def _g_burst_numbers(burst, n_reqs):
    results = burst["results"]
    n_tokens = sum(len(v) for v in results.values())
    return dict(tokens_per_s=n_tokens / burst["wall"], requests_per_s=n_reqs / burst["wall"], wall_ms=burst["wall"] * 1e3,
                ttft_p50=_pct(burst["ttft"], 50), ttft_p99=_pct(burst["ttft"], 99), itl_p50=_pct(burst["itl"], 50),
                itl_p99=_pct(burst["itl"], 99), decode_ms=burst["decode_ms"], prefill_ms=burst["prefill_ms"])


def _g_fmt(n):
    return (f"{n['tokens_per_s']:.1f} tokens/s, {n['requests_per_s']:.3f} requests/s, TTFT p50 {n['ttft_p50']:.2f} p99 "
            f"{n['ttft_p99']:.2f} ms, ITL p50 {n['itl_p50']:.3f} p99 {n['itl_p99']:.3f} ms, decode step "
            f"{n['decode_ms']:.3f} ms, prefill chunk {n['prefill_ms']:.3f} ms")


def phase_g():
    """Generation through the smp.nn LM head on the card: GPT-2 124M at full
    width, padded prompts (G1), beams (G2), decode-length buckets (G3) and
    int8 weights, then phase S's burst through the engine under both int8
    knobs (G4); gates (a) to (d)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch import quant
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_
    from smdistributed_modelparallel_tpu_torch.nn.utils import half_cast
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine
    from smdistributed_modelparallel_tpu_torch.utils import random

    smp.init({"bf16": True, "fused_qkv": True})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    module = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, fused_bias_gelu=True, device="cuda"),
                           LM_CFG["initializer_range"], g)
    model = smp.DistributedModel(module, device="cuda")
    V = LM_CFG["vocab_size"]
    ids, mask, prompts = g_prompts(V)
    B, T = ids.shape
    n_layers = LM_CFG["num_layers"]
    log(f"[G] smp.nn GPT-2 124M bf16 (fused_qkv, fused_bias_gelu), {B} prompts of {[len(p) for p in prompts]} tokens "
        f"left-padded to {T}, {G_NEW} new tokens")
    smp.generate(model, ids, 2, attention_mask=mask)  # warm-up, not counted
    counters = _g_counters()
    for fn in counters.values():
        fn.launches = 0

    # G1: the padded batch, greedy then sampled.
    _, prefill_ms = _timed(lambda: smp.generate(model, ids, 1, attention_mask=mask))
    greedy, greedy_ms = _timed(lambda: smp.generate(model, ids, G_NEW, attention_mask=mask))
    key = random.key(SEED)
    sampled, sampled_ms = _timed(lambda: smp.generate(model, ids, G_NEW, attention_mask=mask, rng=key, **G_SAMPLE_KW))
    g1 = _g_launches(counters)
    decode_ms = (greedy_ms - prefill_ms) / (G_NEW - 1)
    log(f"[G] G1 prefill (1 new token) {prefill_ms:.2f} ms; greedy {G_NEW} tokens {greedy_ms:.2f} ms: decode "
        f"{decode_ms:.3f} ms/token, {B * G_NEW / greedy_ms * 1e3:.1f} tokens/s; sampled {sampled_ms:.2f} ms "
        f"({(sampled_ms - prefill_ms) / (G_NEW - 1):.3f} ms/token)")
    forwards = 1 + 2 * G_NEW  # forward calls of the three generates
    log(f"[G] G1 launches over 3 prefills and {forwards} forward calls: {g1}")
    want = {"flash_fwd": 3 * n_layers, "matmul_bias": forwards * n_layers, "bias_gelu_fwd": forwards * n_layers}
    if any(g1[k] != n for k, n in want.items()):
        raise RuntimeError(f"G1 launched {g1}, expected {want}")
    again = smp.generate(model, ids, G_NEW, attention_mask=mask, rng=key, **G_SAMPLE_KW)
    repeat_sampled = torch.equal(again, sampled)
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        if out.shape != (B, T + G_NEW) or not torch.equal(out[:, :T], ids) or int(out.min()) < 0 or int(
                out.max()) >= V:
            raise RuntimeError(f"G1 {name} output malformed: {tuple(out.shape)}")

    # G2: beams, without EOS, then with an EOS the beams emit, so that the
    # finished store fills: the most frequent token of the EOS-free beams
    # (with random weights G1's most frequent greedy token need not show in
    # them at all). Each run twice: the repeat gate.
    bids = torch.tensor(np.random.default_rng(SEED + 7).integers(1, V, (G_BEAM_B, G_BEAM_T)), device="cuda")
    beam_kw = dict(num_beams=G_BEAMS, num_return_sequences=G_RETURN, length_penalty=1.0)
    smp.generate(model, bids, 2, **beam_kw)  # warm-up
    for fn in counters.values():
        fn.launches = 0
    beams, beam_ms = _timed(lambda: smp.generate(model, bids, G_NEW, **beam_kw))
    eos = int(torch.bincount(beams[..., G_BEAM_T:].reshape(-1).cpu()).argmax())
    beams_eos, beam_eos_ms = _timed(lambda: smp.generate(model, bids, G_NEW, eos_token_id=eos, **beam_kw))
    g2 = _g_launches(counters)
    repeat_beams = torch.equal(smp.generate(model, bids, G_NEW, **beam_kw), beams)
    repeat_beams = repeat_beams and torch.equal(smp.generate(model, bids, G_NEW, eos_token_id=eos, **beam_kw),
                                                beams_eos)
    finished = int((beams_eos[..., G_BEAM_T:] == eos).any(dim=-1).sum())
    log(f"[G] G2 beams ({G_BEAM_B} prompts of {G_BEAM_T}, {G_BEAMS} beams, {G_RETURN} returned, {G_NEW} new): "
        f"{beam_ms / G_NEW:.3f} ms/token without EOS, {beam_eos_ms / G_NEW:.3f} with EOS {eos} ({finished} of "
        f"{G_BEAM_B * G_RETURN} returned hypotheses end in it); launches {g2}")
    module32 = copy.deepcopy(module)
    bgreedy = smp.generate(model, bids, G_NEW)
    for label, out, e in (("no EOS", beams, None), ("EOS", beams_eos, eos)):
        for b in range(G_BEAM_B):
            p = bids[b].tolist()
            scores = [_g_logprob(module32, p, out[b, r, G_BEAM_T:].tolist(), e) for r in range(G_RETURN)]
            ref = _g_logprob(module32, p, bgreedy[b, G_BEAM_T:].tolist(), None)
            log(f"[G] G2 {label}, prompt {b}: returned beams' fp32 log-prob sums "
                f"{', '.join(f'{s:.4f}' for s in scores)}; greedy {ref:.4f}")
    del module32

    # G3: decode-length buckets on G1's prompts.
    for fn in counters.values():
        fn.launches = 0
    with _env(SMP_SHAPE_BUCKETS=G_BUCKETS):
        smp.generate(model, ids, G_BUCKET_NEW, attention_mask=mask)  # warm-up at the bucketed shapes
        bucketed, bucket_ms = _timed(lambda: smp.generate(model, ids, G_BUCKET_NEW, attention_mask=mask))
    g3 = _g_launches(counters)
    n = min(G_NEW, G_BUCKET_NEW)
    agree = float((bucketed[:, T:T + n] == greedy[:, T:T + n]).float().mean())
    log(f"[G] G3 SMP_SHAPE_BUCKETS={G_BUCKETS!r}, max_new_tokens {G_BUCKET_NEW} (runs 64 steps on prompts left-padded "
        f"to 512): {bucket_ms:.2f} ms a generate (2 of them: {g3}); tokens equal to G1's greedy: {agree:.3f}")

    # G4: G1's greedy under int8 weights.
    for fn in counters.values():
        fn.launches = 0
    with _env(SMP_DECODE_WEIGHTS="int8"):
        int8_out, int8_ms = _timed(lambda: smp.generate(model, ids, G_NEW, attention_mask=mask))
    g4 = _g_launches(counters)
    agree8 = float((int8_out[:, T:] == greedy[:, T:]).float().mean())
    log(f"[G] G4 SMP_DECODE_WEIGHTS=int8 greedy: {int8_ms:.2f} ms (the fake-quant of the weights included); tokens "
        f"equal to bf16's: {agree8:.3f}; launches {g4}")

    # (a) the bf16 margin on G1's, G3's and the int8 greedy tokens.
    bf16_module = copy.deepcopy(module).to(torch.bfloat16)
    margins = {"G1": _g_margin(lambda x: bf16_module(x)[0], _g_rows(prompts, greedy, T, G_NEW)),
               "G3": _g_margin(lambda x: bf16_module(x)[0], _g_rows(prompts, bucketed, T, G_BUCKET_NEW))}
    fq = half_cast(quant.fake_quant_decode_params(module.state_dict(), module), torch.bfloat16)
    bf16_module.load_state_dict(fq)
    margins["G4 int8 weights"] = _g_margin(lambda x: bf16_module(x)[0], _g_rows(prompts, int8_out, T, G_NEW))
    del bf16_module, model, module
    torch.cuda.empty_cache()

    # G4: phase S's burst through the zoo engine under both int8 knobs.
    g = torch.Generator(device="cuda").manual_seed(SEED)
    zoo = smp.DistributedModel(init_gpt2_weights_(gpt2_124m(device="cuda"), g), device="cuda")
    reqs = s_requests(zoo.module.vocab_size)
    warm = s_requests(zoo.module.vocab_size, n=2, n_sampled=1, prompt=(40, 40), new=(4, 4), seed=SEED + 2, prefix="warm")
    if not _S_BF16:  # phase S did not run in this call: its bf16 burst here
        engine = ServingEngine(zoo, max_slots=S_SLOTS, num_blocks=S_BLOCKS)
        engine.run(warm)
        burst = s_burst(engine, reqs, sync=torch.cuda.synchronize)
        _S_BF16.update(numbers=_g_burst_numbers(burst, len(reqs)), results=burst["results"],
                       pool_mib=engine.kv_block_bytes * S_BLOCKS / 2**20)
        del engine
    with _env(SMP_DECODE_WEIGHTS="int8", SMP_KV_QUANT="int8"):
        engine = ServingEngine(zoo, max_slots=S_SLOTS, num_blocks=S_BLOCKS)
        engine.run(warm)
        for fn in counters.values():
            fn.launches = 0
        burst = s_burst(engine, reqs, sync=torch.cuda.synchronize)
        g4_burst = _g_launches(counters)
        numbers = _g_burst_numbers(burst, len(reqs))
        pool_mib = engine.kv_block_bytes * S_BLOCKS / 2**20
        greedy_reqs = [r for r in reqs if r.temperature == 0]
        pairs = [(a, b) for r in greedy_reqs for a, b in zip(burst["results"][r.request_id],
                                                           _S_BF16["results"][r.request_id])]
        agree_burst = sum(a == b for a, b in pairs) / len(pairs)
        streams = sum(burst["results"][r.request_id] == _S_BF16["results"][r.request_id] for r in greedy_reqs)
        del engine
        torch.cuda.empty_cache()
        margins["G4 int8 burst"] = _g_engine_margin(zoo, burst["results"], reqs)
    log(f"[G] G4 burst, {len(reqs)} requests, {S_SLOTS} slots, {S_BLOCKS} blocks, both int8 knobs: {_g_fmt(numbers)}")
    log(f"[G] G4 burst, bf16 (phase S's, this call):                 {_g_fmt(_S_BF16['numbers'])}")
    log(f"[G] G4 pools {pool_mib:.4f} MiB int8 with scales against {_S_BF16['pool_mib']:.4f} MiB bf16; greedy tokens "
        f"equal to the bf16 burst's: {agree_burst:.3f} of {len(pairs)} ({streams} of {len(greedy_reqs)} streams); "
        f"launches over the burst {g4_burst}")
    log(f"[G] (a) largest gap of a greedy token to its row's maximum, of max |logit|: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in margins.items())} (limit {S_MARGIN})")
    if any(v > S_MARGIN for v in margins.values()):
        raise RuntimeError(f"(a) a greedy token lies outside the bf16 margin: {margins}")

    # (c) repeats; (d) no CUDA-core route anywhere in G1-G4.
    log(f"[G] (c) sampled G1 repeats from its key: {repeat_sampled}; beams repeat: {repeat_beams}")
    if not (repeat_sampled and repeat_beams):
        raise RuntimeError("(c) sampled tokens or beams do not repeat from the same inputs")
    total = {k: g1[k] + g2[k] + g3[k] + g4[k] + g4_burst[k] for k in g1}
    _check_route("(d) phase G", total)
    log(f"[G] (d) launches over G1-G4, none on a CUDA-core route: {total}")
    del zoo
    torch.cuda.empty_cache()

    _g_small_exact()
    smp.reset()
    return total


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

    _lm_init(fused, microbatches, bf16, **smp_cfg)
    module = smp.nn.DistributedTransformerLMHead(**cfg, fused_bias_gelu=fused, device="meta")
    module.load_state_dict({k: v.clone() for k, v in init_state.items()}, assign=True)
    return _lm_train(module, device)


def _lm_init(fused, microbatches=TRAIN_MB, bf16=True, **smp_cfg):
    """``smp.init`` of the smp.nn path."""
    import smdistributed_modelparallel_tpu_torch as smp

    smp.init({"microbatches": microbatches, "bf16": bf16, "fused_qkv": fused, **smp_cfg})


def _lm_train(module, device):
    """``module`` as a ``DistributedModel`` on ``device``, its AdamW and the
    smp.nn training step; ``smp.init`` has run."""
    import smdistributed_modelparallel_tpu_torch as smp

    model = smp.DistributedModel(module, device=device)
    return (model, *_lm_optimizer_step(model))


def _lm_optimizer_step(model):
    """AdamW (optax.adamw's defaults) over ``model`` and the smp.nn
    training step."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn import vocab_parallel_cross_entropy

    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids):
        logits = model(ids)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    return optimizer, train_step


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


# Phase L's model with GPT-2's published dropouts (attn_pdrop, resid_pdrop,
# embd_pdrop = 0.1), which config_to_smp maps onto these three keys.
LM_DROP_CFG = dict(LM_CFG, attention_dropout_prob=0.1, hidden_dropout_prob=0.1, embedding_dropout_prob=0.1)
# Dropout sites a microbatch: the embedding's, and each layer's attention
# output and MLP output (the attention probabilities' dropout is the flash
# kernels' hash).
DROP_SITES = 1 + 2 * LM_CFG["num_layers"]
# The kept share of a mask of 2048 x 768 = 1.57M draws of p = 0.9: its
# standard deviation is sqrt(0.9 * 0.1 / 1.57M) = 2.4e-4, so 0.002 is ~8 of
# them.
DROP_KEPT_TOL = 0.002
D_SEEDS = (11, 11, 12)  # tensor_parallel_seed of the three 3-step repeat runs


def _dropout_counters():
    from smdistributed_modelparallel_tpu_torch.ops.dropout import dropout_bwd, dropout_fwd, threefry_bits

    return {"dropout_fwd": dropout_fwd, "dropout_bwd": dropout_bwd, "threefry_bits": threefry_bits}


class _ShardCounter:
    """A dropout wrapper's launches under an index map of several runs (a tp
    shard's part of a mask; ``.shard_launches``), read and set as
    ``.launches`` like the other counters."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.shard_launches

    @launches.setter
    def launches(self, n):
        self.fn.shard_launches = n


def _shard_counters():
    from smdistributed_modelparallel_tpu_torch.ops.dropout import dropout_fwd, threefry_bits

    return {"dropout_fwd_index_map": _ShardCounter(dropout_fwd),
            "threefry_bits_index_map": _ShardCounter(threefry_bits)}


def _d_short_run(init_state, ids, seed):
    """Losses of 3 steps of the dropout model from ``init_state`` under
    ``tensor_parallel_seed`` = ``seed``."""
    model, optimizer, train_step = _lm_setup(init_state, True, "cuda", LM_DROP_CFG, tensor_parallel_seed=seed)
    losses = []
    for _ in range(3):
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
    del model, optimizer, train_step
    return losses


def _d_small_card_vs_cpu():
    """One step of a small fp32 model with all three dropouts, on the card
    and on the CPU from the same weights and seed: (loss, grads, dropout
    launches) by device."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    cfg = dict(LM_DROP_CFG, num_layers=2, num_attention_heads=4, attention_head_size=32, hidden_size=128,
               intermediate_size=512, vocab_size=97, num_positions=64, causal_mask_size=64)
    state = init_weights_(smp.nn.DistributedTransformerLMHead(**cfg), 0.02, torch.Generator().manual_seed(SEED))
    state = state.state_dict()
    ids = torch.randint(0, 97, (4, 64), generator=torch.Generator().manual_seed(SEED))
    counters = _dropout_counters()
    runs = {}
    for device in ("cuda", "cpu"):
        model, _, train_step = _lm_setup(state, False, device, cfg, microbatches=2, bf16=False)
        for c in counters.values():
            c.launches = 0
        loss = float(train_step(model, ids).reduce_mean())
        runs[device] = (loss, {k: g.detach().float().cpu() for k, g in model.grads.items()},
                        {k: c.launches for k, c in counters.items()})
    return runs


def _d_host_split(run, ids, drop_ms, plain_ms, n=3):
    """Where the dropout step's extra host time goes: ``n`` more steps of
    the dropout run with a wall-clock timer around each host-side function
    the dropout path adds (the scope keys, the attention seeds, the step's
    key schedule, the dropout op's forward and backward and their ctypes
    launches), in ms a step, against the gap between the dropout and
    dropout-0 steps measured in the timed blocks. The forward and backward
    include their launches; the rest do not nest."""
    from smdistributed_modelparallel_tpu_torch import model as model_mod
    from smdistributed_modelparallel_tpu_torch.ops import dropout as dr
    from smdistributed_modelparallel_tpu_torch.utils import random

    targets = {"scope keys (DistributedModel.make_rng)": (model_mod.DistributedModel, "make_rng"),
               "attention seeds (utils.random.bits32)": (random, "bits32"),
               "step key schedule (utils.random.split)": (random, "split"),
               "dropout forward (ops.dropout.dropout, with its launch)": (dr, "dropout"),
               "dropout backward (ops.dropout._DropoutFn.backward, with its launch)": (dr._DropoutFn, "backward"),
               "ctypes launches (ops.dropout._launch)": (dr, "_launch")}
    secs = dict.fromkeys(targets, 0.0)
    calls = dict.fromkeys(targets, 0)

    def timer(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                secs[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapped

    with contextlib.ExitStack() as stack:
        for name, (owner, attr) in targets.items():
            fn = timer(name, getattr(owner, attr))  # autograd reads a Function's backward at each call
            stack.enter_context(mock.patch.object(owner, attr, staticmethod(fn) if attr == "backward" else fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run["step"](run["model"], ids)
            run["optimizer"].step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    split = {name: secs[name] * 1e3 / n for name in targets}
    log(f"[D] host split of the dropout step ({n} steps with timers, {wall_ms:.2f} ms/step; the timed blocks' gap "
        f"{drop_ms - plain_ms:.2f} ms/step):")
    for name in targets:
        log(f"[D]   {name}: {split[name]:.3f} ms/step, {calls[name] // n} calls a step")
    return dict(wall_ms=wall_ms, gap_ms=drop_ms - plain_ms, ms=split, calls={k: v // n for k, v in calls.items()})


def phase_d():
    """The smp.nn path with GPT-2's dropouts: phase L's model and step with
    attention, hidden and embedding dropout 0.1, against the dropout-0 step
    from the same weights in interleaved blocks; launches by route, kept
    shares, repeats, and a small fp32 model on the card and on the CPU."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_
    from smdistributed_modelparallel_tpu_torch.ops import dropout as dr

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")

    # Both models in one session (one step key stream, as two models in one
    # JAX session share it), each with its AdamW.
    _lm_init(True)
    runs = {}
    for label, cfg in (("dropout 0.1", LM_DROP_CFG), ("dropout 0", LM_CFG)):
        module = smp.nn.DistributedTransformerLMHead(**cfg, fused_bias_gelu=True, device="meta")
        module.load_state_dict({k: v.clone() for k, v in init_state.items()}, assign=True)
        model, optimizer, train_step = _lm_train(module, "cuda")
        runs[label] = dict(model=model, optimizer=optimizer, step=train_step, losses=[], block_ms=[], launches={})
    counters = {**_flash_counters(), **_new_counters(), **_dropout_counters(), **_simt_counters()}

    def steps(label, n, timed):
        run = runs[label]
        if timed:
            for c in counters.values():
                c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run["losses"].append(run["step"](run["model"], ids).reduce_mean())
            run["optimizer"].step()
        torch.cuda.synchronize()
        if timed:
            run["block_ms"].append((time.perf_counter() - t0) * 1e3 / n)
            for k, c in counters.items():
                run["launches"][k] = run["launches"].get(k, 0) + c.launches

    for label in runs:
        steps(label, TRAIN_WARMUP, False)
    for label in ("dropout 0.1", "dropout 0", "dropout 0", "dropout 0.1"):  # A B B A
        steps(label, TRAIN_STEPS // 2, True)
    out = {}
    for label, run in runs.items():
        ms = sum(run["block_ms"]) / len(run["block_ms"])
        run["losses"] = [float(x) for x in run["losses"]]
        out[label] = dict(ms=ms, block_ms=run["block_ms"], tokens_per_s=ids.numel() / ms * 1e3,
                          losses=run["losses"], launches=run["launches"])
        log(f"[D] smp.nn GPT-2 124M bf16 training, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} "
            f"microbatches, fused knobs, {label}: {ms:.2f} ms/step (blocks {', '.join(f'{b:.2f}' for b in run['block_ms'])}),"
            f" {out[label]['tokens_per_s']:.1f} tokens/s (mean of {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
            f"blocks A B B A)")
        log(f"[D]   losses {run['losses']}")
        log(f"[D]   launches over {TRAIN_STEPS} steps: {run['launches']}")

    per_step = LM_CFG["num_layers"] * TRAIN_MB
    want = {**{k: per_step * TRAIN_STEPS for k in {**_flash_counters(), **_new_counters()}},
            "dropout_fwd": DROP_SITES * TRAIN_MB * TRAIN_STEPS, "dropout_bwd": DROP_SITES * TRAIN_MB * TRAIN_STEPS,
            "threefry_bits": 0, **{k: 0 for k in _simt_counters()}}
    got = {k: runs["dropout 0.1"]["launches"][k] for k in want}
    if got != want:
        raise RuntimeError(f"dropout path launches {got}, expected {want}")
    if any(runs["dropout 0"]["launches"][k] for k in _dropout_counters()):
        raise RuntimeError(f"the dropout-0 run launched dropout kernels: {runs['dropout 0']['launches']}")
    losses = runs["dropout 0.1"]["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"dropout training loss did not fall or is not finite: {losses}")

    # The kept share of the first microbatch's embedding mask and its first
    # hidden mask (layer 0's attention output): one more step records the
    # first two sites' inputs and keys, then their masks are drawn again.
    drawn = []
    real = dr.dropout

    def spy(x, rate, key):
        if len(drawn) < 2:
            drawn.append((x.detach(), rate, key))
        return real(x, rate, key)

    run = runs["dropout 0.1"]
    with mock.patch.object(dr, "dropout", spy):
        run["step"](run["model"], ids)
    masks = [dr.dropout_fwd(*args)[1] for args in drawn]
    kept = {name: float(mask.float().mean()) for name, mask in zip(("embedding", "layer 0 attention output"), masks)}
    log(f"[D] kept share of one mask of {masks[0].numel()} draws: " +
        ", ".join(f"{k} {v:.5f}" for k, v in kept.items()) + f" (0.9 +- {DROP_KEPT_TOL})")
    if any(abs(v - 0.9) > DROP_KEPT_TOL for v in kept.values()):
        raise RuntimeError(f"kept shares {kept} outside 0.9 +- {DROP_KEPT_TOL}")
    host = _d_host_split(run, ids, out["dropout 0.1"]["ms"], out["dropout 0"]["ms"])
    launches = runs["dropout 0.1"]["launches"]
    del runs, run
    torch.cuda.empty_cache()

    # The same weights and seed give the same losses; another seed others.
    repeats = [_d_short_run(init_state, ids, s) for s in D_SEEDS]
    log(f"[D] 3 steps from the same weights, tensor_parallel_seed {D_SEEDS[0]} twice then {D_SEEDS[2]}: {repeats}")
    if repeats[0] != repeats[1] or repeats[0][0] == repeats[2][0]:
        raise RuntimeError("the dropout run is not reproducible from its seed, or ignores it")

    small = _d_small_card_vs_cpu()
    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, n_cpu) = small["cuda"], small["cpu"]
    loss_ok = abs(l_gpu - l_cpu) <= 2e-5 + 2e-4 * abs(l_cpu)
    grad_err = max(float(((g_gpu[k] - v).abs() / (2e-4 + 2e-3 * v.abs())).max()) for k, v in g_cpu.items())
    want_small = 2 * (1 + 3 * 2)  # 2 microbatches x (the embedding + 2 layers x 3 sites), each way
    log(f"[D] fp32 small smp.nn model (d 128, 2 layers, seq 64), all three dropouts 0.1, one step, card (launches "
        f"{n_gpu}) vs CPU: loss {l_gpu!r} vs {l_cpu!r}; gradients' largest |diff| / (atol + rtol |grad|) "
        f"{grad_err:.3f} (limit 1; rtol 2e-3, atol 2e-4)")
    if not loss_ok or grad_err > 1 or n_gpu != {"dropout_fwd": want_small, "dropout_bwd": want_small,
                                                "threefry_bits": 0}:
        raise RuntimeError("the card's fp32 dropout step disagrees with the CPU's")
    smp.reset()
    out.update(kept=kept, repeats=repeats, small=(l_gpu, l_cpu, grad_err), host=host)
    return launches, out


# Phase M: activation checkpointing. The modes a run compares: no
# checkpointing, and the checkpointed stack under each recompute policy and
# under offload_activations.
M_MODES = ("off", "full", "stash_weight", "stash_all", "offload")
# Gradients of two modes from the same weights and keys: the recompute runs
# the same kernels on the same inputs, so they should agree bit for bit; the
# gate allows 1e-6 of each tensor's largest value.
M_GRAD_TOL = 1e-6
M_BLOCK_WARMUP, M_BLOCK_STEPS = 2, 2  # each timed block: fresh model, warm-up steps, timed steps
# GPT-2 1.5B (GPT-2 XL's published widths and dropouts; the JAX package's
# models/gpt2.py gpt2_1p5b) as smp.nn.DistributedTransformerLMHead.
XL_CFG = dict(LM_DROP_CFG, num_layers=48, num_attention_heads=25, hidden_size=1600, intermediate_size=6400)
XL_GRADS = [f"transformer.seq_layers.{i}.{m}.{p}" for i in (0, 47) for m in ("attention.qkv", "output.fc")
            for p in ("weight", "bias")]
XL_SMALL_BATCH, XL_BATCH = 4, 16  # x 1024 tokens, one microbatch
XL_DROP_SITES = 1 + 2 * XL_CFG["num_layers"]
XL_WARMUP, XL_STEPS = 1, 3


def _m_smp_cfg(mode):
    """The ``smp.init`` keys of a mode."""
    if mode == "offload":
        return {"offload_activations": True}
    return {} if mode == "off" else {"recompute": mode}


def _m_counters():
    return {**_flash_counters(), **_new_counters(), **_dropout_counters(), **_simt_counters()}


def _m_want(layers, microbatches, dropout_sites, mode):
    """Launches a step of the smp.nn path with dropout: each forward kernel
    once a layer and microbatch, twice when the layer is recomputed."""
    fwd = layers * microbatches * (1 if mode in ("off", "stash_all") else 2)
    bwd = layers * microbatches
    return {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd, "matmul_bias": fwd,
            "bias_gelu_fwd": fwd, "bias_gelu_bwd": bwd,
            "dropout_fwd": microbatches + 2 * fwd, "dropout_bwd": microbatches * dropout_sites,
            "threefry_bits": 0, **{k: 0 for k in _simt_counters()}}


def _m_grad_err(got, want):
    """{name: max |got - want| / max |want|} over every gradient."""
    return {n: float((got[n].cuda() - w.cuda()).abs().max() / w.cuda().abs().max()) for n, w in want.items()}


def _m_check_grads(label, got, want, layer_prefix="transformer.seq_layers."):
    """Raise unless every gradient agrees within M_GRAD_TOL and every layer
    parameter has one; returns (largest error, bit-equal)."""
    err = _m_grad_err(got, want)
    missing = [n for n, g in got.items() if n.startswith(layer_prefix) and not float(g.abs().max()) > 0]
    worst = max(err, key=err.get)
    equal = all(e == 0.0 for e in err.values())
    log(f"[M] {label}: step-1 gradients of {len(err)} tensors, largest max |d| / max |grad| {err[worst]:.3e} "
        f"({worst}; limit {M_GRAD_TOL:.0e}); bit for bit: {equal}; layer parameters without a gradient: "
        f"{len(missing)}")
    if err[worst] > M_GRAD_TOL or missing or set(got) != set(want):
        raise RuntimeError(f"{label}: gradients disagree or are missing ({missing[:4]})")
    return err[worst], equal


def _m_step(model, optimizer, train_step, ids):
    """One step, timed and measured: (loss, ms, the resident bytes before it,
    the peak during ``train_step``, the peak during ``optimizer.step``, the
    bytes allocated when a microbatch's forward ends: at its
    ``model.backward(loss)``, the most over the microbatches)."""
    from smdistributed_modelparallel_tpu_torch.model import DistributedModel

    marks = []
    real_backward = DistributedModel.backward

    def backward(self, loss, num_tokens=None):
        marks.append(torch.cuda.memory_allocated())
        return real_backward(self, loss, num_tokens)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(DistributedModel, "backward", backward):
        loss = train_step(model, ids).reduce_mean()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    optimizer.step()
    torch.cuda.synchronize()
    return (loss, (time.perf_counter() - t0) * 1e3, resident, step_peak, torch.cuda.max_memory_allocated(),
            max(marks))


def _m_memory(steps):
    """Memory in GiB over ``_m_step`` results: the whole step's peak, the
    ``train_step`` part's and the optimizer's, and what a microbatch's
    forward leaves allocated above the resident bytes (the step's half
    casts, the activations its graph keeps, its logits)."""
    gib = 2 ** 30
    step_peak = max(r[3] for r in steps) / gib
    opt_peak = max(r[4] for r in steps) / gib
    return dict(peak_gib=max(step_peak, opt_peak), step_peak_gib=step_peak, opt_peak_gib=opt_peak,
                forward_gib=max(r[5] - r[2] for r in steps) / gib, resident_gib=max(r[2] for r in steps) / gib)


def _m_block(init_state, ids, mode, cfg=LM_DROP_CFG, smp_cfg=None):
    """A fresh ``smp.init`` and model in ``mode`` from ``init_state``:
    step 1's gradients, then M_BLOCK_WARMUP - 1 more warm-up steps and
    M_BLOCK_STEPS timed steps (``_m_step``) whose launches are counted from
    0."""
    model, optimizer, train_step = _lm_setup(init_state, True, "cuda", dict(cfg, activation_checkpointing=mode != "off"),
                                             **_m_smp_cfg(mode), **(smp_cfg or {}))
    losses = [float(train_step(model, ids).reduce_mean())]
    grads = {n: g.detach().to("cpu") for n, g in model.grads.items()}  # on the host: later blocks' memory
    optimizer.step()
    for _ in range(M_BLOCK_WARMUP - 1):
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
    counters = _m_counters()
    for c in counters.values():
        c.launches = 0
    steps = [_m_step(model, optimizer, train_step, ids) for _ in range(M_BLOCK_STEPS)]
    out = dict(ms=sum(r[1] for r in steps) / M_BLOCK_STEPS, losses=losses + [float(r[0]) for r in steps],
               grads=grads, launches={k: c.launches for k, c in counters.items()}, **_m_memory(steps))
    del model, optimizer, train_step
    torch.cuda.empty_cache()
    return out


def _m_host_split(init_state, ids, n=3):
    """Where the checkpointed step's extra host time goes: ``n`` steps of
    phase M's 124M model (dropout 0.1) off and under full, with wall-clock
    timers around the layers' forward (``DistributedTransformerLayer.forward``:
    in the regions and again in their recomputes), the checkpointed regions'
    forward (``memory.run_checkpointed``, with the layer), the recomputes
    (``memory._Replay.recompute``'s block, with the layer) and the
    backward (``torch.autograd.grad``, with the recomputes). In ms a step."""
    from smdistributed_modelparallel_tpu_torch.nn import transformer as tr
    from smdistributed_modelparallel_tpu_torch.parallel import memory

    secs, calls = {}, {}

    def timer(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
                calls[name] = calls.get(name, 0) + 1
        return wrapped

    real_recompute = memory._Replay.recompute

    @contextlib.contextmanager
    def timed_recompute(self):
        t0 = time.perf_counter()
        try:
            with real_recompute(self):
                yield
        finally:  # torch stops a recompute early by raising out of it
            secs["recomputes"] = secs.get("recomputes", 0.0) + time.perf_counter() - t0
            calls["recomputes"] = calls.get("recomputes", 0) + 1

    out = {}
    for mode in ("off", "full"):
        model, optimizer, train_step = _lm_setup(init_state, True, "cuda",
                                                 dict(LM_DROP_CFG, activation_checkpointing=mode != "off"),
                                                 **_m_smp_cfg(mode))
        for _ in range(M_BLOCK_WARMUP):
            train_step(model, ids)
            optimizer.step()
        secs.clear()
        calls.clear()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(tr.DistributedTransformerLayer, "forward",
                                                  timer("layers' forward", tr.DistributedTransformerLayer.forward)))
            stack.enter_context(mock.patch.object(memory, "run_checkpointed",
                                                  timer("regions' forward", memory.run_checkpointed)))
            stack.enter_context(mock.patch.object(memory._Replay, "recompute", timed_recompute))
            stack.enter_context(mock.patch.object(torch.autograd, "grad", timer("backward", torch.autograd.grad)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                train_step(model, ids)
                optimizer.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        out[mode] = dict(wall_ms=wall, ms={k: v * 1e3 / n for k, v in secs.items()},
                          calls={k: v // n for k, v in calls.items()})
        log(f"[M] host split, 124M dropout 0.1, {mode}: {wall:.2f} ms/step with timers; "
            + ", ".join(f"{k} {v * 1e3 / n:.2f} ms ({calls[k] // n} calls)" for k, v in secs.items()))
        del model, optimizer, train_step
        torch.cuda.empty_cache()
    return out


def _xl_run(mode, batch, steps, keep_grads=False):
    """GPT-2 1.5B in ``mode`` from the seed's weights, ``steps`` AdamW
    steps on a ``batch`` x 1024 microbatch: losses, the ms and memory of the
    steps after the first (``_m_step``), step 1's gradients on the host
    (``keep_grads``), the offloaded bytes a step and the launches, which
    must be ``_m_want``'s every step, none on a CUDA-core route."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_
    from smdistributed_modelparallel_tpu_torch.parallel import memory

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    _lm_init(True, microbatches=1, **_m_smp_cfg(mode))
    module = smp.nn.DistributedTransformerLMHead(**XL_CFG, fused_bias_gelu=True, activation_checkpointing=mode != "off",
                                                 device="cuda")
    init_weights_(module, XL_CFG["initializer_range"], g)
    ids = torch.randint(0, XL_CFG["vocab_size"], (batch, TRAIN_SEQ), generator=g, device="cuda")
    model, optimizer, train_step = _lm_train(module, "cuda")
    del module
    counters = _m_counters()
    for c in counters.values():
        c.launches = 0
    losses = [float(train_step(model, ids).reduce_mean())]
    grads = {n: t.detach().to("cpu") for n, t in model.grads.items()} if keep_grads else None
    optimizer.step()
    moved = memory.offload_stats["to_host"]
    timed = [_m_step(model, optimizer, train_step, ids) for _ in range(steps - 1)]
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: n * steps for k, n in _m_want(XL_CFG["num_layers"], 1, XL_DROP_SITES, mode).items()}
    log(f"[M]   1.5B {mode}, {batch} x {TRAIN_SEQ}: launches in {steps} steps {launches}")
    _check_route(f"1.5B {mode}", launches)
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"1.5B {mode}: launches in {steps} steps {launches}, expected {want}")
    out = dict(losses=losses + [float(r[0]) for r in timed], ms=[r[1] for r in timed], grads=grads,
               offloaded_per_step=(memory.offload_stats["to_host"] - moved) / (steps - 1),
               launches=launches, **_m_memory(timed))
    del model, optimizer, train_step
    torch.cuda.empty_cache()
    return out


def _m_mem_text(run):
    return (f"peak {run['peak_gib']:.2f} GiB (train_step {run['step_peak_gib']:.2f}, optimizer.step "
            f"{run['opt_peak_gib']:.2f}; resident {run['resident_gib']:.2f}, a microbatch's forward leaves "
            f"{run['forward_gib']:.3f} above it)")


def phase_m():
    """Activation checkpointing: (a) phase L's model with GPT-2's dropouts
    in every mode (gradients, launches, fp8 state, time, memory and a host
    split); (b) GPT-2 1.5B at 4 x 1024 (off, stash_all, full) and 16 x 1024
    (full, offload) in one microbatch."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    n_layers = LM_CFG["num_layers"]
    launches_total = {}

    def add(launches):
        for k, n in launches.items():
            launches_total[k] = launches_total.get(k, 0) + n

    # (a) Dropout 0: off against full.
    plain = {mode: _m_block(init_state, ids, mode, LM_CFG) for mode in ("off", "full")}
    for run in plain.values():
        add(run["launches"])
    out = {"dropout0": _m_check_grads("124M dropout 0, full against off", plain["full"]["grads"],
                                      plain["off"]["grads"])}
    del plain

    # Dropout 0.1, every mode, in blocks A B C D E E D C B A; each block
    # starts from the same weights, so its step 1 gives comparable gradients.
    runs = {mode: [] for mode in M_MODES}
    for mode in (*M_MODES, *reversed(M_MODES)):
        runs[mode].append(_m_block(init_state, ids, mode))
    step1 = {mode: blocks[0].pop("grads") for mode, blocks in runs.items()}
    for blocks in runs.values():
        blocks[1].pop("grads")
    for mode in ("stash_all", "stash_weight", "offload", "off"):
        out[f"dropout0.1 {mode}"] = _m_check_grads(f"124M dropout 0.1, {mode} against full", step1[mode],
                                                   step1["full"])
    del step1
    timing = {}
    for mode, blocks in runs.items():
        ms = sum(b["ms"] for b in blocks) / len(blocks)
        timing[mode] = dict(ms=ms, block_ms=[b["ms"] for b in blocks], tokens_per_s=ids.numel() / ms * 1e3,
                            losses=blocks[0]["losses"],
                            **{k: max(b[k] for b in blocks) for k in ("peak_gib", "step_peak_gib", "opt_peak_gib",
                                                                      "forward_gib", "resident_gib")})
        per_step = {k: sum(b["launches"][k] for b in blocks) // (len(blocks) * M_BLOCK_STEPS)
                    for k in blocks[0]["launches"]}
        want = _m_want(n_layers, TRAIN_MB, DROP_SITES, mode)
        log(f"[M] smp.nn GPT-2 124M bf16, dropout 0.1, batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches, "
            f"{mode}: {ms:.2f} ms/step (blocks {', '.join(f'{b:.2f}' for b in timing[mode]['block_ms'])}), "
            f"{timing[mode]['tokens_per_s']:.1f} tokens/s, {_m_mem_text(timing[mode])} ({M_BLOCK_STEPS} timed steps "
            f"a block after {M_BLOCK_WARMUP} warm-up, each ending in a synchronize)")
        log(f"[M]   launches a step: {per_step}")
        if {k: per_step[k] for k in want} != want:
            raise RuntimeError(f"{mode}: launches a step {per_step}, expected {want}")
        losses = blocks[0]["losses"]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"{mode}: loss did not fall or is not finite: {losses}")
        for b in blocks:
            add(b["launches"])
    out["timing"] = timing
    del runs
    out["host"] = _m_host_split(init_state, ids)

    # fp8: one step with checkpointing on and off; the finalized quant state.
    quant = {}
    for mode in ("off", "full"):
        model, optimizer, train_step = _lm_setup(init_state, True, "cuda",
                                                 dict(LM_DROP_CFG, activation_checkpointing=mode != "off"),
                                                 matmul_precision="fp8", **_m_smp_cfg(mode))
        train_step(model, ids)
        quant[mode] = smp.state.quant_state.state_dict()
        del model, optimizer, train_step
    q_err = max(float(np.abs(quant["full"][k] - quant["off"][k]).max()) for k in ("amax_history", "scale"))
    log(f"[M] fp8 step, full against off: finalized quant state max |diff| {q_err:.3e} (limit 1e-6); "
        f"observed slots {int((quant['full']['amax_history'][:, 0] > 0).sum())}")
    if q_err > 1e-6 or not (quant["off"]["amax_history"][:, 0] > 0).any():
        raise RuntimeError("the fp8 quant state differs with checkpointing")
    out["fp8_state_err"] = q_err
    torch.cuda.empty_cache()

    # (b) GPT-2 1.5B. 4 x 1024: off, stash_all and full, 3 AdamW steps each;
    # step 1's gradients, steps 2-3's time and memory (AdamW's state lives).
    xl = {}
    ref = None
    for mode in ("off", "stash_all", "full"):
        run = xl[mode] = _xl_run(mode, XL_SMALL_BATCH, 3, keep_grads=True)
        add(run["launches"])
        log(f"[M] GPT-2 1.5B bf16, dropout 0.1, {XL_SMALL_BATCH} x {TRAIN_SEQ} in one microbatch, {mode}: steps 2-3 "
            f"{', '.join(f'{t:.2f}' for t in run['ms'])} ms, {_m_mem_text(run)}; losses {run['losses']}")
        if ref is None:
            ref = run.pop("grads")
        else:
            grads = run.pop("grads")
            out[f"xl {mode}"] = _m_check_grads(f"1.5B {mode} against off", grads, ref)
            del grads
    del ref
    # 16 x 1024 under full, then under offload: 1 warm-up and 3 timed steps.
    for mode in ("full", "offload"):
        run = xl[f"{mode} 16k"] = _xl_run(mode, XL_BATCH, XL_WARMUP + XL_STEPS)
        add(run["launches"])
        ms = sum(run["ms"]) / XL_STEPS
        run.update(step_ms=ms, tokens_per_s=XL_BATCH * TRAIN_SEQ / ms * 1e3)
        log(f"[M] GPT-2 1.5B bf16, dropout 0.1, {XL_BATCH} x {TRAIN_SEQ} in one microbatch, {mode}: {ms:.2f} ms/step "
            f"(steps {', '.join(f'{t:.2f}' for t in run['ms'])} after {XL_WARMUP} warm-up), "
            f"{run['tokens_per_s']:.1f} tokens/s, {_m_mem_text(run)}, layer inputs sent to host "
            f"{run['offloaded_per_step'] / 2**30:.3f} GiB a step; losses {run['losses']}")
        losses = run["losses"]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"1.5B {mode}: loss did not fall or is not finite: {losses}")
    full, off16 = xl["full 16k"], xl["offload 16k"]
    inputs = XL_CFG["num_layers"] * XL_BATCH * TRAIN_SEQ * XL_CFG["hidden_size"] * 2
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(off16["losses"], full["losses"]))
    saved = full["forward_gib"] - off16["forward_gib"]
    log(f"[M] offload against full at {XL_BATCH} x {TRAIN_SEQ}: the forward leaves {off16['forward_gib']:.3f} against "
        f"{full['forward_gib']:.3f} GiB above the resident bytes ({saved:.3f} GiB less; the {XL_CFG['num_layers']} layer "
        f"inputs are {inputs / 2**30:.3f} GiB); whole-step peak {off16['peak_gib']:.2f} against {full['peak_gib']:.2f} "
        f"GiB (train_step {off16['step_peak_gib']:.2f} against {full['step_peak_gib']:.2f}); losses max rel diff "
        f"{loss_rel:.3e} (limit 1e-5)")
    if not off16["offloaded_per_step"] >= inputs or saved < 0.9 * inputs / 2**30 or loss_rel > 1e-5:
        raise RuntimeError("offload did not move the layer inputs off the device, or changed the losses")
    if not (off16["peak_gib"] < full["peak_gib"] and off16["step_peak_gib"] < full["step_peak_gib"]):
        raise RuntimeError("offload did not lower the device's peak")
    if not full["peak_gib"] < 80:
        raise RuntimeError(f"1.5B at {XL_BATCH} x {TRAIN_SEQ} peaked at {full['peak_gib']:.2f} GiB")
    # The off case at 16 x 1024, predicted (not run): what its forward leaves
    # grows by full's per-token slope (4k to 16k) plus what off keeps more a
    # token at 4k; its backward then also holds the bf16 gradients it
    # returns (2 bytes a parameter): the predicted peak is their sum (phase
    # X measures it).
    tokens_small, tokens = XL_SMALL_BATCH * TRAIN_SEQ, XL_BATCH * TRAIN_SEQ
    small_off, small_full = xl["off"], xl["full"]
    slope_full = (full["forward_gib"] - small_full["forward_gib"]) / (tokens - tokens_small)
    slope_off = slope_full + (small_off["forward_gib"] - small_full["forward_gib"]) / tokens_small
    forward_off = small_off["forward_gib"] + slope_off * (tokens - tokens_small)
    n_params = sum(p.numel() for p in smp.nn.DistributedTransformerLMHead(**XL_CFG, device="meta").parameters())
    predicted = full["resident_gib"] + forward_off + 2 * n_params / 2**30
    log(f"[M] what a 1.5B forward leaves a token: full {slope_full * 2**10:.4f} MiB, off {slope_off * 2**10:.4f} MiB; off "
        f"at {XL_BATCH} x {TRAIN_SEQ} (not run): its forward would leave {forward_off:.2f} GiB above the resident "
        f"{full['resident_gib']:.2f}, a predicted peak of {predicted:.2f} GiB with the backward's "
        f"{2 * n_params / 2**30:.2f} GiB of bf16 gradients ({n_params} parameters)")
    out["xl"] = {k: {kk: vv for kk, vv in v.items() if kk != "launches"} for k, v in xl.items()}
    out["xl_off_16k_predicted_gib"] = predicted
    smp.reset()
    return launches_total, out


def phase_x():
    """(On request.) GPT-2 1.5B at 16 x 1024 in one microbatch with
    checkpointing off, the case phase M predicts and does not run: two
    AdamW steps and the second's peak, or the allocation that fails and the
    allocator's peak until then."""
    import smdistributed_modelparallel_tpu_torch as smp

    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    torch.cuda.reset_peak_memory_stats()
    try:
        run = _xl_run("off", XL_BATCH, 2)
    except torch.cuda.OutOfMemoryError as e:
        log(f"[X] GPT-2 1.5B bf16, dropout 0.1, {XL_BATCH} x {TRAIN_SEQ} in one microbatch, off: out of memory, "
            f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of the card's {total:.2f}; "
            f"{str(e).splitlines()[0]}")
        out = None
    else:
        log(f"[X] GPT-2 1.5B bf16, dropout 0.1, {XL_BATCH} x {TRAIN_SEQ} in one microbatch, off: step 2 "
            f"{run['ms'][0]:.2f} ms, {_m_mem_text(run)} of the card's {total:.2f} GiB; losses {run['losses']}")
        out = run["peak_gib"]
    gc.collect()
    torch.cuda.empty_cache()
    smp.reset()
    return out


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


# Phase K: checkpoints and the data loader on the smp.nn path.
CKPT_STEPS = 3  # steps before the save; the uninterrupted run and each resume take as many after it
K_SEED = 4321  # the host stream of token batches
K_TIMED, K_PROFILED = 6, 3  # steps timed, and profiled, with and without prefetch
K_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_ckpt")
K_USER = {"phase": "K", "batches_seen": CKPT_STEPS}


def _host_batches(start, stop, seed=K_SEED):
    """Batches ``start`` to ``stop`` of phase K's seeded host stream: numpy
    int64 token ids [TRAIN_BATCH, TRAIN_SEQ], as a loader reading them from
    host memory gives them."""
    rng = np.random.default_rng(seed)
    for i in range(stop):
        ids = rng.integers(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))
        if i >= start:
            yield ids


def _k_counters():
    return {**_flash_counters(), **_new_counters(), **_fp8_counters(), **_simt_counters()}


def _k_want(steps):
    """Launches of ``steps`` smp.nn fused steps: 48 a step of each flash,
    matmul_bias and bias-GELU kernel, on the tensor-core or "vec" route;
    none of matmul_fp8 or of any CUDA-core route."""
    per_step = LM_CFG["num_layers"] * TRAIN_MB
    return {k: (per_step * steps if k in {**_flash_counters(), **_new_counters()} else 0) for k in _k_counters()}


def _k_train(model, optimizer, train_step, feed):
    """Train on ``feed`` (a loader's batches); the losses, and the launches
    counted from 0 over these steps."""
    counters = _k_counters()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    for ids in feed:
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
    return losses, {k: fn.launches for k, fn in counters.items()}


def _k_check_launches(label, launches, steps):
    want = _k_want(steps)
    if launches != want:
        raise RuntimeError(f"phase K {label}: launches {launches}, expected {want}")


def _k_other_model(seed):
    """GPT-2 124M smp.nn weights from another seed, on the card: what a
    resume must overwrite."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    g = torch.Generator(device="cuda").manual_seed(seed)
    module = smp.nn.DistributedTransformerLMHead(**LM_CFG, fused_bias_gelu=True, device="cuda")
    return init_weights_(module, LM_CFG["initializer_range"], g)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_k_child(root):
    """The resumed run, in a fresh interpreter: ``smp.init``, then
    ``resume_from_checkpoint`` before the model exists (the deferred path),
    then the model from another seed, then the same steps as the
    uninterrupted run. Prints one ``K_CHILD {json}`` line."""
    import smdistributed_modelparallel_tpu_torch as smp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.optim imports torch._dynamo at its first load_state_dict or
    # step, seconds in a fresh process whatever the checkpoint: not restore.
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")
    import_s = time.perf_counter() - t0
    _lm_init(True)
    t0 = time.perf_counter()
    user = smp.resume_from_checkpoint(root, tag="k")
    resume_s = time.perf_counter() - t0
    step_count = smp.state.step_count
    module = _k_other_model(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = smp.DistributedModel(module, device="cuda")  # applies the stashed model state
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    optimizer, train_step = _lm_optimizer_step(model)  # and the optimizer's
    torch.cuda.synchronize()
    model_s, opt_s = t1 - t0, time.perf_counter() - t1
    losses, launches = _k_train(model, optimizer, train_step,
                                smp.dataloader(_host_batches(CKPT_STEPS, 2 * CKPT_STEPS)))
    print("K_CHILD " + json.dumps(dict(losses=losses, launches=launches, user=user, step_count=step_count,
                                       resume_s=resume_s, model_s=model_s, opt_s=opt_s, import_s=import_s)),
          flush=True)


def _k_step_times(model, optimizer, train_step, smi):
    """Phase L's step fed from the host stream, by ``@smp.step``'s own copy
    (the batch's ``.to(device)``) and through ``smp.dataloader``: ms/step,
    the mean of two blocks of K_TIMED steps each (interleaved A B B A), and
    the device's idle share of K_PROFILED profiled steps. Returns {mode:
    (ms, idle share)}."""
    import smdistributed_modelparallel_tpu_torch as smp
    from torch.profiler import ProfilerActivity, profile

    feeds = {"without prefetch (the step copies each host batch)":
             lambda n: (torch.from_numpy(b) for b in _host_batches(0, n, seed=K_SEED + 1)),
             "with smp.dataloader prefetch": lambda n: smp.dataloader(_host_batches(0, n, seed=K_SEED + 1))}

    def run(feed, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ids in feed(n):
            train_step(model, ids)
            optimizer.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for feed in feeds.values():
        run(feed, 1)  # warm-up: the loader's thread and pinned pool
    # Interleaved (A B B A), host time drifts within a call; then profiled.
    labels = list(feeds)
    blocks = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        blocks[label].append(run(feeds[label], K_TIMED) / K_TIMED)
    out = {}
    for label in labels:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_ms = run(feeds[label], K_PROFILED)
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        ms = sum(blocks[label]) / len(blocks[label])
        out[label] = (ms, 1 - busy_ms / wall_ms)
        log(f"[K] smp.nn GPT-2 124M bf16 step, batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches, {label}: "
            f"{ms:.2f} ms/step (blocks of {K_TIMED} steps: {', '.join(f'{b:.2f}' for b in blocks[label])}); profiled "
            f"{K_PROFILED} steps: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}; {smi}")
    return out


def phase_k(smi):
    """Checkpoints and the data loader on the smp.nn path: phase L's model,
    widths and weights fed by ``smp.dataloader`` over a seeded host stream;
    a partial and a full checkpoint after CKPT_STEPS steps, resumed (the
    partial one in a fresh interpreter) into a model from another seed; a
    non-blocking save's snapshot; and the step with and without prefetch."""
    import shutil

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_
    from smdistributed_modelparallel_tpu_torch.shard_io import ShardCatalog

    shutil.rmtree(K_DIR, ignore_errors=True)
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"),
                             LM_CFG["initializer_range"], g)
        init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
        del init
        model, optimizer, train_step = _lm_setup(init_state, True, "cuda")
        del init_state
        before, launches = _k_train(model, optimizer, train_step, smp.dataloader(_host_batches(0, CKPT_STEPS)))
        _k_check_launches("steps before the save", launches, CKPT_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smp.save_checkpoint(K_DIR, tag="k", partial=True, user_content=K_USER)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        smp.save_checkpoint(K_DIR, tag="k_full", partial=False, user_content=K_USER)
        full_save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(os.path.join(K_DIR, "k_partial"))
        full_bytes = os.path.getsize(os.path.join(K_DIR, "k_full"))
        want, after = _k_train(model, optimizer, train_step,
                               smp.dataloader(_host_batches(CKPT_STEPS, 2 * CKPT_STEPS)))
        _k_check_launches("uninterrupted steps", after, CKPT_STEPS)
        log(f"[K] uninterrupted run: losses {before} | {want}")

        # A non-blocking save, then at once a step that updates the
        # parameters and moments in place: the files hold the submission's.
        snap = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        t0 = time.perf_counter()
        smp.save_checkpoint(K_DIR, tag="k_async", blocking=False)
        submit_s = time.perf_counter() - t0
        _k_train(model, optimizer, train_step, smp.dataloader(_host_batches(0, 1, seed=K_SEED + 2)))
        smp.wait_for_checkpoints()
        moved = sum(not torch.equal(v, model.module.state_dict()[k]) for k, v in snap.items())
        cat = ShardCatalog(os.path.join(K_DIR, "k_async_partial"), "model")
        saved = cat.load_tree(model._to_reference(snap))
        cat.close()
        want_ref = model._to_reference(snap)
        torn = [k for k, v in want_ref.items() if saved[k].numpy().tobytes() != v.tobytes()]
        count = int(np.load(os.path.join(K_DIR, "k_async_partial", "optimizer_shards_p0.npz"))["0/count|[]"])
        log(f"[K] blocking=False save: returned after {submit_s:.3f} s; a step then changed {moved} of {len(snap)} "
            f"tensors in place; the files hold the submission's bits for {len(want_ref) - len(torn)} of "
            f"{len(want_ref)} leaves, optimizer count {count} (expected {2 * CKPT_STEPS})")
        if torn or moved == 0 or count != 2 * CKPT_STEPS:
            raise RuntimeError(f"phase K: the non-blocking save is not the submission's snapshot: {torn[:5]}")

        times = _k_step_times(model, optimizer, train_step, smi)
        del model, optimizer, train_step, snap, saved
        smp.reset()
        torch.cuda.empty_cache()

        # The partial checkpoint, resumed in a fresh interpreter.
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--k-child", K_DIR], capture_output=True,
                             text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"phase K child exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        child = json.loads(next(ln for ln in res.stdout.splitlines() if ln.startswith("K_CHILD "))[8:])
        _k_check_launches("resumed child", child["launches"], CKPT_STEPS)
        restore_s = child["resume_s"] + child["model_s"] + child["opt_s"]
        log(f"[K] resumed child ({child_s:.1f} s in all): losses {child['losses']}, user_content {child['user']}, "
            f"step_count {child['step_count']}")

        # The full checkpoint, resumed here.
        _lm_init(True)
        user_full = smp.resume_from_checkpoint(K_DIR, tag="k_full", partial=False)
        model, optimizer, train_step = _lm_train(_k_other_model(SEED + 2), "cuda")
        full, full_launches = _k_train(model, optimizer, train_step,
                                       smp.dataloader(_host_batches(CKPT_STEPS, 2 * CKPT_STEPS)))
        _k_check_launches("full-checkpoint resume", full_launches, CKPT_STEPS)
        log(f"[K] full checkpoint resumed: losses {full}, user_content {user_full}")
        del model, optimizer, train_step
        smp.reset()
        torch.cuda.empty_cache()

        log(f"[K] partial checkpoint of GPT-2 124M (smp.nn, fp32 master weights and AdamW moments): {nbytes} bytes; "
            f"save {save_s:.3f} s ({nbytes / save_s / 1e9:.3f} GB/s; blocking=False returned after {submit_s:.3f} s); "
            f"restore {restore_s:.3f} s in a fresh process (resume {child['resume_s']:.3f} s + model apply "
            f"{child['model_s']:.3f} s + optimizer apply {child['opt_s']:.3f} s; {nbytes / restore_s / 1e9:.3f} GB/s; "
            f"torch._dynamo's import before it, {child['import_s']:.3f} s, not counted); "
            f"full checkpoint {full_bytes} bytes, save {full_save_s:.3f} s; {smi}")
        bad = []
        if child["losses"] != want:
            bad.append(f"resumed losses {child['losses']} != uninterrupted {want}")
        if full != want:
            bad.append(f"full-checkpoint losses {full} != uninterrupted {want}")
        if child["user"] != K_USER or user_full != K_USER or child["step_count"] != CKPT_STEPS:
            bad.append(f"user_content {child['user']} / {user_full}, step_count {child['step_count']}")
        if bad:
            raise RuntimeError("phase K: " + "; ".join(bad))
        launches = {k: launches[k] + after[k] + child["launches"][k] + full_launches[k] for k in launches}
        return launches, dict(want=want, child=child, full=full, times=times, nbytes=nbytes, save_s=save_s,
                              restore_s=restore_s)
    finally:
        shutil.rmtree(K_DIR, ignore_errors=True)


# Phase H: HuggingFace models through smp.from_hf. Each source's config.json
# fields that config_to_smp and the translators read ("architectures" and
# "model_type" name the family); the card's machine has no transformers, so
# each model is an HFModel of such a config and HF-named tensors.
HF_CONFIGS = {
    "gpt2": dict(architectures=["GPT2LMHeadModel"], model_type="gpt2", n_embd=768, n_layer=12, n_head=12,
                 vocab_size=50257, n_positions=1024, activation_function="gelu_new", n_inner=None, attn_pdrop=0.1,
                 resid_pdrop=0.1, embd_pdrop=0.1, layer_norm_epsilon=1e-5, initializer_range=0.02,
                 scale_attn_weights=True, scale_attn_by_inverse_layer_idx=False, reorder_and_upcast_attn=False),
    "gptneo": dict(architectures=["GPTNeoForCausalLM"], model_type="gpt_neo", hidden_size=768, num_layers=12,
                   num_heads=12, vocab_size=50257, max_position_embeddings=2048,
                   attention_types=[[["global", "local"], 6]], window_size=256, intermediate_size=None,
                   activation_function="gelu_new", attention_dropout=0.0, resid_dropout=0.0, embed_dropout=0.0,
                   layer_norm_epsilon=1e-5, initializer_range=0.02),
    "gptneox": dict(architectures=["GPTNeoXForCausalLM"], model_type="gpt_neox", hidden_size=768,
                    num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, vocab_size=50304,
                    max_position_embeddings=2048, rotary_pct=0.25, rotary_emb_base=10000, use_parallel_residual=True,
                    tie_word_embeddings=False, hidden_act="gelu", layer_norm_eps=1e-5, initializer_range=0.02),
    "gptj": dict(architectures=["GPTJForCausalLM"], model_type="gptj", n_embd=4096, n_layer=28, n_head=16,
                 rotary_dim=64, vocab_size=50400, n_positions=2048, activation_function="gelu_new", n_inner=None,
                 attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0, layer_norm_epsilon=1e-5, initializer_range=0.02,
                 tie_word_embeddings=False, scale_attn_weights=True),
    "bert": dict(architectures=["BertForMaskedLM"], model_type="bert", hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, vocab_size=30522, max_position_embeddings=512,
                 type_vocab_size=2, hidden_act="gelu", hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 layer_norm_eps=1e-12, initializer_range=0.02, pad_token_id=0),
    "roberta": dict(architectures=["RobertaForMaskedLM"], model_type="roberta", hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072, vocab_size=50265, max_position_embeddings=514,
                    type_vocab_size=1, hidden_act="gelu", hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                    layer_norm_eps=1e-5, initializer_range=0.02, pad_token_id=1),
    "vit": dict(architectures=["ViTForImageClassification"], model_type="vit", hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072, hidden_act="gelu", qkv_bias=True, layer_norm_eps=1e-12,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, initializer_range=0.02, image_size=224,
                patch_size=16),
}
HF_SOURCES = {"gpt2": "openai-community/gpt2", "gptneo": "EleutherAI/gpt-neo-125M",
              "gptneox": "EleutherAI/pythia-160m", "gptj": "EleutherAI/gpt-j-6b",
              "bert": "google-bert/bert-base-uncased", "roberta": "FacebookAI/roberta-base",
              "vit": "google/vit-base-patch16-224"}
# GPT-J's depth cut from 28 to 2 layers to hold the phase's time (depth only).
HF_REDUCED = {"gptj": dict(n_layer=2)}
# The tiny widths of tests/test_huggingface.py's configs, for (e).
HF_TINY = {
    "gpt2": dict(n_embd=32, n_layer=2, n_head=2, vocab_size=64, n_positions=32, attn_pdrop=0.0, resid_pdrop=0.0,
                 embd_pdrop=0.0),
    "gptj": dict(n_embd=32, n_layer=2, n_head=2, vocab_size=64, n_positions=32, rotary_dim=8),
    "gptneox": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, vocab_size=64,
                    max_position_embeddings=32, rotary_pct=0.5),
    "bert": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, vocab_size=64,
                 max_position_embeddings=32, attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0),
    "gptneo": dict(hidden_size=32, num_layers=2, num_heads=2, vocab_size=64, max_position_embeddings=32,
                   intermediate_size=64, attention_types=[[["global", "local"], 1]], window_size=8),
    "roberta": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, vocab_size=64,
                    max_position_embeddings=36, attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0),
    "vit": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, image_size=8,
                patch_size=4),
}
H_DECODERS = ("gptneo", "gptneox", "gptj")
H_ENCODER_TOL = 3e-2  # |bf16 - fp32| / |fp32| of the real rows' hidden states (BERT, RoBERTa, ViT)
H_B, H_T, H_NEW = 4, 512, 32
H_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_hf_ckpt")


class HFModel:
    """What ``smp.from_hf`` reads of a HuggingFace model: ``config`` (the
    config.json fields as attributes) and ``state_dict()`` (HF-named
    tensors)."""

    def __init__(self, config, state_dict):
        self.config = types.SimpleNamespace(**copy.deepcopy(config))
        self._state_dict = state_dict

    def state_dict(self):
        return dict(self._state_dict)


def hf_model(config, std=0.02, generator=None, device="cuda"):
    """An ``HFModel`` of ``config`` whose tensors are the port's random init
    (normal(0, ``std``) from ``generator``, unit layernorms) in the family's HF
    names, made by the port's own ``translate_state_dict_to_hf``; on the
    CPU."""
    from smdistributed_modelparallel_tpu_torch import convert
    from smdistributed_modelparallel_tpu_torch.nn.huggingface import family_for, translate_model
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    shell = HFModel(config, {})
    fam = family_for(shell)
    module, _, _ = translate_model(shell.config, device=device)
    init_weights_(module, std, generator)
    flat = convert.jax_layout(module)[0](module.state_dict())
    del module
    sd = fam.translate_to_hf(flat, config=shell.config)
    return HFModel(config, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})


def _h_round_trip(model, hf):
    """Keys of ``hf``'s state dict that ``model``'s weights, translated back
    to HF names, do not give bit for bit (any key missing or extra included)."""
    to_hf = model._translate_functions[0]
    back = to_hf(model.reference_state_dict())
    src = hf.state_dict()
    bad = sorted(set(back) ^ set(src))
    bad += [k for k in sorted(set(back) & set(src)) if not np.array_equal(np.asarray(back[k]), src[k].numpy())]
    return bad


def plain_gpt2_logits(sd, ids, n_head, eps):
    """fp32 GPT-2 logits of ``ids`` from the HF-named state dict ``sd``
    (tensors on ids' device), written from the HF model's definition and
    using none of the port: Conv1D products (x @ W + b), gelu_new, a causal
    softmax and the head tied to ``wte``."""
    import torch.nn.functional as F

    w = lambda k: sd[k].float()  # noqa: E731
    B, T = ids.shape
    x = w("transformer.wte.weight")[ids] + w("transformer.wpe.weight")[:T]
    D = x.shape[-1]
    hd = D // n_head
    causal = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()
    i = 0
    while f"transformer.h.{i}.ln_1.weight" in sd:
        p = f"transformer.h.{i}."
        h = F.layer_norm(x, (D,), w(p + "ln_1.weight"), w(p + "ln_1.bias"), eps)
        q, k, v = (h @ w(p + "attn.c_attn.weight") + w(p + "attn.c_attn.bias")).split(D, dim=-1)
        q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2) for t in (q, k, v))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1) @ v
        x = x + a.transpose(1, 2).reshape(B, T, D) @ w(p + "attn.c_proj.weight") + w(p + "attn.c_proj.bias")
        h = F.layer_norm(x, (D,), w(p + "ln_2.weight"), w(p + "ln_2.bias"), eps)
        h = F.gelu(h @ w(p + "mlp.c_fc.weight") + w(p + "mlp.c_fc.bias"), approximate="tanh")
        x = x + h @ w(p + "mlp.c_proj.weight") + w(p + "mlp.c_proj.bias")
        i += 1
    x = F.layer_norm(x, (D,), w("transformer.ln_f.weight"), w("transformer.ln_f.bias"), eps)
    return x @ w("lm_head.weight").t()


def h_inputs(name, config, B, T, gen, device="cuda"):
    """Phase H's input of a family: ``(args, kwargs, real)`` of the model
    call and a bool [B, T] of its real rows. Decoders: [B, T] ids. BERT and
    RoBERTa: B rows of lengths in [T / 4, T] drawn from ``gen``, right-padded
    with the pad id under a key-padding mask ([B, 1, 1, T] bool, True keeps),
    token types 0. ViT: [B, T, D] hidden states."""
    if name == "vit":
        x = torch.randn(B, T, config["hidden_size"], generator=gen, device=device)
        return (x,), {}, torch.ones(B, T, dtype=torch.bool, device=device)
    V = config["vocab_size"]
    ids = torch.randint(2, V, (B, T), generator=gen, device=device)
    if name not in ("bert", "roberta"):
        return (ids,), {}, torch.ones(B, T, dtype=torch.bool, device=device)
    lens = torch.randint(T // 4, T + 1, (B,), generator=gen, device=device)
    real = torch.arange(T, device=device)[None, :] < lens[:, None]
    ids = torch.where(real, ids, config["pad_token_id"])
    return (ids,), dict(token_type_ids=torch.zeros_like(ids), attention_mask=real[:, None, None, :]), real


def _h_tiny_exact():
    """(e): each family at the tiny widths, fp32, on the card and on the CPU
    from the same weights: the largest |difference| of the outputs."""
    import smdistributed_modelparallel_tpu_torch as smp

    smp.init({})
    errs = {}
    for name, tiny in HF_TINY.items():
        config = dict(HF_CONFIGS[name], **tiny)
        hf = hf_model(config, 0.02, torch.Generator().manual_seed(SEED), device="cpu")
        T = 5 if name == "vit" else 16
        args, kw, _ = h_inputs(name, config, 2, T, torch.Generator().manual_seed(SEED), device="cpu")
        outs = []
        for device in ("cpu", "cuda"):
            model = smp.from_hf(hf, device=device).eval()
            with torch.no_grad():
                out = model(*(a.to(device) for a in args), **{k: v.to(device) for k, v in kw.items()})
            outs.append(out.cpu())
        errs[name] = float((outs[0] - outs[1]).abs().max())
    smp.reset()
    return errs


def _h_counters():
    return {**_flash_counters(), **_new_counters(), **_dropout_counters(), **_simt_counters()}


def phase_h():
    """HuggingFace models through ``smp.from_hf``: GPT-2 124M logits against
    an independent plain forward, training, generation and the HF-named
    save (H1); six more families' bf16 forwards against fp32 (H2); every
    family at tiny widths on the card against the CPU (e)."""
    import pickle
    import shutil

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    failures = []
    tiny = _h_tiny_exact()
    log(f"[H] (e) fp32, tiny widths, card vs CPU, max |diff|: {tiny} (limit 1e-5)")
    if max(tiny.values()) > 1e-5:
        failures.append("(e)")

    # H1: GPT-2 124M through smp.from_hf.
    smp.init({"bf16": True, "fused_qkv": True, "microbatches": TRAIN_MB})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = HF_CONFIGS["gpt2"]
    hf = hf_model(cfg, 0.02, g)
    model = smp.from_hf(hf, fused_bias_gelu=True)
    bad = _h_round_trip(model, hf)
    if bad:
        failures.append(f"H1 round trip {bad[:4]}")
    model.eval()
    ids_a = torch.randint(0, cfg["vocab_size"], (2, H_T), generator=g, device="cuda")
    with torch.no_grad():
        ours = model(ids_a)
        ref = plain_gpt2_logits({k: v.cuda() for k, v in hf.state_dict().items()}, ids_a, cfg["n_head"],
                                cfg["layer_norm_epsilon"])
    err_a = float((ours - ref).abs().max())
    ok_a = bool(torch.allclose(ours, ref, atol=2e-4, rtol=2e-3))
    log(f"[H] H1 (a) GPT-2 124M ({HF_SOURCES['gpt2']}) via smp.from_hf, fp32 logits on 2 x {H_T} tokens against the "
        f"plain HF-named forward: max |diff| {err_a:.3e}, max |logit| {float(ref.abs().max()):.3f} (atol 2e-4, rtol "
        f"2e-3) {'ok' if ok_a else 'FAIL'}; round trip to HF names bit-equal: {not bad}")
    if not ok_a:
        failures.append("H1 (a)")
    del ours, ref

    # (b) training: GPT-2's dropouts 0.1, logits mode, AdamW.
    model.train()
    optimizer, train_step = _lm_optimizer_step(model)
    ids = torch.randint(0, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    counters = _h_counters()
    for fn in counters.values():
        fn.launches = 0
    losses = [float(train_step(model, ids).reduce_mean())]
    optimizer.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        losses.append(train_step(model, ids).reduce_mean())
        optimizer.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    losses = [float(x) for x in losses]
    train = {k: fn.launches for k, fn in counters.items()}
    log(f"[H] H1 (b) training, batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches, dropouts 0.1, "
        f"fused_qkv + fused_bias_gelu: {step_ms:.2f} ms/step, {ids.numel() / step_ms * 1e3:.1f} tokens/s (mean of 3 "
        f"steps after 1 warm-up); losses {losses}")
    log(f"[H] H1 (b) launches over 4 steps: {train}")
    per_step = cfg["n_layer"] * TRAIN_MB
    want = {**{k: 4 * per_step for k in {**_flash_counters(), **_new_counters()}},
            "dropout_fwd": 4 * (1 + 2 * cfg["n_layer"]) * TRAIN_MB}
    if any(train[k] != n for k, n in want.items()):
        failures.append(f"H1 (b) launches {train}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        failures.append(f"H1 (b) losses {losses}")

    # (c) generation, greedy; the teacher-forced yardstick runs without dropout.
    model.eval()
    prompts = torch.randint(0, cfg["vocab_size"], (H_B, H_T), generator=g, device="cuda")
    smp.generate(model, prompts, 2)  # warm-up, not counted
    for fn in counters.values():
        fn.launches = 0
    _, prefill_ms = _timed(lambda: smp.generate(model, prompts, 1))
    greedy, greedy_ms = _timed(lambda: smp.generate(model, prompts, H_NEW))
    gen = {k: fn.launches for k, fn in counters.items()}
    forwards = 1 + H_NEW
    want = {"flash_fwd": 2 * cfg["n_layer"], "matmul_bias": forwards * cfg["n_layer"],
            "bias_gelu_fwd": forwards * cfg["n_layer"]}
    if any(gen[k] != n for k, n in want.items()):
        failures.append(f"H1 (c) launches {gen}, expected {want}")
    bf16_module = copy.deepcopy(model.module).to(torch.bfloat16).eval()
    margin = _g_margin(lambda x: bf16_module(x)[0], _g_rows([p.tolist() for p in prompts], greedy, H_T, H_NEW))
    del bf16_module
    log(f"[H] H1 (c) smp.generate, {H_B} prompts of {H_T}, {H_NEW} new tokens, greedy: prefill {prefill_ms:.2f} ms, "
        f"decode {(greedy_ms - prefill_ms) / (H_NEW - 1):.3f} ms/token; worst greedy token {margin:.3e} of its row's "
        f"max |logit| below the row's maximum (limit {S_MARGIN:.0e}); launches {gen}")
    if margin > S_MARGIN or greedy.shape != (H_B, H_T + H_NEW):
        failures.append("H1 (c)")

    # (d) the full checkpoint in HF names, and a second from_hf over it.
    try:
        t0 = time.perf_counter()
        smp.save_checkpoint(H_DIR, tag="hf", partial=False)
        save_s = time.perf_counter() - t0
        with open(os.path.join(H_DIR, "hf"), "rb") as fh:
            saved = pickle.load(fh)["model"]
    finally:
        shutil.rmtree(H_DIR, ignore_errors=True)
    src = hf.state_dict()
    shapes_ok = set(saved) == set(src) and all(tuple(np.shape(saved[k])) == tuple(src[k].shape) for k in src)
    again = smp.from_hf(HFModel(cfg, {k: torch.from_numpy(np.array(v)) for k, v in saved.items()}),
                        fused_bias_gelu=True).eval()
    with torch.no_grad():
        same = torch.equal(model(ids_a), again(ids_a))
    log(f"[H] H1 (d) smp.save_checkpoint(partial=False) after training: {save_s:.2f} s; its model dict has the source's "
        f"{len(src)} HF keys and shapes: {shapes_ok}; a second from_hf over it gives bit-equal fp32 logits: {same}")
    if not (shapes_ok and same):
        failures.append("H1 (d)")
    launches = {k: train[k] + gen[k] for k in train}
    del model, again, optimizer, train_step, hf
    smp.reset()
    torch.cuda.empty_cache()

    # H2: the other families, bf16 against fp32, one forward each.
    smp.init({})
    for name in ("gptneo", "gptneox", "gptj", "bert", "roberta", "vit"):
        cfg = dict(HF_CONFIGS[name], **HF_REDUCED.get(name, {}))
        hf = hf_model(cfg, 0.02, g)
        model = smp.from_hf(hf).eval()
        bad = _h_round_trip(model, hf)
        del hf
        T = 197 if name == "vit" else H_T
        args, kw, real = h_inputs(name, cfg, H_B, T, g)
        with torch.no_grad():
            out32 = model(*args, **kw).float()
            model.module.to(torch.bfloat16)
            args = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a for a in args)
            model(*args, **kw)  # warm-up
            for fn in counters.values():
                fn.launches = 0
            out16, ms = _timed(lambda: model(*args, **kw))
        fwd = {k: fn.launches for k, fn in counters.items() if fn.launches}
        launches = {k: launches.get(k, 0) + fwd.get(k, 0) for k in set(launches) | set(fwd)}
        out16 = out16.float()
        if name in H_DECODERS:
            pick = out32.gather(-1, out16.argmax(-1, keepdim=True))[..., 0]
            err = float(((out32.amax(-1) - pick) / out32.abs().amax(-1)).max())
            lim, what = S_MARGIN, "worst bf16 argmax below the fp32 row maximum, of max |logit|"
        else:
            err = float((out16[real] - out32[real]).norm() / out32[real].norm())
            lim, what = H_ENCODER_TOL, "|bf16 - fp32| / |fp32| over the real rows"
        # GPT-Neo's per-layer local/global switch keeps every layer on the plain
        # path, as the JAX package's gate does (ops/attention.py, local_select).
        n_flash = 0 if name == "gptneo" else len(
            model.module.seq_layers if name == "vit" else model.module.transformer.seq_layers)
        route = "simt" if name == "gptj" else "wgmma"
        got = {"wgmma": fwd.get("flash_fwd", 0), "simt": fwd.get("flash_fwd_simt", 0)}
        ok = err <= lim and not bad and got == {r: n_flash if r == route else 0 for r in got}
        log(f"[H] H2 {name} ({HF_SOURCES[name]}{', ' + str(HF_REDUCED[name]) if name in HF_REDUCED else ''}), "
            f"{tuple(args[0].shape)}: bf16 forward {ms:.2f} ms; {what} {err:.3e} (limit {lim:.0e}); flash_fwd "
            f"launches by route {got} (expected {n_flash} on {route}); round trip bit-equal: {not bad} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"H2 {name}")
        del model, out32, out16, args, kw
        torch.cuda.empty_cache()

    # GPT-J's flash forward at its shape (hd 256) against the plain version.
    saved_counts = {k: fn.launches for k, fn in counters.items()}
    q, k, v = _inputs(H_B, H_T, H_T, 16, 256, torch.bfloat16, g)
    err, ok, detail = fwd_check(lambda: flash_attention(q, k, v), flash_attention_reference(q, k, v), flash_attention,
                                "simt", torch.bfloat16, TOL[torch.bfloat16], float(v.float().abs().max()))
    for key, fn in counters.items():
        fn.launches = saved_counts[key]  # comparison launches do not count
    log(f"[H] flash_fwd at GPT-J's shape B {H_B} T {H_T} H 16 hd 256 bf16 causal: {detail} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("flash_fwd hd 256")
    smp.reset()
    _check_route("phase H (H1)", {k: train[k] + gen[k] for k in train})
    if failures:
        raise RuntimeError(f"phase H: {failures}")
    return launches


# Phase E: the encoder-decoder, seq2seq generation, T5 through smp.from_hf
# and MoE on GPT-2 124M's widths.
E_B, E_S, E_T, E_NEW, E_GEN_B = 16, 512, 128, 32, 4   # encoder rows, their width, decoder width, new tokens
E_ENC_LENS = (128, 512)                               # right-padded encoder lengths drawn from SEED
E_WARMUP, E_STEPS = 1, 3
E_BEAMS, E_RETURN = 4, 2
E_GRAD_TOL = 1e-6                                     # (c): checkpointed step-1 gradients, of max |grad|, fp32
E_SMALL_TOL = 1e-5                                    # E3 (b): card vs CPU, fp32, of max |logit| / |loss|
# flan-T5-base's bf16 argmax against its fp32 row maximum, of max |logit|. At
# random normal(0, 0.02) weights the bf16 roundings of 24 gated, unscaled T5
# v1.1 layers move the encoder's output by 12% of its norm, in the JAX package
# as in the port (0.1220 and 0.1218 on the CPU), so the argmax falls up to
# 0.11 below the row maximum (0.1126 on the card, 0.1117 on the CPU's plain
# path); S_MARGIN (5e-2) holds the 6- and 12-layer models.
E_FLAN_MARGIN = 0.15
# So the argmax gate alone passes a wrong bf16 path. The drift of the bf16
# logits from fp32 (relative Frobenius norm) is held to that of the plain T5
# forward run in bf16 on the same weights: a layer that computes something
# else moves the logits by their own size, a correct one by about as much as
# any other bf16 T5.
E_FLAN_DRIFT = 2.0
T5_SMALL = dict(architectures=["T5ForConditionalGeneration"], model_type="t5", d_model=512, num_layers=6,
                num_decoder_layers=6, num_heads=8, d_kv=64, d_ff=2048, feed_forward_proj="relu",
                dense_act_fn="relu", is_gated_act=False, tie_word_embeddings=True, vocab_size=32128,
                relative_attention_num_buckets=32, relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
                dropout_rate=0.1, initializer_factor=1.0, n_positions=512, decoder_start_token_id=0,
                is_encoder_decoder=True)
FLAN_T5_BASE = dict(T5_SMALL, d_model=768, num_layers=12, num_decoder_layers=12, num_heads=12, d_ff=2048,
                    feed_forward_proj="gated-gelu", dense_act_fn="gelu_new", is_gated_act=True,
                    tie_word_embeddings=False)
E_HF_SOURCES = {"t5": "google-t5/t5-small", "flan": "google/flan-t5-base"}
E_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_t5_ckpt")
# GPT-2 124M's widths (phase L's model) with the repo's expert settings
# (__graft_entry__.py, examples/long_context_moe.py): 4 experts, top-2.
E_MOE_CFG = dict(LM_CFG, num_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
E_MOE_SMALL = dict(LM_CFG, num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64,
                   intermediate_size=256, vocab_size=97, num_positions=64, causal_mask_size=64, num_experts=4)
E4_LAYERS = dict(enc_layers=2, dec_layers=2)           # T5-3B's widths, depth cut from 24 + 24


def _e_counters():
    return {**_flash_counters(), **_new_counters(), **_dropout_counters(), **_simt_counters()}


def _e_zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _e_batch(vocab, gen, rows=E_B):
    """Encoder ids [rows, E_S] right-padded (pad 0) to lengths drawn from
    ``gen`` in E_ENC_LENS, their 2-D int mask, and decoder ids [rows, E_T]."""
    lens = torch.randint(E_ENC_LENS[0], E_ENC_LENS[1] + 1, (rows,), generator=gen, device="cuda")
    mask = (torch.arange(E_S, device="cuda")[None, :] < lens[:, None]).long()
    enc = torch.randint(2, vocab, (rows, E_S), generator=gen, device="cuda") * mask
    dec = torch.randint(2, vocab, (rows, E_T), generator=gen, device="cuda")
    return enc, mask, dec


def _e_seq2seq_step(model):
    """AdamW (optax.adamw's defaults) and the seq2seq training step: mean CE
    of the decoder's shifted tokens (logits mode)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn import vocab_parallel_cross_entropy

    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, enc, dec, mask):
        logits = model(enc, dec, mask)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], dec[:, 1:]).mean()
        model.backward(loss)
        return loss

    return optimizer, train_step


def _e_train(model, optimizer, train_step, args, counters=None):
    """E_WARMUP + E_STEPS steps: (losses, ms/step of the timed steps, peak
    GiB over them, launches of the timed steps)."""
    losses = []
    for _ in range(E_WARMUP):
        losses.append(float(train_step(model, *args).reduce_mean()))
        optimizer.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if counters:
        _e_zero(counters)
    t0 = time.perf_counter()
    for _ in range(E_STEPS):
        losses.append(train_step(model, *args).reduce_mean())
        optimizer.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / E_STEPS
    launches = {k: fn.launches for k, fn in (counters or {}).items()}
    return [float(x) for x in losses], ms, torch.cuda.max_memory_allocated() / 2**30, launches


def _e_finite_falling(losses):
    return all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def _e_margin(module, enc, mask, out):
    """Largest gap of a greedy token to its row's maximum, as a share of the
    row's max |logit|, in a teacher-forced forward of ``module`` on the plain
    attention path: each row's encoder ids and mask, and the decoder ids
    ``out[:, :-1]`` (start token first)."""
    with torch.inference_mode(), _env(SMP_DISABLE_PALLAS_ATTN="1"):
        logits = module(enc, out[:, :-1], mask).float()
    picked = logits.gather(-1, out[:, 1:, None])[..., 0]
    return float(((logits.amax(-1) - picked) / logits.abs().amax(-1)).max())


def _e_generate(model, enc, mask, label, tag, failures):
    """Greedy, sampled and beam ``smp.generate`` on ``enc``: ms, the greedy
    margin, the sampled repeat. Returns the launches of the generate calls;
    the margin's teacher-forced forward is not counted."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.utils import random

    B = enc.shape[0]
    counters = _e_counters()
    _e_zero(counters)
    smp.generate(model, enc, 2, encoder_mask=mask)  # warm-up
    _, first_ms = _timed(lambda: smp.generate(model, enc, 1, encoder_mask=mask))
    greedy, greedy_ms = _timed(lambda: smp.generate(model, enc, E_NEW, encoder_mask=mask))
    sampled, sampled_ms = _timed(lambda: smp.generate(model, enc, E_NEW, encoder_mask=mask, rng=random.key(SEED),
                                                      **G_SAMPLE_KW))
    again = smp.generate(model, enc, E_NEW, encoder_mask=mask, rng=random.key(SEED), **G_SAMPLE_KW)
    beams, beam_ms = _timed(lambda: smp.generate(model, enc, E_NEW, encoder_mask=mask, num_beams=E_BEAMS,
                                                 num_return_sequences=E_RETURN))
    launches = {k: fn.launches for k, fn in counters.items()}
    half = copy.deepcopy(model.module).to(torch.bfloat16).eval()
    margin = _e_margin(half, enc, mask, greedy)
    del half
    for k, fn in counters.items():
        fn.launches = launches[k]
    decode = (greedy_ms - first_ms) / (E_NEW - 1)
    ok = (margin <= S_MARGIN and torch.equal(sampled, again) and greedy.shape == (B, 1 + E_NEW)
          and beams.shape == (B, E_RETURN, 1 + E_NEW) and bool((greedy[:, 0] == 0).all()))
    log(f"[E] {tag} smp.generate {label}, {B} encoder rows of {enc.shape[1]}, {E_NEW} new tokens: encoder + "
        f"first step {first_ms:.2f} ms, decode {decode:.3f} ms/token, {B * E_NEW / greedy_ms * 1e3:.1f} tokens/s "
        f"greedy; sampled {sampled_ms:.2f} ms ({(sampled_ms - first_ms) / (E_NEW - 1):.3f} ms/token), repeat "
        f"equal: {torch.equal(sampled, again)}; {E_BEAMS} beams returning {E_RETURN} {beam_ms:.2f} ms; worst "
        f"greedy token {margin:.3e} of its row's max |logit| below the row's maximum (limit {S_MARGIN:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(tag)
    return launches


def plain_t5_logits(sd, enc, dec, cfg, enc_mask=None, dtype=torch.float32):
    """T5 logits of ``enc`` -> ``dec`` from the HF-named state dict ``sd``
    (tensors on the ids' device), written from the HF model's definition and
    using none of the port: RMSNorm without a mean, the bucketed relative
    bias of block 0 of each stack (bidirectional in the encoder, causal in
    the decoder, none in cross-attention), unscaled attention, the relu or
    gated-gelu FFN and the head tied to ``shared`` (rescaled by d_model **
    -0.5) or untied. Weights and activations in ``dtype``; as in HF, the
    norms' variance and the softmax (with the bias and mask) in fp32."""
    import torch.nn.functional as F

    w = lambda k: sd[k].to(dtype)  # noqa: E731
    eps, H, dk = cfg["layer_norm_epsilon"], cfg["num_heads"], cfg["d_kv"]
    nb, md = cfg["relative_attention_num_buckets"], cfg["relative_attention_max_distance"]
    neg = torch.finfo(torch.float32).min

    def rms(x, key):
        x32 = x.float()
        return w(key) * (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)).to(dtype)

    def bucket(rel, bidirectional):
        n, out = nb, torch.zeros_like(rel)
        if bidirectional:
            n //= 2
            out = out + (rel > 0).long() * n
            rel = rel.abs()
        else:
            rel = -torch.min(rel, torch.zeros_like(rel))
        exact = n // 2
        large = exact + (torch.log(rel.float() / exact) / math.log(md / exact) * (n - exact)).long()
        return out + torch.where(rel < exact, rel, torch.clamp_max(large, n - 1))

    def rel_bias(key, T, S, bidirectional):
        pos = torch.arange(S, device=enc.device)[None, :] - torch.arange(T, device=enc.device)[:, None]
        return w(key)[bucket(pos, bidirectional)].permute(2, 0, 1)[None].float()  # [1, H, T, S]

    def attn(x, kv, p, bias):
        B, T, S = x.shape[0], x.shape[1], kv.shape[1]
        q = (x @ w(p + "q.weight").t()).reshape(B, T, H, dk).transpose(1, 2)
        k = (kv @ w(p + "k.weight").t()).reshape(B, S, H, dk).transpose(1, 2)
        v = (kv @ w(p + "v.weight").t()).reshape(B, S, H, dk).transpose(1, 2)
        a = torch.softmax((q @ k.transpose(-1, -2)).float() + bias, dim=-1).to(dtype) @ v
        return a.transpose(1, 2).reshape(B, T, H * dk) @ w(p + "o.weight").t()

    def ffn(x, p):
        if cfg["is_gated_act"]:
            h = F.gelu(x @ w(p + "wi_0.weight").t(), approximate="tanh") * (x @ w(p + "wi_1.weight").t())
        else:
            h = F.relu(x @ w(p + "wi.weight").t())
        return h @ w(p + "wo.weight").t()

    S, T = enc.shape[1], dec.shape[1]
    pad = torch.zeros(enc.shape, device=enc.device) if enc_mask is None else (1.0 - enc_mask.float()) * neg
    pad = pad[:, None, None, :]
    x = w("shared.weight")[enc]
    bias = rel_bias("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", S, S, True) + pad
    for i in range(cfg["num_layers"]):
        p = f"encoder.block.{i}.layer."
        x = x + attn(rms(x, p + "0.layer_norm.weight"), rms(x, p + "0.layer_norm.weight"), p + "0.SelfAttention.",
                     bias)
        x = x + ffn(rms(x, p + "1.layer_norm.weight"), p + "1.DenseReluDense.")
    h_e = rms(x, "encoder.final_layer_norm.weight")
    y = w("shared.weight")[dec]
    causal = torch.ones(T, T, dtype=torch.bool, device=enc.device).tril()
    bias = rel_bias("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", T, T, False)
    bias = bias.masked_fill(~causal, neg)
    for i in range(cfg["num_decoder_layers"]):
        p = f"decoder.block.{i}.layer."
        h = rms(y, p + "0.layer_norm.weight")
        y = y + attn(h, h, p + "0.SelfAttention.", bias)
        y = y + attn(rms(y, p + "1.layer_norm.weight"), h_e, p + "1.EncDecAttention.", pad)
        y = y + ffn(rms(y, p + "2.layer_norm.weight"), p + "2.DenseReluDense.")
    y = rms(y, "decoder.final_layer_norm.weight")
    if cfg["tie_word_embeddings"]:
        return ((y * cfg["d_model"] ** -0.5) @ w("shared.weight").t()).float()
    return (y @ w("lm_head.weight").t()).float()


def _e1(g, failures):
    """E1: t5_style() (the default dialect) at T5-small's widths: (a)
    training, (b) seq2seq generation, (c) activation checkpointing."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models import t5_style
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    init = init_weights_(t5_style(device="cuda"), 0.02, g)
    state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    n_enc, n_dec = len(init.encoder.seq_layers), len(init.decoder.seq_layers)
    vocab = init.vocab_size
    del init
    enc, mask, dec = _e_batch(vocab, g)
    counters = _e_counters()
    runs = {}
    for ckpt in (False, True):
        smp.init({"bf16": True, "fused_qkv": True, "microbatches": TRAIN_MB})
        module = t5_style(device="meta", activation_checkpointing=ckpt)
        module.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
        model = smp.DistributedModel(module)
        optimizer, train_step = _e_seq2seq_step(model)
        runs[ckpt] = _e_train(model, optimizer, train_step, (enc, dec, mask), counters)
        if not ckpt:
            # (b) generation, on the trained model.
            model.eval()
            gen = _e_generate(model, enc[:E_GEN_B], mask[:E_GEN_B], "greedy, sampled (a key from the seed) and beams",
                              "E1 (b)", failures)
            launches = {k: runs[ckpt][3][k] + gen[k] for k in gen}
        del model, optimizer, train_step, module
        smp.reset()
        torch.cuda.empty_cache()
    losses, ms, peak, train = runs[False]
    real = int(mask.sum())
    per_mb = {"flash": n_enc + 2 * n_dec, "matmul_bias": n_enc + n_dec}
    want = {"flash_fwd": per_mb["flash"], "flash_bwd_dq": per_mb["flash"], "flash_bwd_dkv": per_mb["flash"],
            "matmul_bias": per_mb["matmul_bias"]}
    want = {k: n * TRAIN_MB * E_STEPS for k, n in want.items()}
    got = {k: train[k] for k in want}
    simt = {k: n for k, n in train.items() if k.endswith("_simt") and n}
    ok = got == want and not simt and _e_finite_falling(losses)
    log(f"[E] E1 (a) t5_style() (T5-small widths: d 512, 6 + 6 layers, 8 heads, d_kv 64, d_ff 2048, vocab 32128) "
        f"bf16 training, {E_B} encoder rows of {E_S} (right-padded, {real} real tokens) and {E_B} decoder rows of "
        f"{E_T} in {TRAIN_MB} microbatches, fused_qkv, AdamW: {ms:.2f} ms/step (mean of {E_STEPS} after "
        f"{E_WARMUP} warm-up), {real / ms * 1e3:.1f} real encoder tokens/s ({enc.numel() / ms * 1e3:.1f} counting "
        f"the padding) and {dec.numel() / ms * 1e3:.1f} decoder tokens/s; peak {peak:.2f} GiB; losses {losses}")
    log(f"[E] E1 (a) launches over {E_STEPS} steps: {train} (expected {want} on the tensor cores: per microbatch "
        f"{n_enc} encoder, {n_dec} decoder self- and {n_dec} cross-attention flash launches, {per_mb['matmul_bias']} "
        f"fused QKV) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E1 (a)")
    losses_c, ms_c, peak_c, train_c = runs[True]
    # Full recompute: each layer's forward kernels run twice a microbatch.
    want_c = {k: n * (1 if k.startswith("flash_bwd") else 2) for k, n in want.items()}
    got_c = {k: train_c[k] for k in want_c}
    ok = got_c == want_c and _e_finite_falling(losses_c)
    log(f"[E] E1 (c) the same step under activation_checkpointing=True: {ms_c:.2f} ms/step, peak {peak_c:.2f} GiB "
        f"(off: {ms:.2f} ms, {peak:.2f} GiB); losses {losses_c}; launches {got_c} (expected {want_c}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E1 (c)")
    launches = {k: launches[k] + train_c[k] for k in launches}

    # (c) gradients: a small fp32 copy, step 1 with and without checkpointing.
    small = dict(d_model=128, enc_layers=2, dec_layers=2, n_heads=4, d_kv=32, d_ff=256, vocab_size=97,
                 max_len=256, dropout=0.1)
    st = init_weights_(t5_style(**small, device="cuda"), 0.02, torch.Generator(device="cuda").manual_seed(SEED))
    st = {k: v.detach().clone() for k, v in st.state_dict().items()}
    e, m, d = (t[:4, :256] if t.shape[1] >= 256 else t[:4] for t in (enc % 97, mask, dec % 97))
    grads = {}
    for ckpt in (False, True):
        smp.init({"microbatches": 2, "tensor_parallel_seed": SEED})
        module = t5_style(**small, device="meta", activation_checkpointing=ckpt)
        module.load_state_dict({k: v.clone() for k, v in st.items()}, assign=True)
        model = smp.DistributedModel(module)
        _, train_step = _e_seq2seq_step(model)
        train_step(model, e, d, m)
        grads[ckpt] = {k: v.detach().clone() for k, v in model.grads.items()}
        smp.reset()
    err = max(float((grads[True][k] - g0).abs().max()) / max(float(g0.abs().max()), 1e-30)
              for k, g0 in grads[False].items())
    equal = all(torch.equal(grads[True][k], g0) for k, g0 in grads[False].items())
    enc_grad = float(grads[True]["encoder.seq_layers.0.attention.qkv.weight"].abs().max())
    ok = err <= E_GRAD_TOL and enc_grad > 0
    log(f"[E] E1 (c) fp32 copy (d 128, 2 + 2 layers, dropout 0.1), step-1 gradients checkpointed vs not: max "
        f"|diff| / max |grad| {err:.3e} (limit {E_GRAD_TOL:.0e}), bit-equal {equal}; encoder layer 0 qkv gradient "
        f"max {enc_grad:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E1 (c) gradients")
    return launches


def _e2(g, failures):
    """E2: T5 through ``smp.from_hf``: t5-small (a)-(d), flan-T5-base."""
    import pickle
    import shutil

    import smdistributed_modelparallel_tpu_torch as smp

    counters = _e_counters()
    cfg = T5_SMALL
    smp.init({"bf16": True, "fused_qkv": True, "microbatches": TRAIN_MB})
    hf = hf_model(cfg, 0.02, g)
    model = smp.from_hf(hf)
    bad = _h_round_trip(model, hf)
    model.eval()
    enc, mask, dec = _e_batch(cfg["vocab_size"], g, rows=2)
    with torch.no_grad():
        ours = model(enc, dec, mask)
        ref = plain_t5_logits({k: v.to(enc.device) for k, v in hf.state_dict().items()}, enc, dec, cfg, mask)
    err = float((ours - ref).abs().max())
    ok = bool(torch.allclose(ours, ref, atol=2e-4, rtol=2e-3)) and not bad
    log(f"[E] E2 (a) T5-small ({E_HF_SOURCES['t5']}) via smp.from_hf, fp32 logits on 2 x ({E_S}, {E_T}) tokens "
        f"against the plain HF-named T5 forward: max |diff| {err:.3e}, max |logit| {float(ref.abs().max()):.3f} "
        f"(atol 2e-4, rtol 2e-3); round trip to HF names bit-equal: {not bad} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E2 (a)")
    ids_a = (enc, dec, mask)
    del ours, ref

    # (b) training with T5's dropout 0.1.
    model.train()
    optimizer, train_step = _e_seq2seq_step(model)
    enc, mask, dec = _e_batch(cfg["vocab_size"], g)
    losses, ms, peak, train = _e_train(model, optimizer, train_step, (enc, dec, mask), counters)
    n_enc, n_dec = cfg["num_layers"], cfg["num_decoder_layers"]
    # The relative bias keeps self-attention on the plain path, as the JAX
    # gate does; the decoder's cross-attention (key padding only) takes the
    # flash kernels. The fused QKV (no bias) serves every self-attention.
    # Dropout: each layer's attention output, cross-attention output and MLP
    # output (2 + 3 sites), and the probabilities of the self-attention on
    # the plain path (the flash kernels hash theirs).
    want = {**{k: n_dec for k in _flash_counters()}, "matmul_bias": n_enc + n_dec,
            "dropout_fwd": 2 * n_enc + 3 * n_dec + n_enc + n_dec}
    want = {k: n * TRAIN_MB * E_STEPS for k, n in want.items()}
    got = {k: train[k] for k in want}
    simt = {k: n for k, n in train.items() if k.endswith("_simt") and n}
    ok = got == want and not simt and _e_finite_falling(losses)
    real = int(mask.sum())
    log(f"[E] E2 (b) T5-small training, dropouts 0.1, {E_B} x ({E_S}, {E_T}) in {TRAIN_MB} microbatches ({real} real "
        f"encoder tokens), fused_qkv: {ms:.2f} ms/step, {real / ms * 1e3:.1f} real encoder tokens/s "
        f"({enc.numel() / ms * 1e3:.1f} counting the padding) and {dec.numel() / ms * 1e3:.1f} decoder tokens/s; "
        f"peak {peak:.2f} GiB; losses {losses}; launches over {E_STEPS} steps {train} (expected {want}: flash in the "
        f"cross-attention only) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E2 (b)")

    # (c) generation on 4 x 512, as E1 (b).
    model.eval()
    gen = _e_generate(model, enc[:E_GEN_B], mask[:E_GEN_B], "T5-small, greedy, sampled and beams", "E2 (c)",
                      failures)

    # (d) the full checkpoint in HF names, and a second from_hf over it.
    try:
        t0 = time.perf_counter()
        smp.save_checkpoint(E_DIR, tag="hf", partial=False)
        save_s = time.perf_counter() - t0
        with open(os.path.join(E_DIR, "hf"), "rb") as fh:
            saved = pickle.load(fh)["model"]
    finally:
        shutil.rmtree(E_DIR, ignore_errors=True)
    src = hf.state_dict()
    shapes_ok = set(saved) == set(src) and all(tuple(np.shape(saved[k])) == tuple(src[k].shape) for k in src)
    again = smp.from_hf(HFModel(cfg, {k: torch.from_numpy(np.array(v)) for k, v in saved.items()})).eval()
    with torch.no_grad():
        same = torch.equal(model(*ids_a), again(*ids_a))
    log(f"[E] E2 (d) smp.save_checkpoint(partial=False) after training: {save_s:.2f} s; its model dict has the "
        f"source's {len(src)} HF keys and shapes: {shapes_ok}; a second from_hf over it gives bit-equal fp32 "
        f"logits: {same}")
    if not (shapes_ok and same):
        failures.append("E2 (d)")
    launches = {k: train[k] + gen[k] for k in gen}
    del model, again, optimizer, train_step, hf
    smp.reset()
    torch.cuda.empty_cache()

    # flan-T5-base: fp32 logits against the plain forward, one bf16 forward
    # against fp32 (the plain forward's own bf16 drift beside it), and greedy
    # generation.
    cfg = FLAN_T5_BASE
    smp.init({"bf16": True})
    hf = hf_model(cfg, 0.02, g)
    model = smp.from_hf(hf).eval()
    bad = _h_round_trip(model, hf)
    sd = {k: v.to("cuda") for k, v in hf.state_dict().items()}
    del hf
    enc, mask, dec = _e_batch(cfg["vocab_size"], g, rows=E_GEN_B)
    with torch.no_grad():
        out32 = model(enc, dec, mask).float()
        ref32 = plain_t5_logits(sd, enc, dec, cfg, mask)
        ref16 = plain_t5_logits(sd, enc, dec, cfg, mask, dtype=torch.bfloat16)
        greedy, gen_ms = _timed(lambda: smp.generate(model, enc, E_NEW, encoder_mask=mask))
        model.module.to(torch.bfloat16)
        model(enc, dec, mask)  # warm-up
        out16, fwd_ms = _timed(lambda: model(enc, dec, mask))
    del sd

    def gap(lo):  # the worst argmax of ``lo`` below its row's fp32 maximum, of max |logit|
        pick = out32.gather(-1, lo.float().argmax(-1, keepdim=True))[..., 0]
        return float(((out32.amax(-1) - pick) / out32.abs().amax(-1)).max())

    def drift(lo, hi):
        return float((lo.float() - hi).norm() / hi.norm())

    err32 = float((out32 - ref32).abs().max())
    err, err_ref = gap(out16), gap(ref16)
    ours, plain = drift(out16, out32), drift(ref16, ref32)
    ok = (bool(torch.allclose(out32, ref32, atol=2e-4, rtol=2e-3)) and err <= E_FLAN_MARGIN
          and ours <= E_FLAN_DRIFT * plain and not bad and greedy.shape == (E_GEN_B, 1 + E_NEW))
    log(f"[E] E2 flan-T5-base ({E_HF_SOURCES['flan']}: d 768, 12 + 12 layers, gated-gelu, untied) via smp.from_hf, "
        f"{E_GEN_B} x ({E_S}, {E_T}): fp32 logits {err32:.3e} from the plain T5 forward (max |logit| "
        f"{float(ref32.abs().max()):.3f}; atol 2e-4, rtol 2e-3); bf16 forward {fwd_ms:.2f} ms; worst bf16 argmax "
        f"{err:.3e} of max |logit| below the fp32 row maximum (limit {E_FLAN_MARGIN:.2f}; the plain forward in bf16: "
        f"{err_ref:.3e}); bf16 logits' drift from fp32 {ours:.4f} (the plain forward's {plain:.4f}, limit "
        f"{E_FLAN_DRIFT:.1f}x); greedy smp.generate of {E_NEW} tokens {gen_ms:.2f} ms; round trip bit-equal: "
        f"{not bad} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E2 flan-T5-base")
    del model, out32, out16, ref32, ref16
    smp.reset()
    torch.cuda.empty_cache()
    return launches


def _e3(g, failures):
    """E3: MoE at GPT-2 124M's widths: (a) training beside the dense step,
    (b) a tiny fp32 MoE head card vs CPU, (c) greedy decoding."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    counters = _e_counters()
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    out = {}
    for name, cfg in (("dense", LM_CFG), ("moe", E_MOE_CFG)):
        init = init_weights_(smp.nn.DistributedTransformerLMHead(**cfg, device="cuda"), cfg["initializer_range"],
                             torch.Generator(device="cuda").manual_seed(SEED))
        state = {k: v.detach().clone() for k, v in init.state_dict().items()}
        n_params = sum(p.numel() for p in init.parameters())
        del init
        model, optimizer, train_step = _lm_setup(state, True, "cuda", cfg)
        auxes = []
        if name == "moe":
            real = model._end_microbatch

            def spy():  # the folded aux of each microbatch, read after the steps
                loss, n, diff = real()
                auxes.append(None if loss is None else (diff - loss).detach())
                return loss, n, diff

            model._end_microbatch = spy
        losses, ms, peak, launches = _e_train(model, optimizer, train_step, (ids,), counters)
        model.__dict__.pop("_end_microbatch", None)
        out[name] = dict(ms=ms, losses=losses, peak=peak, launches=launches, params=n_params,
                         auxes=[None if a is None else round(float(a), 4) for a in auxes],
                         model=model if name == "moe" else None)
        del optimizer, train_step, model
        if name == "dense":
            smp.reset()
        torch.cuda.empty_cache()
    moe = out["moe"]
    per = LM_CFG["num_layers"] * TRAIN_MB * E_STEPS
    want = {**{k: per for k in (*_flash_counters(), "matmul_bias")}, "bias_gelu_fwd": 0, "bias_gelu_bwd": 0}
    got = {k: moe["launches"][k] for k in want}
    simt = {k: n for k, n in moe["launches"].items() if k.endswith("_simt") and n}
    ok = got == want and not simt and _e_finite_falling(moe["losses"]) and all(
        a is not None and math.isfinite(a) for a in moe["auxes"])
    for name in ("dense", "moe"):
        r = out[name]
        kind = "with 4 experts a layer (top-2, capacity 1.25)" if name == "moe" else "dense (phase L)"
        log(f"[E] E3 (a) GPT-2 124M widths {kind}, {r['params'] / 1e6:.1f}M parameters, bf16 training, "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches, logits mode, fused_qkv, AdamW: {r['ms']:.2f} "
            f"ms/step (mean of {E_STEPS} after {E_WARMUP} warm-up), {ids.numel() / r['ms'] * 1e3:.1f} tokens/s; peak {r['peak']:.2f} GiB; losses {r['losses']}")
    log(f"[E] E3 (a) MoE folded aux a microbatch over the {E_WARMUP + E_STEPS} steps (the sum over "
        f"{LM_CFG['num_layers']} layers, coefficient 0.01, weight 1.0): {moe['auxes']}; launches over {E_STEPS} "
        f"timed steps {moe['launches']} (expected {want}, none on the CUDA cores) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E3 (a)")
    launches = dict(moe["launches"])

    # (c) greedy decoding at full width.
    model = moe["model"]
    model.eval()
    prompts = torch.randint(0, LM_CFG["vocab_size"], (E_GEN_B, E_S), generator=g, device="cuda")
    smp.generate(model, prompts, 2)
    _e_zero(counters)
    _, first_ms = _timed(lambda: smp.generate(model, prompts, 1))
    greedy, greedy_ms = _timed(lambda: smp.generate(model, prompts, E_NEW))
    gen = {k: fn.launches for k, fn in counters.items()}
    again = smp.generate(model, prompts, E_NEW)
    ok = torch.equal(greedy, again) and greedy.shape == (E_GEN_B, E_S + E_NEW)
    log(f"[E] E3 (c) MoE greedy smp.generate, {E_GEN_B} prompts of {E_S}, {E_NEW} new tokens: prefill {first_ms:.2f} "
        f"ms, decode {(greedy_ms - first_ms) / (E_NEW - 1):.3f} ms/token; repeat equal {torch.equal(greedy, again)}; "
        f"launches {gen} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E3 (c)")
    launches = {k: launches[k] + gen[k] for k in launches}
    del model, moe["model"]
    smp.reset()
    torch.cuda.empty_cache()

    # (b) a tiny fp32 MoE head, top-1 and top-2, on the card and on the CPU.
    worst = {}
    for k in (1, 2):
        cfg = dict(E_MOE_SMALL, moe_top_k=k)
        init = init_weights_(smp.nn.DistributedTransformerLMHead(**cfg), 0.02, torch.Generator().manual_seed(SEED))
        st = init.state_dict()
        ids_s = torch.randint(0, 97, (4, 64), generator=torch.Generator().manual_seed(SEED))
        res = {}
        for device in ("cuda", "cpu"):
            m, opt, step_fn = _lm_setup(st, False, device, cfg, microbatches=2, bf16=False)
            m.eval()
            with torch.no_grad():
                logits = m(ids_s.to(device)).cpu()
            toks = smp.generate(m, ids_s[:, :16].to(device), 8).cpu()
            m.train()
            ls = []
            for _ in range(2):
                ls.append(float(step_fn(m, ids_s.to(device)).reduce_mean()))
                opt.step()
            res[device] = (logits, toks, ls)
            smp.reset()
        lg = float((res["cuda"][0] - res["cpu"][0]).abs().max() / res["cpu"][0].abs().max())
        ls = max(abs(a - b) / abs(b) for a, b in zip(res["cuda"][2], res["cpu"][2]))
        worst[k] = dict(logits=lg, losses=ls, tokens_equal=torch.equal(res["cuda"][1], res["cpu"][1]))
    ok = all(v["logits"] <= E_SMALL_TOL and v["losses"] <= E_SMALL_TOL and v["tokens_equal"] for v in worst.values())
    log(f"[E] E3 (b) fp32 MoE head (2 layers, d 64, 4 experts), card vs CPU by top-k: {worst} (logits and the two "
        f"steps' losses within {E_SMALL_TOL:.0e} relative, greedy tokens equal) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E3 (b)")
    return launches


def _e4(g, failures):
    """E4: T5-3B's widths at 2 + 2 layers: a bf16 forward against fp32, and
    its hd-128 flash forward against the plain version."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models import t5_style_3b
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_
    from smdistributed_modelparallel_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    counters = _e_counters()
    smp.init({})
    module = init_weights_(t5_style_3b(**E4_LAYERS, device="cuda"), 0.02, g)
    model = smp.DistributedModel(module).eval()
    enc, mask, dec = _e_batch(module.vocab_size, g, rows=E_GEN_B)
    with torch.no_grad():
        out32 = model(enc, dec, mask).float()
        model.module.to(torch.bfloat16)
        model(enc, dec, mask)
        _e_zero(counters)
        out16, ms = _timed(lambda: model(enc, dec, mask))
    fwd = {k: fn.launches for k, fn in counters.items()}
    pick = out32.gather(-1, out16.float().argmax(-1, keepdim=True))[..., 0]
    err = float(((out32.amax(-1) - pick) / out32.abs().amax(-1)).max())
    n_flash = E4_LAYERS["enc_layers"] + 2 * E4_LAYERS["dec_layers"]  # encoder, decoder self- and cross-attention
    got = {"wgmma": fwd["flash_fwd"], "simt": fwd["flash_fwd_simt"]}
    ok = err <= S_MARGIN and got == {"wgmma": 0, "simt": n_flash}
    log(f"[E] E4 t5_style_3b (d 1024, 32 heads, d_kv 128, d_ff 16384; {E4_LAYERS}) bf16 forward, {E_GEN_B} x ({E_S}, "
        f"{E_T}): {ms:.2f} ms; worst bf16 argmax {err:.3e} of max |logit| below the fp32 row maximum (limit "
        f"{S_MARGIN:.0e}); flash_fwd by route {got} (expected {n_flash} on simt: hd 128) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E4 forward")
    del model, module, out32, out16
    smp.reset()
    torch.cuda.empty_cache()
    # The encoder's flash forward at E4's shape against the plain version.
    saved = {k: fn.launches for k, fn in counters.items()}
    q, k, v = _inputs(E_GEN_B, E_S, E_S, 32, 128, torch.bfloat16, g)
    kpad = torch.where(mask.bool(), 0.0, -1e9).float()
    err, ok, detail = fwd_check(lambda: flash_attention(q, k, v, kpad, causal=False),
                                flash_attention_reference(q, k, v, kpad, causal=False), flash_attention, "simt",
                                torch.bfloat16, TOL[torch.bfloat16], float(v.float().abs().max()))
    for key, fn in counters.items():
        fn.launches = saved[key]  # comparison launches do not count
    log(f"[E] E4 flash_fwd at its encoder shape B {E_GEN_B} T {E_S} H 32 hd 128 bf16, key padding: {detail} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("E4 flash_fwd hd 128")
    return fwd


def phase_e():
    """The encoder-decoder (E1), T5 through smp.from_hf (E2), MoE on GPT-2
    124M's widths (E3) and T5-3B's widths at 2 + 2 layers (E4)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    failures = []
    t0 = time.perf_counter()
    l1 = _e1(g, failures)
    t1 = time.perf_counter()
    l2 = _e2(g, failures)
    t2 = time.perf_counter()
    l3 = _e3(g, failures)
    t3 = time.perf_counter()
    l4 = _e4(g, failures)
    t4 = time.perf_counter()
    log(f"[E] seconds: E1 {t1 - t0:.1f}, E2 {t2 - t1:.1f}, E3 {t3 - t2:.1f}, E4 {t4 - t3:.1f}")
    launches = {k: sum(d.get(k, 0) for d in (l1, l2, l3, l4)) for k in set(l1) | set(l2) | set(l3) | set(l4)}
    log(f"[E] launches on phase E's paths (E1 (a)-(c), E2 (b) and (c), E3 (a) and (c), E4): {launches}")
    _check_route("phase E (E1-E3)", {k: l1.get(k, 0) + l2.get(k, 0) + l3.get(k, 0) for k in l1})
    if failures:
        raise RuntimeError(f"phase E: {failures}")
    return launches


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
    # phase E's cross-attention (T5-small widths): 128 decoder rows against
    # 512 right-padded encoder keys, a fully padded row among them
    ("cross_kpad", 4, 128, 512, 8, 64, dict(causal=False, kpad="right_and_full")),
    ("dropout_0.1", 2, 256, 256, 4, 64, dict(dropout_rate=0.1, seed=-123456789)),
    ("dropout_head_remap", 2, 256, 256, 4, 64, dict(dropout_rate=0.1, seed=77, head0=4, head_total=12,
                                                     counter_len=1000)),
    ("hd128", 2, 256, 256, 4, 128, {}),
    ("hd256_scale", 1, 128, 128, 2, 256, dict(scale=0.1)),
    # phase E4's encoder (T5-3B's widths: 32 heads of 128)
    ("hd128_t5_3b", 4, 512, 512, 32, 128, dict(causal=False)),
    ("ragged_t200", 2, 200, 200, 4, 48, {}),
    # phase M's GPT-2 1.5B microbatches: 25 heads of 64, dropout 0.1
    ("xl_b4_dropout", 4, 1024, 1024, 25, 64, dict(dropout_rate=0.1, seed=1234567)),
    ("xl_b16_dropout", 16, 1024, 1024, 25, 64, dict(dropout_rate=0.1, seed=-7654321)),
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
MAIN_CASES = ("main_path_causal", "train_path_causal", "xl_b4_dropout", "xl_b16_dropout")  # bf16 only
# Also in fp16, forward and backward: the training shape, T != S, a window,
# fully-masked rows, dropout and a head dim the tensor cores do not take.
FP16_CASES = ("train_path_causal", "t_lt_s_causal", "causal_window", "kpad_fully_padded_rows", "dropout_head_remap",
              "hd128", "cross_kpad")


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
    seeds = _d_seeds()
    d_cases = [(f"phase_d_seed_layer{i}", TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, TRAIN_SEQ, LM_CFG["num_attention_heads"],
                LM_CFG["attention_head_size"], dict(dropout_rate=0.1, seed=seeds[i])) for i in (0, len(seeds) - 1)]
    log(f"[B] phase D's first step derives the attention seeds {seeds} (microbatch 0, layers 0-{len(seeds) - 1})")
    for name, B, T, S, H, hd, kw in CASES + d_cases:
        dtypes = [torch.bfloat16] if name in MAIN_CASES or name.startswith("phase_d") else [torch.float32,
                                                                                            torch.bfloat16]
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
            elif kw.get("kpad") == "right_and_full":
                # EncoderDecoderLM's encoder padding (additive -1e9): rows of
                # 200, 0 (fully padded) and 400 real keys, and a full row.
                kpad = torch.zeros(B, S, device="cuda")
                kpad[0, 200:] = -1e9
                kpad[1, :] = -1e9
                kpad[2, 400:] = -1e9
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
    new_err.update(_phase_b_dropout(failures))
    new_err.update(_phase_b_health(failures))
    if failures:
        raise RuntimeError(f"kernel disagrees with its plain version: {failures}")
    return main_err, bwd_main_err, new_err


def _d_seeds():
    """The int32 seeds phase D's first dropout step hands the flash kernels
    for microbatch 0, by layer. The keys depend on the seed, the step, the
    microbatch and the layer, not on the widths or the length, so a
    12-layer copy of width 8 takes a forward-only step of 16 tokens on the
    CPU (tensor_parallel_seed 0, TRAIN_MB microbatches) with the flash route
    forced there (its plain version), and the seeds are read off its
    calls."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.ops import attention as att

    cfg = dict(LM_DROP_CFG, num_attention_heads=1, attention_head_size=8, hidden_size=8, intermediate_size=8,
               vocab_size=97)
    seeds = []
    real = att.flash_attention

    def spy(*a, **kw):
        seeds.append(kw["seed"])
        return real(*a, **kw)

    _lm_init(False, bf16=False)
    model = smp.DistributedModel(smp.nn.DistributedTransformerLMHead(**cfg), device="cpu")

    @smp.step
    def forward(model, ids):
        return model(ids)

    with mock.patch.object(att, "_kernel_ok", lambda q, k, v: True), mock.patch.object(att, "flash_attention", spy):
        forward(model, torch.zeros((TRAIN_MB, 16), dtype=torch.long))
    smp.reset()
    return seeds[:cfg["num_layers"]]


# threefry_bits against its plain version: (case, n, offset).
BITS_CASES = (("path mask [2048, 768]", 2048 * 768, 0), ("one element", 1, 0), ("odd size and offset", 1000003, 5),
              ("offset past 2**32", 1000, 2**32 - 100), ("Gumbel draw [4, 50257]", 4 * 50257, 0),
              ("serving draw [1, 50257]", 50257, 0))
DROP_RATES = (0.1, 0.5, 0.0)
DROP_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
DROP_SHAPES = ((2048, 768), (3, 1001), (4096, 1600), (16384, 1600))  # the paths' (124M, 1.5B), and an odd one


def _bit_view(t):
    """A float tensor's bit patterns, for comparisons that tell -0 from +0."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _phase_b_dropout(failures):
    """``threefry_bits`` and the dropout pair against their plain versions,
    bit for bit: the bits under keys from ``key``, ``fold_in`` and ``split``
    (and one with both words' high bits set), and under a serving stream's
    key (``ServingEngine._rng_schedule``), over BITS_CASES; the forward's
    y and mask and the backward's dx in fp32, bf16 and fp16 at DROP_RATES
    over DROP_SHAPES. Returns the
    largest |difference| of each kernel (0.0 when every bit agrees)."""
    from smdistributed_modelparallel_tpu_torch.ops import dropout as dr
    from smdistributed_modelparallel_tpu_torch.serving import ServeRequest, ServingEngine
    from smdistributed_modelparallel_tpu_torch.utils import random

    counters = {**_dropout_counters(), **_shard_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    base = random.key(SEED)
    keys = {"key(SEED)": base, "fold_in(., crc32('dropout'))": random.fold_in(base, random._stream_id("dropout")),
            "split(., 7)[3]": random.split(base, 7)[3], "[0xDEADBEEF, 0x89ABCDEF]": [0xDEADBEEF, 0x89ABCDEF],
            # The key of a sampled stream's 6th token (seed 3, 128 new tokens).
            "serving schedule[5]": ServingEngine._rng_schedule(ServeRequest("k", [0], 128, seed=3))[5]}
    errs = {"threefry_bits": 0.0, "dropout_fwd": 0.0, "dropout_bwd": 0.0}
    for kname, k in keys.items():
        for case, n, offset in BITS_CASES:
            got = dr.threefry_bits(k, n, offset=offset, device="cuda")
            want = dr.reference_threefry_bits(k, n, offset=offset, device="cuda")
            ok = torch.equal(got, want)
            errs["threefry_bits"] = max(errs["threefry_bits"],
                                        float((got.long() - want.long()).abs().max()) if n else 0.0)
            log(f"[B] threefry_bits {case:24s} key {kname:28s} equal: {ok} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"threefry_bits/{case}/{kname}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = keys["split(., 7)[3]"]
    for dtype in DROP_DTYPES:
        for rate in DROP_RATES:
            for shape in DROP_SHAPES:
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                y, mask = dr.dropout_fwd(x, rate, k)
                y_ref, keep = dr.reference_dropout_fwd(x, rate, k)
                dx = dr.dropout_bwd(dy, mask, rate)
                dx_ref = dr.reference_dropout_bwd(dy, keep, rate)
                fwd_ok = torch.equal(_bit_view(y), _bit_view(y_ref)) and torch.equal(mask.bool(), keep)
                bwd_ok = torch.equal(_bit_view(dx), _bit_view(dx_ref))
                errs["dropout_fwd"] = max(errs["dropout_fwd"], float((y.float() - y_ref.float()).abs().max()))
                errs["dropout_bwd"] = max(errs["dropout_bwd"], float((dx.float() - dx_ref.float()).abs().max()))
                tag = f"{str(dtype).removeprefix('torch.'):9s} rate {rate} {list(shape)}"
                log(f"[B] dropout_fwd {tag}: y and mask bit-equal {fwd_ok}, kept {float(keep.float().mean()):.4f}; "
                    f"dropout_bwd bit-equal {bwd_ok} {'ok' if fwd_ok and bwd_ok else 'FAIL'}")
                if not fwd_ok:
                    failures.append(f"dropout_fwd/{tag}")
                if not bwd_ok:
                    failures.append(f"dropout_bwd/{tag}")
    # The index map (nn/utils.shard_index) at the tp = 2 shards of phase N:
    # a rank's 6 heads of [2, 12, 1024, 1024] attention probabilities and its
    # T block of a [2, 1024, 768] hidden activation, each rank's part.
    errs["dropout_fwd_index_map"] = 0.0
    for whole, dim in (((2, 12, 1024, 1024), 1), ((2, 1024, 768), 1)):
        for rank in range(2):
            local = list(whole)
            local[dim] //= 2
            inner = int(np.prod(local[dim + 1:]))
            index = (rank * local[dim] * inner, local[dim] * inner, whole[dim] * inner)
            n = int(np.prod(local))
            got = dr.threefry_bits(k, n, index[0], device="cuda", run=index[1], stride=index[2])
            want = dr.reference_threefry_bits(k, n, index[0], "cuda", index[1], index[2])
            bits_ok = torch.equal(got, want)
            errs["threefry_bits"] = max(errs["threefry_bits"], float((got.long() - want.long()).abs().max()))
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(local, generator=gen, device="cuda").to(dtype)
                y, mask = dr.dropout_fwd(x, 0.1, k, index)
                y_ref, keep = dr.reference_dropout_fwd(x, 0.1, k, index)
                ok = torch.equal(_bit_view(y), _bit_view(y_ref)) and torch.equal(mask.bool(), keep)
                errs["dropout_fwd_index_map"] = max(errs["dropout_fwd_index_map"],
                                                    float((y.float() - y_ref.float()).abs().max()))
                tag = f"{str(dtype).removeprefix('torch.'):9s} rank {rank} of {list(whole)} cut on dim {dim}"
                log(f"[B] index-mapped threefry_bits and dropout_fwd {tag}: bits bit-equal {bits_ok}, y and mask "
                    f"bit-equal {ok}, kept {float(keep.float().mean()):.4f} {'ok' if ok and bits_ok else 'FAIL'}")
                if not (ok and bits_ok):
                    failures.append(f"index-mapped dropout/{tag}")
    for key, fn in counters.items():
        fn.launches = saved[key]  # comparison launches do not count
    return errs


def _health_leaf(n, dtype, gen, bad=(), device="cuda"):
    """A [n] tensor of ``dtype`` from ``gen`` (magnitudes to ~3e4, bf16 and
    fp16 finite), with ``bad`` = ((index, value), ...) written in."""
    x = (torch.randn(n, generator=gen, device=device) * 300.0).to(dtype)
    for i, v in bad:
        x[i] = v
    return x


def _phase_b_health(failures):
    """``health_reduce`` against its plain version, bit for bit (counts,
    abs-max and first microbatch of every row): fp32, bf16 and fp16 leaves
    spanning three chunks with NaN, +inf or -inf at the first, a middle or
    the last element beside a clean leaf; a one-element leaf; a leaf whose
    base is not 16-byte aligned; 300 leaves of mixed sizes and dtypes; a
    stacked entry (a [4, ...] tensor and per-microbatch pieces) whose first
    bad microbatch is 2 of 4; grouped pieces; and GPT-2 124M's 148 gradient
    tensors (fp32) with one inf. One launch a call. Returns the largest
    |difference| (0.0 when every word is equal)."""
    from smdistributed_modelparallel_tpu_torch.ops.health_reduce import health_reduce, reference_health_reduce

    saved = health_reduce.launches
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = 0.0
    n = 2 * 16384 + 4099  # three chunks, the last ragged
    cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for value in (float("nan"), float("inf"), float("-inf")):
            for where in (0, n // 2 + 1, n - 1):
                cases.append((f"{str(dtype).removeprefix('torch.')} {value} at {where}",
                              [("grads", [_health_leaf(n, dtype, gen, ((where, value),)),
                                          _health_leaf(257, dtype, gen)], None)]))
    cases.append(("one element", [("a", [torch.tensor([float("nan")], device="cuda")], None),
                                  ("b", [torch.tensor([2.5], device="cuda")], None)]))
    cases.append(("unaligned base", [("a", [_health_leaf(4103, torch.bfloat16, gen, ((7, float("inf")),))[1:]],
                                      None)]))
    sizes = torch.randint(1, 5000, (300,), generator=torch.Generator().manual_seed(SEED)).tolist()
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    many = [_health_leaf(s, dtypes[i % 3], gen, ((s // 2, float("nan")),) if i % 37 == 5 else ())
            for i, s in enumerate(sizes)]
    cases.append(("300 leaves", [("grads", many, None)]))
    stacked = _health_leaf(4 * 1000 * 7, torch.float32, gen, ((2 * 7000 + 11, float("nan")),
                                                              (3 * 7000, float("-inf")))).reshape(4, 1000, 7)
    pieces = [_health_leaf(33, torch.bfloat16, gen, ((5, float("inf")),) if mb >= 2 else ()) for mb in range(4)]
    cases.append(("stacked, first bad microbatch 2 of 4", [("outputs", [stacked], 4), ("loss", [pieces], 4),
                                                           ("grouped", [[many[0], many[1]], many[2]], None)]))
    shapes = [p.shape for p in _lm_param_shapes()]
    grads = [torch.randn(s, generator=gen, device="cuda") * 1e-3 for s in shapes]
    grads[7].view(-1)[grads[7].numel() // 2] = float("inf")
    cases.append((f"GPT-2 124M gradients ({len(grads)} fp32 tensors)", [("grads", grads, None)]))
    for label, entries in cases:
        before = health_reduce.launches
        got = health_reduce(entries)
        want = reference_health_reduce(entries)
        torch.cuda.synchronize()
        ok = health_reduce.launches == before + 1 and torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
        log(f"[B] health_reduce {label:40s}: word {got.tolist() if got.shape[0] <= 3 else got.shape}, "
            f"equal {torch.equal(got, want)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"health_reduce/{label}")
    health_reduce.launches = saved  # comparison launches do not count
    return {"health_reduce": err}


def _lm_param_shapes():
    """Phase L's parameters (GPT-2 124M's smp.nn LM head) on the meta device."""
    import smdistributed_modelparallel_tpu_torch as smp

    return list(smp.nn.DistributedTransformerLMHead(**LM_CFG, fused_bias_gelu=True, device="meta").parameters())


def _phase_c_health():
    """``health_reduce`` at V1's step: GPT-2 124M's 148 fp32 gradient tensors,
    the 4 microbatch losses and the stacked loss output (``cheap``), and the
    same with the 148 fp32 parameters (``full``), by CUDA-graph replay, beside
    the plain version and the bound: the bytes read once (no PyTorch call
    computes the function, so no library time)."""
    from smdistributed_modelparallel_tpu_torch.ops.health_reduce import health_reduce, reference_health_reduce

    saved = health_reduce.launches
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3 for p in _lm_param_shapes()]
    params = [torch.randn(p.shape, generator=gen, device="cuda") * 2e-2 for p in _lm_param_shapes()]
    losses = [torch.rand((), generator=gen, device="cuda") + 10.0 for _ in range(TRAIN_MB)]
    cheap = [("loss", [losses], TRAIN_MB), ("outputs", [torch.stack(losses)], TRAIN_MB), ("grads", grads, None)]
    full = [("params", params, None)] + cheap
    out = {}
    for label, entries in (("cheap", cheap), ("full", full)):
        nbytes = sum(p.numel() * p.element_size() for _, leaves, _ in entries for leaf in leaves
                     for p in (leaf if isinstance(leaf, list) else [leaf]))
        nelem = nbytes // 4
        bound_ms, bound_by = _bound(nbytes, 3 * nelem, torch.float32)  # isfinite, abs, max an element
        ms = cuda_graph_time_ms(lambda: health_reduce(entries))
        eager_ms = cuda_time_ms(lambda: health_reduce(entries))
        plain_ms = cuda_graph_time_ms(lambda: reference_health_reduce(entries), iters=5, replays=2)
        log(f"[C] health_reduce {label} ({len(grads)} gradient tensors{' + parameters' if label == 'full' else ''}, "
            f"{nbytes / 1e6:.1f} MB fp32): the wrapper {ms:.4f} ms by CUDA-graph replay ({bound_ms / ms:.1%} of the "
            f"bound), eager {eager_ms:.4f} ms (CUDA events, the host's launch included), plain {plain_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms by {bound_by}")
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                   eager_ms=eager_ms)
        if label == "cheap":
            out["health_reduce"] = row
        else:
            out["health_reduce"].update({"full_" + k: v for k, v in row.items() if k != "library_ms"})
    health_reduce.launches = saved  # timing launches do not count
    return out


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
    ("xl_qkv_n4096", 4096, 1600, 4800, {}),  # phase M's GPT-2 1.5B microbatches
    ("xl_qkv_n16384", 16384, 1600, 4800, {}),
    ("decode_n4", 4, 768, 2304, {}),  # phase G's decode step (few_rows_n8: 8 rows)
    # A tp = 2 ring chunk of the fused QKV (phase N (g)): a rank's 1024 rows
    # against its 1152 output columns, a partial last column group.
    ("ring_chunk", 1024, 768, 1152, {}),
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
    ("xl_mlp_n4096", 4096, 6400, {}),  # phase M's GPT-2 1.5B microbatches
    ("xl_mlp_n16384", 16384, 6400, {}),
    ("decode_n4", 4, 3072, {}),  # phase G's decode step (few_rows_n8: 8 rows)
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
            if name in ("qkv_path", "ring_chunk") and dtype == torch.bfloat16:
                path_err["matmul_bias" + ("_ring_chunk" if name == "ring_chunk" else "")] = err
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

CP_B, CP_T, CP_N, CP_MB, CP_STEPS = 2, 4096, 2, 1, 2
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


def run_ranks(world, fn, *args, timeout=600, killed=()):
    """Run ``fn(rank, world, *args)`` in ``world`` processes started with
    the spawn method (a forked child must not inherit a CUDA context), each
    holding the launcher variables of one torch.distributed world
    (``LOCAL_RANK`` = rank); return the results by rank (None for the ranks
    in ``killed``, which must die by SIGKILL). Raises if a rank raised,
    died otherwise or did not exit."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, fn, args, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {r: None for r in killed}, []
    try:
        for _ in range(world - len(killed)):
            rank, res, err = queue.get(timeout=timeout)
            results[rank] = res
            if err:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for r, p in enumerate(procs):
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                errors.append(f"rank process {p.pid} did not exit")
            elif r in killed:
                if p.exitcode != -signal.SIGKILL:
                    errors.append(f"rank {r} (process {p.pid}) exited with {p.exitcode}, not by SIGKILL")
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
    cuda:0 and cuda:1 (NCCL; phase r, on a machine with two cards), train
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
    if device is not None:
        # rdp 2 x cp 2 on the same card, against the same cp = 1 losses.
        for k, n in _phase_rc(device, base_losses).items():
            launches[k] = launches.get(k, 0) + n
    return launches, dict(cp_ms=cp_ms, one_ms=one_ms, gap=worst, transport=transport)


W_STEPS, W_SAVE_AT, W_LOSS_TOL, W_SMALL_TOL = 6, 3, 1e-2, 1e-5
W_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_dp")
W_ENV = {"SMP_HEARTBEAT_INTERVAL": "0.1", "SMP_HEARTBEAT_MISS_BUDGET": "5", "SMP_COLLECTIVE_TIMEOUT": "60",
         "SMP_CKPT_COMMIT_TIMEOUT": "120"}


def _w_setup(device, small=False, init=True, resume=None):
    """Phase W's model (GPT-2 124M bf16, or the 2-layer fp32 model), AdamW and
    the loss-mode step (phase T's loss) through the public entry points; the
    weights from SEED, so every rank and the rdp = 1 run start equal.
    ``init=False`` keeps the live session (a recovery's), ``resume=(root,
    tag)`` resumes that checkpoint before the model is built."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_124m, init_gpt2_weights_

    if init:
        smp.init({"microbatches": TRAIN_MB, "bf16": not small, "ddp": True}, device=device)
    if resume is not None:
        smp.resume_from_checkpoint(*resume)  # applied when the model and optimizer are built
    if small:
        module = init_gpt2_weights_(gpt2("gpt2_124m", max_len=128, d_model=128, n_layers=2, n_heads=4),
                                    torch.Generator().manual_seed(SEED)).to(device)
    else:
        module = init_gpt2_weights_(gpt2_124m(device=device), torch.Generator(device=device).manual_seed(SEED))
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


def _w_batch(device, small=False):
    """The global batch (phase T's, 8 x 1024; the small model's 8 x 128)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    return torch.randint(0, 50257, (TRAIN_BATCH, 128 if small else TRAIN_SEQ), generator=g).to(device)


def _w_rows(ids):
    """This rank's rows of the global batch at the live rdp (the per-process
    contract of ``shard_batches``)."""
    import smdistributed_modelparallel_tpu_torch as smp

    r, n = (smp.rdp_rank(), smp.rdp_size()) if smp.is_initialized() else (0, 1)
    per = ids.shape[0] // n
    return ids[r * per:(r + 1) * per]


def _w_fingerprint(model, skip=frozenset()):
    """Two int64 sums of the parameters' bit patterns (plain and position
    weighted), those named in ``skip`` left out: equal on two replicas whose
    bits agree."""
    plain = torch.zeros((), dtype=torch.int64, device=next(model.module.parameters()).device)
    weighted = plain.clone()
    for name, p in model.module.named_parameters():
        if name in skip:
            continue
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        plain += bits.sum()
        weighted += (bits * (torch.arange(bits.numel(), device=bits.device) % 65521 + 1)).sum()
    return int(plain), int(weighted)


def _w_steps(model, optimizer, train_step, ids, steps, prints=None, counters=None, ms=None):
    losses = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(model, _w_rows(ids)).reduce_mean()))
        optimizer.step()
        torch.cuda.synchronize()
        if ms is not None:
            ms.append((time.perf_counter() - t0) * 1e3)
        if prints is not None:
            prints.append(_w_fingerprint(model))
    return losses


def _w_control_plane(rank, world):
    """Hold (a): the bus, ordered P2P, a 1 MB broadcast, allgather, the
    barriers and the rank queries; time a small round trip and the
    broadcast."""
    import hashlib

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend import native
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    peer = 1 - rank
    out = {"bus": state.bus is not None and state.bus.world == world, "lib": str(native.LIB_PATH),
           "lib_built": native.LIB_PATH.exists() and native.LIB_PATH.parent.name == "_build"}
    for i in range(5):
        smp.send(("seq", rank, i), dest=peer)
    out["ordered"] = [smp.recv_from(peer) for _ in range(5)] == [("seq", peer, i) for i in range(5)]
    smp.barrier()
    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        if rank == 0:
            smp.send(i, dest=1)
            assert smp.recv_from(1) == i
        else:
            smp.send(smp.recv_from(0), dest=0)
    out["round_trip_us"] = (time.perf_counter() - t0) * 1e6 / n
    blob = os.urandom(1 << 20) if rank == 0 else None
    smp.barrier()
    t0 = time.perf_counter()
    got = smp.broadcast(blob, src=0)
    out["broadcast_ms"] = (time.perf_counter() - t0) * 1e3
    out["broadcast_ok"] = smp.allgather(hashlib.sha256(got).hexdigest())[0] == hashlib.sha256(got).hexdigest()
    out["allgather"] = smp.allgather(f"proc{rank}") == ["proc0", "proc1"]
    for barrier in (smp.barrier, smp.dp_barrier, smp.rdp_barrier):
        barrier()
    out["queries"] = (smp.rank(), smp.size(), smp.rdp_rank(), smp.rdp_size(), smp.dp_rank(), smp.dp_size(),
                      smp.get_rdp_group(), smp.get_dp_group(), smp.rdp_rank_to_rank(1 - rank), smp.tp_size(),
                      smp.pp_size(), dict(smp.get_mesh().shape))
    return out


def _w_train(model, optimizer, train_step, root=None):
    """Hold (b) on this rank: 6 steps at rdp = 2 (with (c)'s checkpoint
    after step 3 when ``root`` is given), the flash launches, the replicas'
    fingerprints after every step and their bits at the end, and the
    gradient all-reduce alone."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    out = {}
    ids = _w_batch(state.device)
    counters = {**_flash_counters(), **_flash_simt_counters()}
    for fn in counters.values():
        fn.launches = 0
    prints, ms = [], []
    losses = _w_steps(model, optimizer, train_step, ids, W_SAVE_AT, prints, ms=ms)
    if root is not None:
        smp.barrier()
        t0 = time.perf_counter()
        smp.save_checkpoint(root, tag="w3", partial=True)
        smp.barrier()
        out["save_s"] = time.perf_counter() - t0
    out["print_at_save"] = prints[-1]
    losses += _w_steps(model, optimizer, train_step, ids, W_STEPS - W_SAVE_AT, prints, ms=ms)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out.update(losses=losses, prints=prints, ms=ms)
    # The replicas' parameters, bit for bit, once at the end: rank 0's
    # broadcast against this rank's own.
    group = state.group("rdp")
    flat = torch.cat([p.detach().reshape(-1).float() for p in model.module.parameters()])
    theirs = group.broadcast(flat.clone(), src=0)
    out["bit_equal"] = bool(torch.equal(flat.view(torch.int32), theirs.view(torch.int32)))
    # The gradient all-reduce alone: the step's flat fp32 buffer.
    grads = torch.zeros(flat.numel(), device=state.device)
    del flat, theirs
    group.all_reduce(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        group.all_reduce(grads)
    torch.cuda.synchronize()
    out.update(all_reduce_ms=(time.perf_counter() - t0) * 1e3 / 3, n_params=grads.numel(), transport=group.transport)
    return out


def _w_rank_y(rank, world):
    """Phase Y's rank: hold (b) on cuda:<rank> (named, so that the weights
    come from a CUDA generator as the rdp = 1 run's do)."""
    model, optimizer, train_step = _w_setup(f"cuda:{rank}")
    return _w_train(model, optimizer, train_step)


def _w_world1(rank, world, device, root):
    """Holds (a)-(f) in one two-rank world: the control plane, 6 steps at
    rdp = 2 with the fleet plane on and a checkpoint after step 3, the
    all-reduce's time, the small fp32 model, the preemption run, the exit
    relay."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend import core
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.resilience.preemption import preemption
    from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    os.environ.update(W_ENV, SMP_FLEET_INTERVAL="0.5")
    model, optimizer, train_step = _w_setup(device)
    out = {"control": _w_control_plane(rank, world)}
    out.update(_w_train(model, optimizer, train_step, root))
    ids = _w_batch(state.device)
    del model, optimizer
    # (e) The fleet plane: rank 0 aggregates both registries.
    totals = smp.allgather(_w_counter(telemetry.report(), "smp_step_total"))
    merged = None
    if rank == 0:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            merged = _w_counter(fleet.plane.fleet_report()["merged"], "smp_step_total")
            if merged == sum(totals):
                break
            time.sleep(0.1)
    out["fleet"] = (merged, totals)
    smp.barrier()
    # The small fp32 model at rdp = 2: 3 steps on the card, then the same on the CPU.
    small = {}
    for dev in (device, "cpu"):
        m, opt, step_fn = _w_setup(dev, small=True)
        small[dev] = _w_steps(m, opt, step_fn, _w_batch(dev, small=True), 3)
        del m, opt
    out["small"] = (small[device], small["cpu"])
    torch.cuda.empty_cache()
    # (d) SIGTERM to rank 1 at step edge 3: both ranks save and exit.
    os.environ.update(SMP_CHAOS=f"sigterm@step={W_SAVE_AT}:rank=1", SMP_EMERGENCY_CKPT_PATH=root)
    model, optimizer, train_step = _w_setup(device)
    try:
        _w_steps(model, optimizer, train_step, ids, W_STEPS)
        out["preempt"] = None
    except SystemExit as e:
        out["preempt"] = (e.code, preemption._requested, preemption.emergency_saved, state.step_count)
    os.environ.pop("SMP_CHAOS")
    del model, optimizer
    # (f) The exit relay at shutdown.
    smp.shutdown()
    out["exit_report"] = core.last_exit_report
    return out


def _w_counter(report, name):
    fam = report.get("metrics", {}).get(name, {"series": []})
    return sum(s.get("value", 0) for s in fam["series"])


def _w_world2(rank, world, device, root, kill_root):
    """A fresh two-rank world: (c) the resume of "w3" and (d) of
    "preempt_step_3", then (g) the supervised kill of rank 1."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    os.environ.update(W_ENV)
    out = {}
    ids = _w_batch(device)
    for tag, steps in (("w3", W_STEPS - W_SAVE_AT), (f"preempt_step_{W_SAVE_AT}", 3)):
        t0 = time.perf_counter()
        model, optimizer, train_step = _w_setup(device, resume=(root, tag))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        out[tag] = (_w_steps(model, optimizer, train_step, _w_batch(state.device), steps), restore_s)
        del model, optimizer
        smp.reset()
    torch.cuda.empty_cache()
    # (g) SMP_SUPERVISOR=on; two heartbeats of rank 1 dropped (below the
    # budget of 5), then rank 1 SIGKILLed at step edge 3.
    os.environ.update(SMP_SUPERVISOR="on", SMP_CHAOS=f"heartbeat_drop@count=2:rank=1,kill@step={W_SAVE_AT}:rank=1")
    model, optimizer, train_step = _w_setup(device)
    losses, replay, report, t_error = {}, {}, None, None
    while state.step_count < W_STEPS:
        sc = state.step_count
        try:
            loss = float(train_step(model, _w_rows(ids)).reduce_mean())
            optimizer.step()
        except Exception as e:
            if report is not None:
                raise
            t_error = time.monotonic()
            out["error"] = type(e).__name__
            report = smp.supervisor.recover(error=e, ckpt_path=kill_root, grace=60)
            del model, optimizer
            model, optimizer, train_step = _w_setup(device, init=False)  # the recovery's session and state
            continue
        (replay if report else losses)[sc] = loss
        if report is None and sc <= 1:
            smp.save_checkpoint(kill_root, partial=True, blocking=True)
    rep = telemetry.report()["metrics"]
    out.update(losses=losses, replay=replay, t_error=t_error, world_after=(smp.size(), smp.rdp_size()),
               report={k: v for k, v in report.items() if k != "phases"},
               phases=dict(smp.supervisor.last_report["phases"]),
               mttr=rep["smp_recovery_seconds"]["series"][0]["value"],
               kinds={s["labels"]["kind"]: s["value"] for s in rep["smp_failures_detected_total"]["series"]})
    os.environ.pop("SMP_CHAOS")
    smp.shutdown()
    return out


def _w_rdp1():
    """This process's rdp = 1 run of phase W's weights and global batch:
    (losses, ms a step, launches)."""
    import smdistributed_modelparallel_tpu_torch as smp

    model, optimizer, train_step = _w_setup("cuda")
    counters = {**_flash_counters(), **_flash_simt_counters()}
    for fn in counters.values():
        fn.launches = 0
    ms = []
    losses = _w_steps(model, optimizer, train_step, _w_batch("cuda"), W_STEPS, ms=ms)
    launches = {k: fn.launches for k, fn in counters.items()}
    del model, optimizer
    smp.reset()
    return losses, ms, launches


def phase_y():
    """Hold (b) of phase W with the two ranks on cuda:0 and cuda:1 (the
    gradient all-reduce over NCCL; a machine with two cards)."""
    if torch.cuda.device_count() < 2:
        raise RuntimeError(f"rdp ranks on separate cards need 2 cards, found {torch.cuda.device_count()}")
    ranks = run_ranks(2, _w_rank_y)
    base, base_ms, _ = _w_rdp1()
    l0, l1 = ranks[0]["losses"], ranks[1]["losses"]
    gap = max(abs(a - b) for a, b in zip(l0, base))
    ms = sum(ranks[0]["ms"][1:]) / (W_STEPS - 1)
    one_ms = sum(base_ms[1:]) / (W_STEPS - 1)
    log(f"[Y] rdp = 2 on cuda:0-1, all-reduce transport {ranks[0]['transport']}: losses {l0}, rdp = 1 {base}, largest "
        f"difference {gap:.3e}; ms/step {ms:.2f} (rdp = 1 {one_ms:.2f}), global tokens/s "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f}; the gradient all-reduce alone {ranks[0]['all_reduce_ms']:.2f} ms; "
        f"fingerprints equal every step {ranks[0]['prints'] == ranks[1]['prints']}, bits equal at the end "
        f"{ranks[0]['bit_equal'] and ranks[1]['bit_equal']}; launches {ranks[0]['launches']}")
    if l0 != l1 or ranks[0]["prints"] != ranks[1]["prints"] or not (ranks[0]["bit_equal"] and ranks[1]["bit_equal"]):
        raise RuntimeError("phase Y: the replicas differ")
    if gap > W_LOSS_TOL:
        raise RuntimeError(f"phase Y: rdp = 2 losses differ from rdp = 1 by {gap:.3e}")


def phase_w(device="cuda:0"):
    """Data parallelism at rdp = 2: two ranks on ``device`` (gloo with
    pinned host copies). Holds (a)-(g) of the data-parallel slice against
    this process's rdp = 1 run of the same weights and global batch."""
    import shutil

    import smdistributed_modelparallel_tpu_torch as smp

    shutil.rmtree(W_DIR, ignore_errors=True)
    root, kill_root = os.path.join(W_DIR, "ckpt"), os.path.join(W_DIR, "kill")
    try:
        t0 = time.perf_counter()
        r1 = run_ranks(2, _w_world1, device, root)
        world1_s = time.perf_counter() - t0
        # This process: rdp = 1 on the same weights and the whole batch.
        base, base_ms, base_launches = _w_rdp1()
        # The one-process elastic resume of the rdp = 2 checkpoint.
        t1 = time.perf_counter()
        model, _, _ = _w_setup("cuda", resume=(root, "w3"))
        elastic = (_w_fingerprint(model), time.perf_counter() - t1)
        del model
        smp.reset()
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(os.path.join(root, "w3_partial"))
                         for f in fs)
        t0 = time.perf_counter()
        r2 = run_ranks(2, _w_world2, device, root, kill_root, killed=(1,))
        world2_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(W_DIR, ignore_errors=True)
    return _w_report(r1, r2, base, base_ms, base_launches, elastic, ckpt_bytes, world1_s, world2_s, device)


def _w_report(r1, r2, base, base_ms, base_launches, elastic, ckpt_bytes, world1_s, world2_s, device):
    """Print phase W's numbers and raise on every hold that fails."""
    failures = []

    def hold(ok, what):
        if not ok:
            failures.append(what)

    n_layers, per_step = 12, 12 * TRAIN_MB
    where = f"2 ranks on {device}"
    c0, c1 = r1[0]["control"], r1[1]["control"]
    log(f"[W] GPT-2 124M bf16 at rdp = 2, {where}, global batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} "
        f"microbatches ({TRAIN_BATCH // 2} x {TRAIN_SEQ} a rank, 1 x {TRAIN_SEQ} a microbatch), AdamW; "
        f"world 1 took {world1_s:.1f} s, world 2 {world2_s:.1f} s with start-up")
    # (a)
    for rank, c in enumerate((c0, c1)):
        hold(c["bus"] and c["lib_built"], f"(a) rank {rank}: the bus is not up from _build/ ({c['lib']})")
        hold(c["ordered"] and c["broadcast_ok"] and c["allgather"], f"(a) rank {rank}: the control plane")
        want = (rank, 2, rank, 2, rank, 2, [0, 1], [0, 1], 1 - rank, 1, 1,
                {"rdp": 2, "ep": 1, "cp": 1, "pp": 1, "tp": 1})
        hold(c["queries"] == want, f"(a) rank {rank}: rank queries {c['queries']} != {want}")
    log(f"[W] (a) control plane: bus from {c0['lib']}; small-object round trip {c0['round_trip_us']:.1f} us "
        f"(smp.send/recv_from, 200 pings), 1 MB smp.broadcast {c0['broadcast_ms']:.2f} ms (rank 0) / "
        f"{c1['broadcast_ms']:.2f} ms (rank 1); ordered P2P, allgather, barrier/dp_barrier/rdp_barrier, rank "
        f"queries {c0['queries']}")
    # (b)
    l0, l1 = r1[0]["losses"], r1[1]["losses"]
    gap = max(abs(a - b) for a, b in zip(l0, base))
    hold(l0 == l1, "(b) the ranks' losses differ")
    hold(r1[0]["prints"] == r1[1]["prints"], "(b) the replicas' parameter fingerprints differ after some step")
    hold(r1[0]["bit_equal"] and r1[1]["bit_equal"], "(b) the replicas' parameters are not bit-equal at the end")
    hold(gap <= W_LOSS_TOL and all(math.isfinite(x) for x in base), f"(b) losses differ from rdp = 1 by {gap:.3e}")
    for rank in range(2):
        counts = r1[rank]["launches"]
        for k in _flash_counters():
            hold(counts[k] == per_step * W_STEPS,
                 f"(b) rank {rank}: {k} launched {counts[k]} times in {W_STEPS} steps, expected {per_step * W_STEPS}")
        simt = {k: n for k, n in counts.items() if k.endswith("_simt") and n}
        hold(not simt, f"(b) rank {rank}: CUDA-core launches {simt}")
    ms = sum(r1[0]["ms"][1:]) / (W_STEPS - 1)
    one_ms = sum(base_ms[1:]) / (W_STEPS - 1)
    small_card, small_cpu = r1[0]["small"]
    small_gap = max(abs(a - b) for a, b in zip(small_card, small_cpu))
    hold(small_gap <= W_SMALL_TOL, f"(b) the small fp32 model at rdp = 2: card vs CPU {small_gap:.3e}")
    log(f"[W] (b) rdp = 2 losses {l0}; rdp = 1 {base}; largest difference {gap:.3e} (limit {W_LOSS_TOL:.0e}); "
        f"parameter fingerprints equal on both ranks after every step: {r1[0]['prints'] == r1[1]['prints']}; "
        f"bit-equal at the end: {r1[0]['bit_equal'] and r1[1]['bit_equal']}")
    log(f"[W] (b) ms/step (mean of steps 2-{W_STEPS}): rdp = 2 {ms:.2f} (rank 0; per step {[round(x, 2) for x in r1[0]['ms']]}), "
        f"rdp = 1 {one_ms:.2f}; global tokens/s rdp = 2 {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f}, rdp = 1 "
        f"{TRAIN_BATCH * TRAIN_SEQ / one_ms * 1e3:.1f}; the gradient all-reduce alone ({r1[0]['n_params']} fp32, "
        f"{r1[0]['n_params'] * 4 / 1e6:.1f} MB, gloo over pinned host copies) {r1[0]['all_reduce_ms']:.2f} ms "
        f"(rank 0) / {r1[1]['all_reduce_ms']:.2f} ms (rank 1)")
    log(f"[W] (b) launches a rank: {r1[0]['launches']} / {r1[1]['launches']} in {W_STEPS} steps (expected "
        f"{per_step} each a step: {n_layers} layers x {TRAIN_MB} microbatches); rdp = 1 {base_launches}")
    log(f"[W] (b) fp32 2-layer model at rdp = 2, 3 steps: card {small_card}, CPU {small_cpu}, largest difference "
        f"{small_gap:.3e} (limit {W_SMALL_TOL:.0e})")
    # (c)
    resumed, restore_s = r2[0]["w3"]
    hold(resumed == l0[W_SAVE_AT:], f"(c) the resumed losses {resumed} != {l0[W_SAVE_AT:]}")
    hold(elastic[0] == r1[0]["print_at_save"], "(c) the one-process elastic resume's parameters differ")
    log(f"[W] (c) checkpoint after step {W_SAVE_AT}: {ckpt_bytes / 1e9:.3f} GB (parameters and AdamW moments, fp32, "
        f"replica 0's shards), save {r1[0]['save_s']:.2f} s; a fresh two-rank world restores it in {restore_s:.2f} s "
        f"and repeats steps {W_SAVE_AT + 1}-{W_STEPS} bit for bit ({resumed}); the one-process elastic resume "
        f"(rdp = 1) in {elastic[1]:.2f} s, parameter fingerprint equal: {elastic[0] == r1[0]['print_at_save']}")
    # (d)
    p0, p1 = r1[0]["preempt"], r1[1]["preempt"]
    tag = f"preempt_step_{W_SAVE_AT}"
    for rank, p in enumerate((p0, p1)):
        hold(p is not None and p[0] in (0, None) and p[2] is not None and p[2][1] == tag and p[3] == W_SAVE_AT,
             f"(d) rank {rank}: {p}")
    hold(p0 is not None and p0[1] == "peer_notice" and p1 is not None and p1[1] == "sigterm",
         f"(d) reasons {p0 and p0[1]}, {p1 and p1[1]}")
    pre = r2[0][tag][0]
    hold(pre == l0[W_SAVE_AT - 1:W_SAVE_AT + 2], f"(d) the resumed losses {pre} != {l0[W_SAVE_AT - 1:W_SAVE_AT + 2]}")
    log(f"[W] (d) SIGTERM to rank 1 at step edge {W_SAVE_AT}: rank 0 {p0}, rank 1 {p1} (exit code, reason, "
        f"checkpoint, step edge); the resume repeats (b)'s steps {W_SAVE_AT}-{W_SAVE_AT + 2} bit for bit: {pre}")
    # (e)
    merged, totals = r1[0]["fleet"]
    hold(merged == sum(totals), f"(e) the fleet's smp_step_total {merged} != the ranks' {totals}")
    log(f"[W] (e) fleet plane: rank 0's merged smp_step_total {merged}, the ranks' registries {totals}")
    # (f)
    hold(r1[0]["exit_report"] == {"failed": [], "silent": []}, f"(f) exit relay {r1[0]['exit_report']}")
    log(f"[W] (f) smp.shutdown's exit relay at rank 0: {r1[0]['exit_report']}")
    # (g)
    g = r2[0]
    det = g["report"]["t_detect"]  # when the detector classified rank 1 (monotonic clock)
    hold(g["error"] == "SMPPeerLost", f"(g) rank 0 caught {g['error']}")
    hold(g["report"]["failures"] == {1: "dead"} and g["report"]["survivors"] == 1 and g["report"]["tag"] == "step_2",
         f"(g) report {g['report']}")
    hold(g["kinds"] == {"dead": 1}, f"(g) classifications {g['kinds']}: the dropped heartbeats classified something")
    budget_s = float(W_ENV["SMP_HEARTBEAT_INTERVAL"]) * float(W_ENV["SMP_HEARTBEAT_MISS_BUDGET"])
    hold(det - g["t_error"] <= budget_s + 1.0,
         f"(g) rank 1 classified dead at {det} against the failure at {g['t_error']}")
    hold(g["world_after"] == (1, 1) and {3, 4, 5} <= set(g["replay"]), f"(g) {g['world_after']} {g['replay']}")
    g_gap = max(abs(v - base[k]) for k, v in g["replay"].items())
    hold(g_gap <= W_LOSS_TOL, f"(g) the re-formed run's losses differ from rdp = 1 by {g_gap:.3e}")
    log(f"[W] (g) supervised kill of rank 1 at step edge {W_SAVE_AT}: rank 0 caught {g['error']}, classified "
        f"{g['report']['failures']} {det - g['t_error']:+.3f} s from it (budget "
        f"{budget_s:.1f} s), agreed on {g['report']['tag']}, re-formed a world of {g['world_after'][0]}; MTTR "
        f"{g['mttr']:.2f} s, phases { {k: round(v, 3) for k, v in g['phases'].items()} }; losses before {g['losses']}, "
        f"after {g['replay']} (rdp = 1 {base}; largest difference {g_gap:.3e}); classifications {g['kinds']}")
    if failures:
        raise RuntimeError("phase W: " + "; ".join(failures))
    launches = dict(base_launches)
    for rank in range(2):
        for k, n in r1[rank]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches, dict(ms=ms, one_ms=one_ms, all_reduce_ms=r1[0]["all_reduce_ms"],
                          round_trip_us=c0["round_trip_us"], broadcast_ms=c0["broadcast_ms"],
                          save_s=r1[0]["save_s"], restore_s=restore_s, mttr=g["mttr"])


# ----------------------------------------------------------------------
# Phase U: expert parallelism at ep = 2, two ranks on one card
# ----------------------------------------------------------------------

# E3's MoE model (GPT-2 124M widths, 4 experts, top-2, capacity 1.25), bf16,
# fused_qkv, 8 x 1024 tokens in 4 microbatches, AdamW; losses against ep = 1
# on the same weights and global batch. The small fp32 model runs 2 layers
# with capacity 0.5 (assignments drop) on the card and the CPU.
U_STEPS, U_LOSS_TOL, U_SMALL_TOL = 2, 1e-2, 1e-5
U_SMALL = dict(E_MOE_SMALL, moe_capacity_factor=0.5)
U_SMALL_B, U_SMALL_T, U_SMALL_MB, U_SMALL_STEPS = 8, 32, 2, 2


def _u_rows(n_rows, ep, microbatches):
    """The ep = 1 batch laid out so that its microbatch m holds the rows the
    ep ranks' microbatch m holds (rank r's rows are [r*B/ep, (r+1)*B/ep) of
    the stream; the JAX package's microbatch-major grouping)."""
    b = n_rows // (ep * microbatches)
    return [r * (n_rows // ep) + m * b + i for m in range(microbatches) for r in range(ep) for i in range(b)]


def _u_setup(cfg, device, ep, bf16, microbatches=TRAIN_MB, init_device=None):
    """``smp.init`` at ``ep``, the MoE LM head from SEED (E3's init, drawn
    whole on ``init_device``, by default ``device``: an ep rank keeps its
    experts) and E3's AdamW and step."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    smp.init({"microbatches": microbatches, "bf16": bf16, "fused_qkv": True, "ddp": True,
              "expert_parallel_degree": ep}, device=device)
    init_device = init_device or device
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**cfg, device=init_device), cfg["initializer_range"],
                         torch.Generator(device=torch.device(init_device).type).manual_seed(SEED))
    return _lm_train(init, device)


def _u_train(cfg, device, ep, ids, steps, counters):
    """``steps`` bf16 steps on ``ids`` (this rank's rows): losses, ms a step,
    dense fingerprints a step, launches, peak GiB, the host ms of the MoE
    exchanges and of the gradient all-reduce a step."""
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.backend.topology import DATA_AXES

    model, optimizer, train_step = _u_setup(cfg, device, ep, True)
    spent = {"exchange": 0.0, "all_reduce": 0.0, "exchanges": 0}

    def timed(group, name, key):
        if group is None:
            return
        real = getattr(group, name)

        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                spent[key] += (time.perf_counter() - t0) * 1e3
                spent["exchanges"] += key == "exchange"

        setattr(group, name, call)

    timed(state.group("ep"), "all_to_all", "exchange")
    timed(state.group(DATA_AXES), "all_reduce", "all_reduce")
    _e_zero(counters)
    torch.cuda.reset_peak_memory_stats(device)
    losses, ms, prints, per_step = [], [], [], []
    for _ in range(steps):
        torch.cuda.synchronize(device)
        before = dict(spent)
        t0 = time.perf_counter()
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: spent[k] - before[k] for k in spent})
        prints.append(_w_fingerprint(model, skip=model._expert_params))
    out = dict(losses=losses, ms=ms, prints=prints, exchanges=per_step,
               launches={k: fn.launches for k, fn in counters.items()},
               peak=torch.cuda.max_memory_allocated(device) / 2**30)
    return out, model


def _u_small(rank, world, device):
    """The small fp32 MoE at ep = ``world``, weights drawn on the CPU: the
    losses and the first step's MoE gradients on ``device``, then on the
    CPU."""
    import smdistributed_modelparallel_tpu_torch as smp

    g = torch.Generator().manual_seed(SEED + 3)
    ids = torch.randint(0, U_SMALL["vocab_size"], (U_SMALL_B, U_SMALL_T), generator=g)
    per = U_SMALL_B // world
    out = {}
    for dev in (device, "cpu"):
        model, optimizer, train_step = _u_setup(U_SMALL, dev, world, False, U_SMALL_MB, init_device="cpu")
        mine = ids[rank * per:(rank + 1) * per].to(dev)
        losses, grads = [], None
        for _ in range(U_SMALL_STEPS):
            losses.append(float(train_step(model, mine).reduce_mean()))
            if grads is None:  # numpy: a tensor in a rank's result would be shared by a file descriptor
                grads = {n: g.detach().float().cpu().numpy() for n, g in model.grads.items() if "output" in n}
            optimizer.step()
        out[dev] = (losses, grads)
        del model, optimizer
        smp.reset()
    return out["cpu"], out[device]


def _u_rank(rank, world, device, small=True):
    """One ep rank on ``device`` (None: cuda:LOCAL_RANK): the MoE model's
    steps on its rows, then the small fp32 model on the card and the CPU."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state

    device = device or f"cuda:{rank}"
    ids = _w_batch("cpu")
    rows = ids[rank * TRAIN_BATCH // world:(rank + 1) * TRAIN_BATCH // world].to(device)
    counters = {**_flash_counters(), "matmul_bias": _new_counters()["matmul_bias"], **_simt_counters()}
    out, model = _u_train(E_MOE_CFG, device, world, rows, U_STEPS, counters)
    out["transport"] = state.group("ep").transport
    out["experts"] = next(m.expert_range for m in model.module.modules() if hasattr(m, "expert_range"))
    del model
    smp.reset()
    torch.cuda.empty_cache()
    if small:
        out["small"] = _u_small(rank, world, device)
    return out


def _u_base():
    """ep = 1 in this process: the same weights, the global batch in the ep
    ranks' microbatch grouping."""
    import smdistributed_modelparallel_tpu_torch as smp

    ids = _w_batch("cpu")[_u_rows(TRAIN_BATCH, 2, TRAIN_MB)].to("cuda")
    counters = {**_flash_counters(), "matmul_bias": _new_counters()["matmul_bias"], **_simt_counters()}
    out, model = _u_train(E_MOE_CFG, "cuda", 1, ids, U_STEPS, counters)
    del model
    smp.reset()
    torch.cuda.empty_cache()
    return out


def phase_u(device="cuda:0"):
    """Expert parallelism at ep = 2: two ranks on ``device`` (gloo with
    pinned host copies), E3's MoE model against ep = 1 in this process."""
    t0 = time.perf_counter()
    ranks = run_ranks(2, _u_rank, device)
    ranks_s = time.perf_counter() - t0
    base = _u_base()
    failures = []
    per = LM_CFG["num_layers"] * TRAIN_MB * U_STEPS
    want = {k: per for k in (*_flash_counters(), "matmul_bias")}
    log(f"[U] GPT-2 124M widths with 4 experts a layer (top-2, capacity 1.25), bf16, fused_qkv, ep = 2: 2 ranks on "
        f"{device}, transport {ranks[0]['transport']} (host copies of CUDA tensors); global batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_MB} microbatches ({TRAIN_BATCH // 2} rows a rank), AdamW; ranks took {ranks_s:.1f} s "
        f"with start-up; experts a rank {[r['experts'] for r in ranks]}")
    gap = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], base["losses"]))
    for rank, r in enumerate(ranks):
        ms = sum(r["ms"][1:]) / (U_STEPS - 1)
        ex = sum(s["exchange"] for s in r["exchanges"][1:]) / (U_STEPS - 1)
        ar = sum(s["all_reduce"] for s in r["exchanges"][1:]) / (U_STEPS - 1)
        log(f"[U] rank {rank}: losses {r['losses']}; ms/step {ms:.2f} (steps 2-{U_STEPS}; per step "
            f"{[round(x, 2) for x in r['ms']]}), global tokens/s {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f}; the MoE "
            f"all-to-alls {ex:.2f} ms a step (host wall, {r['exchanges'][-1]['exchanges']} a step), the data "
            f"group's all-reduces {ar:.2f} ms a step; peak {r['peak']:.2f} GiB; launches {r['launches']}")
        got = {k: r["launches"][k] for k in want}
        if got != want:
            failures.append(f"rank {rank} launches {got}, expected {want}")
        try:
            _check_route(f"[U] rank {rank}", r["launches"])
        except RuntimeError as e:
            failures.append(str(e))
    base_ms = sum(base["ms"][1:]) / (U_STEPS - 1)
    log(f"[U] ep = 1 in one process: losses {base['losses']}; ms/step {base_ms:.2f}, tokens/s "
        f"{TRAIN_BATCH * TRAIN_SEQ / base_ms * 1e3:.1f}; peak {base['peak']:.2f} GiB; largest loss difference "
        f"{gap:.3e} (limit {U_LOSS_TOL})")
    if not gap <= U_LOSS_TOL or not all(math.isfinite(x) for x in base["losses"]):
        failures.append(f"ep = 2 losses differ from ep = 1 by {gap:.3e}")
    same = ranks[0]["prints"] == ranks[1]["prints"] and ranks[0]["losses"] == ranks[1]["losses"]
    log(f"[U] dense parameters bit-equal across the ranks after every step: {same}")
    if not same:
        failures.append("the dense parameters differ across the ep ranks")
    for rank, r in enumerate(ranks):
        cpu, card = r["small"]
        lerr = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
        gerr = max(float(np.abs(card[1][n] - cpu[1][n]).max() / max(np.abs(cpu[1][n]).max(), 1e-12))
                   for n in cpu[1])
        log(f"[U] rank {rank} small fp32 MoE (2 layers, capacity 0.5) at ep = 2, card vs CPU: losses {card[0]} vs "
            f"{cpu[0]}, largest difference {lerr:.3e}; the MoE gradients' largest difference {gerr:.3e} of their "
            f"largest value (limit {U_SMALL_TOL})")
        if not (lerr <= U_SMALL_TOL and gerr <= U_SMALL_TOL):
            failures.append(f"rank {rank}: the small fp32 MoE on the card disagrees with the CPU")
    if failures:
        raise RuntimeError("phase U: " + "; ".join(failures))
    launches = {k: base["launches"][k] + sum(r["launches"][k] for r in ranks) for k in base["launches"]}
    return launches, dict(ms=sum(ranks[0]["ms"][1:]) / (U_STEPS - 1), base_ms=base_ms, gap=gap)


def _u_rank_z(rank, world):
    return _u_rank(rank, world, None, small=False)


def phase_z():
    """Hold (a) of phase U with the two ep ranks on cuda:0 and cuda:1 (the
    exchanges over NCCL; a machine with two cards)."""
    if torch.cuda.device_count() < 2:
        raise RuntimeError(f"ep ranks on separate cards need 2 cards, found {torch.cuda.device_count()}")
    ranks = run_ranks(2, _u_rank_z)
    base = _u_base()
    gap = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], base["losses"]))
    ms = sum(ranks[0]["ms"][1:]) / (U_STEPS - 1)
    ex = sum(s["exchange"] for s in ranks[0]["exchanges"][1:]) / (U_STEPS - 1)
    log(f"[Z] ep = 2 on cuda:0-1, transport {ranks[0]['transport']}: losses {ranks[0]['losses']}, ep = 1 "
        f"{base['losses']}, largest difference {gap:.3e}; ms/step {ms:.2f}, global tokens/s "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f}; the MoE all-to-alls {ex:.2f} ms a step; dense parameters "
        f"bit-equal {ranks[0]['prints'] == ranks[1]['prints']}")
    if gap > U_LOSS_TOL or ranks[0]["prints"] != ranks[1]["prints"]:
        raise RuntimeError(f"phase Z: ep = 2 over NCCL differs (loss gap {gap:.3e})")


# ----------------------------------------------------------------------
# Phase N: tensor parallelism at tp = 2, two ranks on one card
# ----------------------------------------------------------------------

N_STEPS, N_SAVE_AT, N_LOSS_TOL, N_SMALL_TOL, N_CE_TOL = 3, 2, 1e-2, 1e-5, 1e-2
# (g)-(j): the training options at tp = 2. (g) the ring with the fused QKV;
# (h) GPT-2's dropouts 0.1; (i) checkpointing, whose losses must equal the
# same run's without it to N_CKPT_TOL; (j) fp16 (the loss scaler from
# N_FP16_SCALE, where GPT-2 124M's first steps do not overflow), fp8 (losses
# to phase Q's FP8_LOSS_TOL relative) and the sentinel. The fp8 amax history
# and the sentinel's maxima are bf16 activations' and gradients' maxima,
# held to N_STATE_TOL relative of tp = 1's (test_torch_fp8_step.py's bf16
# bound); the weights' amax slots of the first step and the counts exactly.
N_OPT_STEPS, N_FP16_SCALE, N_CKPT_TOL, N_STATE_TOL = 2, 2.0 ** 12, 1e-6, 5e-2
# (h)'s loss bound: 16x the 6.1e-05 that tp = 2 with the dropouts measured
# against tp = 1 on the H100. Attention dropout runs inside the flash
# kernels, whose masks the run cannot read, so (h) also holds the heads each
# rank hands them, and runs a control whose kernels hash the rank's local
# heads (both ranks then draw the same mask) to show what the bound sees.
N_DROP_TOL = 1e-3
N_CONTROLS = {"dropout_local_heads"}  # runs left out of the path's launches and of the cross-rank holds
N_RING = {"tp_overlap": "ring"}
N_DROP = dict(attention_dropout_prob=0.1, hidden_dropout_prob=0.1, embedding_dropout_prob=0.1)
N_CKPT = dict(activation_checkpointing=True)
# karpathy/nanoGPT's model.py pads GPT-2's vocabulary of 50257 up to 50304 (a
# multiple of 64), which tp = 2 divides: the vocab-parallel fused CE runs.
N_VOCAB = 50304
N_CE_SEQ = TRAIN_SEQ + 1  # rows of 1025 ids: 1024 inputs and their next tokens
N_SMALL = dict(G_SMALL, pre_layernorm=True, post_layernorm=False, final_layernorm=True)
N_SMALL_B, N_SMALL_T = 4, 64
N_GEN_SMALL = dict(n=3, lengths=(5, 24))  # the small fp32 model's padded prompts
N_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_tp")


def _n_init(device, layout="speed", microbatches=TRAIN_MB, bf16=True, **cfg):
    import smdistributed_modelparallel_tpu_torch as smp

    smp.init({"microbatches": microbatches, "bf16": bf16, "fused_qkv": True, "ddp": True, "optimize": layout,
              **cfg}, device=device)


def _n_module(cfg, device, seed=SEED, std=None, init_device=None):
    """The smp.nn head of ``cfg`` with ``fused_bias_gelu``, its weights drawn
    whole from ``seed`` on ``init_device`` (default ``device``): at tp = 2 a
    rank keeps its slices of the same draw."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    init_device = init_device or device
    module = smp.nn.DistributedTransformerLMHead(**cfg, fused_bias_gelu=True, device=init_device)
    return init_weights_(module, cfg.get("initializer_range", 0.02) if std is None else std,
                         torch.Generator(device=torch.device(init_device).type).manual_seed(seed))


def _n_counters():
    from smdistributed_modelparallel_tpu_torch.ops.health_reduce import health_reduce

    return {**_flash_counters(), **_new_counters(), **_simt_counters(), **_dropout_counters(), **_shard_counters(),
            **_fp8_counters(), "health_reduce": health_reduce}


def _mask_print(mask):
    """Two int64 sums of a keep mask (plain and position weighted): equal on
    two masks whose elements agree."""
    flat = mask.reshape(-1).to(torch.int64)
    return int(flat.sum()), int((flat * (torch.arange(flat.numel(), device=flat.device) % 65521 + 1)).sum())


class _Watched:
    """A wrapper called through ``watch(*its outputs)``; its attributes (the
    launch counts) are the wrapper's own."""

    def __init__(self, fn, watch):
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "watch", watch)

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.watch(*out)
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


def _n_train(device, ids, tp, layout="speed", steps=N_STEPS, root=None, head=None, env=None, scale=None,
             local_heads=False, **cfg):
    """``steps`` bf16 steps of phase L's model and step at ``tp`` on ``ids``
    (the whole batch on every tp rank), with ``head`` overrides, ``env`` and
    ``cfg``'s config keys: losses, ms a step, the replicated parameters'
    fingerprint a step, launches, peak GiB, the tp regions' host ms a step,
    the fp16 scale and overflow flags, the fp8 state and the sentinel's word
    after each step, the keep masks of the first step's first microbatch
    (``_mask_print`` of each ``dropout_fwd``) and the (head0, head_total,
    seed) its attention calls hand the flash kernels; a partial checkpoint
    under ``root`` after step N_SAVE_AT. ``scale``: the fp16 loss scaler's
    initial scale. ``local_heads``: the control of (h), the flash kernels
    handed no head0/head_total (they hash the rank's own heads)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.collectives import tp_comm_stats
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.fp16.loss_scaler import DynamicLossScaler
    from smdistributed_modelparallel_tpu_torch.ops import attention as attn_op
    from smdistributed_modelparallel_tpu_torch.ops import dropout as dr
    from smdistributed_modelparallel_tpu_torch.utils import health

    with _env(**(env or {})):
        _n_init(device, layout, tensor_parallel_degree=tp, **cfg)
        if scale is not None:
            state.loss_scaler = DynamicLossScaler(init_scale=scale)
        model, optimizer, train_step = _lm_train(_n_module(dict(LM_CFG, **(head or {})), device), device)
        counters = _n_counters()
        _e_zero(counters)
        masks, real_fwd, masks_done = [], dr.dropout_fwd, [False]

        def watch(y, mask):  # the first microbatch's masks (its launch counts as the path's)
            if model._bound is not None and len(masks) < DROP_SITES and not masks_done[0]:
                half = mask.shape[1] // 2  # a [B, T, D] mask's T halves: a tp = 2 rank's blocks
                masks.append((tuple(mask.shape), _mask_print(mask),
                              [_mask_print(mask[:, h * half:(h + 1) * half]) for h in range(2)]))

        heads, real_flash = [], attn_op.flash_attention

        def flash_spy(*args, **kw):  # the wrapper counts its launches itself
            if model._bound is not None and not masks_done[0] and len(heads) < LM_CFG["num_layers"]:
                seed = kw.get("seed")
                heads.append((kw.get("head0"), kw.get("head_total"), None if seed is None else int(seed)))
            if local_heads:
                kw.update(head0=None, head_total=None)
            return real_flash(*args, **kw)

        dr.dropout_fwd = _Watched(real_fwd, watch)
        attn_op.flash_attention = flash_spy
        out = dict(losses=[], ms=[], prints=[], comm=[], scale=[], finite=[], quant=[], health=[], peak=0.0,
                   step_peak=0.0)
        try:
            for step in range(steps):
                torch.cuda.synchronize(device)
                held = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                before = tp_comm_stats["seconds"]
                t0 = time.perf_counter()
                out["losses"].append(float(train_step(model, ids).reduce_mean()))
                # The step's own peak above what it found allocated (the
                # activations a checkpointed stack does not keep).
                out["step_peak"] = max(out["step_peak"], (torch.cuda.max_memory_allocated(device) - held) / 2**30)
                masks_done[0] = True
                out["finite"].append(model._grads_finite)
                optimizer.step()
                torch.cuda.synchronize(device)
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated(device) / 2**30)
                out["comm"].append((tp_comm_stats["seconds"] - before) * 1e3)
                out["prints"].append(_w_fingerprint(model, skip=model._tp_specs))
                if state.loss_scaler is not None:
                    out["scale"].append(state.loss_scaler.loss_scale)
                if state.quant_state is not None:
                    out["quant"].append(state.quant_state.state_dict())
                if health.mode() != "off":
                    health.monitor.flush()
                    out["health"].append(health.monitor.last_check["tags"])
                if root is not None and step + 1 == N_SAVE_AT:
                    smp.save_checkpoint(root, tag="n2")
                    smp.barrier()
        finally:
            dr.dropout_fwd = real_fwd
            attn_op.flash_attention = real_flash
        out.update(masks=masks, heads=heads, sequence_parallel=model._seq_parallel_ran,
                   transport=getattr(state.group("tp"), "transport", None),
                   launches={k: fn.launches for k, fn in counters.items()})
        del model, optimizer, train_step
        smp.reset()
    gc.collect()  # the model's reference cycles hold device tensors until a collection
    torch.cuda.empty_cache()
    return out


def _n_small(device):
    """(c) The 2-layer fp32 model at tp = 2 in both layouts, weights drawn
    on the CPU: 2 steps on ``device``, then on the CPU; the losses and the
    first step's gradients (this rank's shards)."""
    import smdistributed_modelparallel_tpu_torch as smp

    g = torch.Generator().manual_seed(SEED + 5)
    ids = torch.randint(0, N_SMALL["vocab_size"], (N_SMALL_B, N_SMALL_T), generator=g)
    out = {}
    for layout in ("speed", "memory"):
        for dev in (device, "cpu"):
            _n_init(dev, layout, microbatches=2, bf16=False, tensor_parallel_degree=2)
            model, optimizer, train_step = _lm_train(_n_module(N_SMALL, dev, init_device="cpu"), dev)
            losses, grads = [], None
            for _ in range(2):
                losses.append(float(train_step(model, ids.to(dev)).reduce_mean()))
                if grads is None:  # numpy: a tensor in a rank's result would be shared by a file descriptor
                    grads = {n: g_.detach().float().cpu().numpy() for n, g_ in model.grads.items()}
                optimizer.step()
            out[(layout, dev)] = (losses, grads)
            del model, optimizer
            smp.reset()
    return {layout: (out[(layout, device)], out[(layout, "cpu")]) for layout in ("speed", "memory")}


def _n_ce(device):
    """(d) The vocab-parallel fused CE: phase L's model at vocab 50304 in loss
    mode, 8 x 1024 tokens in one microbatch, ``fused_ce: True`` then
    ``False``: losses, ms a step (after the first), peak, launches."""
    import smdistributed_modelparallel_tpu_torch as smp

    g = torch.Generator().manual_seed(SEED + 6)
    ids = torch.randint(0, N_VOCAB, (TRAIN_BATCH, N_CE_SEQ), generator=g).to(device)
    cfg = dict(LM_CFG, vocab_size=N_VOCAB)
    out = {}
    for fused in (True, False):
        _n_init(device, microbatches=1, tensor_parallel_degree=2, fused_ce=fused)
        model = smp.DistributedModel(_n_module(cfg, device), device=device)
        optimizer = smp.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

        @smp.step
        def train_step(model, ids):
            loss = model(ids[:, :-1], targets=ids[:, 1:]).mean()
            model.backward(loss)
            return loss

        counters = {**_ce_counters(), **_ce_simt_counters()}
        _e_zero(counters)
        torch.cuda.reset_peak_memory_stats(device)
        losses, ms = [], []
        for _ in range(N_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            losses.append(float(train_step(model, ids).reduce_mean()))
            optimizer.step()
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[fused] = dict(losses=losses, ms=ms, launches={k: fn.launches for k, fn in counters.items()},
                          peak=torch.cuda.max_memory_allocated(device) / 2**30)
        del model, optimizer, train_step
        smp.reset()
        torch.cuda.empty_cache()
    return out


def _n_generate(device):
    """(e) ``smp.generate`` at tp = 2 on phase G1's padded batch (bf16, the
    fused knobs, 32 new tokens, greedy): the tokens, prefill ms, decode
    ms/token and launches; then the small fp32 model's padded greedy tokens
    on the card and on the CPU."""
    import smdistributed_modelparallel_tpu_torch as smp

    _n_init(device, tensor_parallel_degree=2)
    model = smp.DistributedModel(_n_module(LM_CFG, device), device=device)
    ids, mask, _ = g_prompts(LM_CFG["vocab_size"], device=device)
    smp.generate(model, ids, 2, attention_mask=mask)  # warm-up, not counted
    counters = _g_counters()
    _e_zero(counters)
    _, prefill_ms = _timed(lambda: smp.generate(model, ids, 1, attention_mask=mask))
    greedy, greedy_ms = _timed(lambda: smp.generate(model, ids, G_NEW, attention_mask=mask))
    out = dict(tokens=greedy.cpu().numpy(), prefill_ms=prefill_ms, decode_ms=(greedy_ms - prefill_ms) / (G_NEW - 1),
               launches=_g_launches(counters), heads=model.module.transformer.seq_layers[0].attention.tp_heads)
    del model
    smp.reset()
    torch.cuda.empty_cache()
    small = {}
    for dev in (device, "cpu"):
        _n_init(dev, bf16=False, tensor_parallel_degree=2)
        model = smp.DistributedModel(_n_module(N_SMALL, dev, std=0.5, init_device="cpu"), device=dev)
        sids, smask, _ = g_prompts(N_SMALL["vocab_size"], **N_GEN_SMALL, device=dev)
        small[dev] = smp.generate(model, sids, 12, attention_mask=smask).cpu().numpy()
        del model
        smp.reset()
    out["small"] = (small[device], small["cpu"])
    return out


def _n_options(device, ids, tp):
    """(g)-(j) at ``tp`` (at tp = 1 the yardsticks of (h) and (j)): (g) the
    ring with the fused QKV in both layouts; (h) dropouts 0.1 (the memory
    layout under the ring; at tp > 1 also its local-heads control); (i) checkpointing, with and without those
    dropouts; (j) fp16 beside the sentinel, and fp8."""
    out = {}
    if tp > 1:
        for layout in ("speed", "memory"):
            out["ring_" + layout] = _n_train(device, ids, tp, layout, N_OPT_STEPS, **N_RING)
    ring = N_RING if tp > 1 else {}
    out["dropout"] = _n_train(device, ids, tp, "memory", N_OPT_STEPS, head=N_DROP, **ring)
    if tp > 1:
        out["dropout_local_heads"] = _n_train(device, ids, tp, "memory", N_OPT_STEPS, head=N_DROP, local_heads=True,
                                              **ring)
        out["ckpt"] = _n_train(device, ids, tp, "speed", N_OPT_STEPS, head=N_CKPT)
        out["ckpt_dropout"] = _n_train(device, ids, tp, "memory", N_OPT_STEPS, head=dict(N_DROP, **N_CKPT), **ring)
    # fp16 beside the sentinel: one word a step feeds both the overflow flag
    # and the sentinel.
    out["fp16"] = _n_train(device, ids, tp, "speed", N_OPT_STEPS, env={"SMP_HEALTH_CHECK": "cheap"}, bf16=False,
                           fp16=True, scale=N_FP16_SCALE)
    out["fp8"] = _n_train(device, ids, tp, "speed", N_OPT_STEPS, matmul_precision="fp8")
    return out


def _n_rank(rank, world, device, root):
    """One tp rank on ``device`` (None: cuda:LOCAL_RANK): (a) the speed layout
    with its checkpoint, (b) the memory layout, (g)-(j) the training options,
    (c) the small fp32 model, (d) the fused CE, (e) generation."""
    device = device or f"cuda:{rank}"
    ids = _w_batch(device)
    out = {"speed": _n_train(device, ids, 2, "speed", root=root)}
    out["memory"] = _n_train(device, ids, 2, "memory")
    out["options"] = _n_options(device, ids, 2)
    out["small"] = _n_small(device)
    out["ce"] = _n_ce(device)
    out["generate"] = _n_generate(device)
    return out


def _n_resume(rank, world, device, root):
    """(f) A fresh pair: phase L's model from another seed, the step-2
    checkpoint resumed into it, then step 3: its loss."""
    import smdistributed_modelparallel_tpu_torch as smp

    _n_init(device, tensor_parallel_degree=2)
    model, optimizer, train_step = _lm_train(_n_module(LM_CFG, device, seed=SEED + 11), device)
    t0 = time.perf_counter()
    smp.resume_from_checkpoint(root, tag="n2")
    resume_s = time.perf_counter() - t0
    loss = float(train_step(model, _w_batch(device)).reduce_mean())
    optimizer.step()
    smp.shutdown()
    return dict(loss=loss, resume_s=resume_s)


def _n_base():
    """tp = 1 in this process: the same weights and batch (the yardstick), and
    the options' runs of (h) and (j)."""
    ids = _w_batch("cuda")
    return dict(_n_train("cuda", ids, 1), options=_n_options("cuda", ids, 1))


def _n_margin(tokens):
    """(e) The tp = 2 greedy tokens' largest gap to their row's maximum, as a
    share of its max |logit|, in a tp = 1 bf16 forward of the same weights."""
    import smdistributed_modelparallel_tpu_torch as smp

    _n_init("cuda", tensor_parallel_degree=1)
    module = _n_module(LM_CFG, "cuda").to(torch.bfloat16)
    ids, _, prompts = g_prompts(LM_CFG["vocab_size"])
    T = ids.shape[1]
    margin = _g_margin(lambda x: module(x)[0], _g_rows(prompts, torch.from_numpy(tokens), T, G_NEW))
    del module
    smp.reset()
    torch.cuda.empty_cache()
    return margin


def phase_n(device="cuda:0"):
    """Tensor parallelism at tp = 2: two ranks on ``device`` (gloo with pinned
    host copies); holds (a)-(f) against tp = 1 in this process."""
    import shutil

    shutil.rmtree(N_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(2, _n_rank, device, N_DIR)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = run_ranks(2, _n_resume, device, N_DIR)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(N_DIR, ignore_errors=True)
    base = _n_base()
    margins = [_n_margin(r["generate"]["tokens"]) for r in ranks]
    return _n_report(ranks, resumed, base, margins, ranks_s, resume_s, device)


def _n_steps_ms(run):
    """ms a step over steps 2.., and the tp regions' host ms a step."""
    return sum(run["ms"][1:]) / (len(run["ms"]) - 1), sum(run["comm"][1:]) / (len(run["comm"]) - 1)


def _n_report(ranks, resumed, base, margins, ranks_s, resume_s, device):
    failures = []
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per = LM_CFG["num_layers"] * TRAIN_MB * N_STEPS
    want = {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per, "bias_gelu_fwd": per, "bias_gelu_bwd": per,
            "matmul_bias": 0}
    base_ms, _ = _n_steps_ms(base)
    log(f"[N] tp = 2: 2 ranks on {device}, transport {ranks[0]['speed']['transport']} (host copies of CUDA tensors); "
        f"ranks "
        f"took {ranks_s:.1f} s with start-up, the resumed pair {resume_s:.1f} s")
    log(f"[N] tp = 1 in one process: losses {base['losses']}; ms/step {base_ms:.2f} (steps 2-{N_STEPS}), tokens/s "
        f"{tokens / base_ms * 1e3:.1f}; peak {base['peak']:.2f} GiB")
    for layout, label in (("speed", "(a)"), ("memory", "(b)")):
        for rank, r in enumerate(ranks):
            run = r[layout]
            ms, comm = _n_steps_ms(run)
            gap = max(abs(a - b) for a, b in zip(run["losses"], base["losses"]))
            log(f"[N] {label} {layout}, rank {rank}: losses {run['losses']}, largest difference to tp = 1 {gap:.3e} "
                f"(limit {N_LOSS_TOL}); ms/step {ms:.2f} (per step {[round(x, 2) for x in run['ms']]}), global "
                f"tokens/s {tokens / ms * 1e3:.1f}; the tp regions' host ms a step {comm:.2f}; peak {run['peak']:.2f} "
                f"GiB; sequence-parallel {run['sequence_parallel']}; launches {run['launches']}")
            if not (gap <= N_LOSS_TOL and all(math.isfinite(x) for x in run["losses"])):
                failures.append(f"{label} rank {rank}: losses differ from tp = 1 by {gap:.3e}")
            got = {k: run["launches"][k] for k in want}
            if got != want:
                failures.append(f"{label} rank {rank}: launches {got}, expected {want}")
            try:
                _check_route(f"[N] {label} rank {rank}", run["launches"])
            except RuntimeError as e:
                failures.append(str(e))
            if run["sequence_parallel"] != (layout == "memory"):
                failures.append(f"{label} rank {rank}: sequence-parallel {run['sequence_parallel']}")
        same = ranks[0][layout]["prints"] == ranks[1][layout]["prints"]
        same = same and ranks[0][layout]["losses"] == ranks[1][layout]["losses"]
        log(f"[N] {label} replicated parameters bit-equal across the ranks after every step: {same}")
        if not same:
            failures.append(f"{label}: the replicated parameters differ across the tp ranks")
    failures += _n_report_options(ranks, base)
    for rank, r in enumerate(ranks):
        for layout in ("speed", "memory"):
            (card_l, card_g), (cpu_l, cpu_g) = r["small"][layout]
            lerr = max(abs(a - b) for a, b in zip(card_l, cpu_l))
            gerr = max(float(np.abs(card_g[n] - cpu_g[n]).max() / max(np.abs(cpu_g[n]).max(), 1e-12)) for n in cpu_g)
            log(f"[N] (c) rank {rank} small fp32 model (2 layers) at tp = 2, {layout}, card vs CPU: losses {card_l} vs "
                f"{cpu_l}, largest difference {lerr:.3e}; first-step gradients' largest difference {gerr:.3e} of "
                f"their largest value (limit {N_SMALL_TOL})")
            if not (lerr <= N_SMALL_TOL and gerr <= N_SMALL_TOL):
                failures.append(f"(c) rank {rank} {layout}: the small fp32 model on the card disagrees with the CPU")
    ce_want = {"fused_ce_fwd": N_STEPS, "fused_ce_bwd_dx": N_STEPS, "fused_ce_bwd_dw": N_STEPS}
    for rank, r in enumerate(ranks):
        fused, plain = r["ce"][True], r["ce"][False]
        gap = max(abs(a - b) for a, b in zip(fused["losses"], plain["losses"]))
        fms, pms = (sum(x["ms"][1:]) / (N_STEPS - 1) for x in (fused, plain))
        log(f"[N] (d) rank {rank} vocab {N_VOCAB}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in one microbatch: fused CE "
            f"losses {fused['losses']}, {fms:.2f} ms/step, peak {fused['peak']:.2f} GiB, launches {fused['launches']}; "
            f"materialized losses {plain['losses']}, {pms:.2f} ms/step, peak {plain['peak']:.2f} GiB; largest "
            f"difference {gap:.3e} (limit {N_CE_TOL})")
        if not (gap <= N_CE_TOL and all(math.isfinite(x) for x in fused["losses"] + plain["losses"])):
            failures.append(f"(d) rank {rank}: fused and materialized losses differ by {gap:.3e}")
        if {k: fused["launches"][k] for k in ce_want} != ce_want or any(
                plain["launches"][k] for k in ce_want):
            failures.append(f"(d) rank {rank}: launches {fused['launches']} / {plain['launches']}, expected {ce_want}")
        try:
            _check_route(f"[N] (d) rank {rank}", fused["launches"])
        except RuntimeError as e:
            failures.append(str(e))
    for rank, (r, margin) in enumerate(zip(ranks, margins)):
        gen = r["generate"]
        card, cpu = gen["small"]
        log(f"[N] (e) rank {rank} generate at tp = 2 ({gen['heads']} heads a rank in each layer's cache): prefill "
            f"{gen['prefill_ms']:.2f} ms, decode {gen['decode_ms']:.3f} ms/token; greedy tokens' largest gap to their "
            f"row's maximum in a tp = 1 bf16 forward {margin:.3e} of max |logit| (limit {S_MARGIN}); launches "
            f"{gen['launches']}; the small fp32 model's tokens card == CPU {np.array_equal(card, cpu)}")
        if not margin <= S_MARGIN:
            failures.append(f"(e) rank {rank}: a greedy token {margin:.3e} below its row's maximum")
        if not np.array_equal(card, cpu):
            failures.append(f"(e) rank {rank}: the small fp32 model's tokens differ on the card and the CPU")
        if gen["launches"]["flash_fwd"] != 2 * LM_CFG["num_layers"] or gen["launches"]["matmul_bias"]:
            failures.append(f"(e) rank {rank}: launches {gen['launches']}")
        try:
            _check_route(f"[N] (e) rank {rank}", gen["launches"])
        except RuntimeError as e:
            failures.append(str(e))
    if not np.array_equal(ranks[0]["generate"]["tokens"], ranks[1]["generate"]["tokens"]):
        failures.append("(e) the tp ranks generated different tokens")
    step3 = ranks[0]["speed"]["losses"][N_SAVE_AT]
    got = [r["loss"] for r in resumed]
    log(f"[N] (f) the step-{N_SAVE_AT} partial checkpoint resumed by a fresh pair ({resumed[0]['resume_s']:.2f} s): "
        f"step {N_SAVE_AT + 1}'s loss {got} against {step3}: bit-equal {all(x == step3 for x in got)}")
    if not all(x == step3 for x in got):
        failures.append(f"(f) the resumed step's loss {got} differs from {step3}")
    if failures:
        raise RuntimeError("phase N: " + "; ".join(failures))
    launches = {}
    for runs in ([base] + [r[k] for r in ranks for k in ("speed", "memory")], list(base["options"].values()),
                 [run for r in ranks for name, run in r["options"].items() if name not in N_CONTROLS],
                 [r["ce"][True] for r in ranks], [r["generate"] for r in ranks]):
        for run in runs:
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n
    return launches, dict(base_ms=base_ms, ms=_n_steps_ms(ranks[0]["speed"])[0])


def _n_nonzero(run):
    """A run's launches, the kernels it launched only."""
    return {k: n for k, n in run["launches"].items() if n}


def _n_gap(run, want, relative=False):
    """The largest difference of ``run``'s losses to ``want``'s (the steps
    both ran), relative to ``want``'s with ``relative``."""
    return max(abs(a - b) / (abs(b) if relative else 1.0) for a, b in zip(run["losses"], want["losses"]))


def _n_masks_equal(run, want, rank):
    """Whether each of the tp rank's first-microbatch keep masks is its part
    of the tp = 1 run's: the whole mask where its shape is the whole one's,
    else the rank's T half."""
    if len(run["masks"]) != len(want["masks"]) or not run["masks"]:
        return False
    return all(m[1] == (w[1] if m[0] == w[0] else w[2][rank]) for m, w in zip(run["masks"], want["masks"]))


def _n_heads_ok(run, want, rank):
    """Whether each first-microbatch attention call of the tp rank handed
    the flash kernels the rank's global heads (head0 = rank x H/tp of H)
    and the seed of the tp = 1 run's call (which hands no heads)."""
    H = LM_CFG["num_attention_heads"]
    return (len(run["heads"]) == len(want["heads"]) == LM_CFG["num_layers"] and
            all(h == (rank * H // 2, H, w[2]) and w[:2] == (None, None) and w[2] is not None
                for h, w in zip(run["heads"], want["heads"])))


def _n_state_gap(got, want):
    """The largest relative difference of two fp8 states' amax histories (0
    where both are 0), and whether their live slots are the same."""
    g, w = np.asarray(got["amax_history"], np.float64), np.asarray(want["amax_history"], np.float64)
    gap = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30) * (np.abs(w) > 0)))
    return gap, (g[:, 0] > 0).tolist() == (w[:, 0] > 0).tolist()


def _n_word_gap(got, want):
    """The largest relative difference of two sentinel words' maxima, and
    whether their tags, counts and first bad microbatches agree."""
    same = got.keys() == want.keys() and all(got[t]["bad"] == want[t]["bad"] and
                                              got[t]["microbatch"] == want[t]["microbatch"] for t in want)
    gap = max(abs(got[t]["absmax"] - want[t]["absmax"]) / max(abs(want[t]["absmax"]), 1e-30) for t in want)
    return gap, same


def _n_report_options(ranks, base):
    """(g)-(j): the log lines and the failures of the training options."""
    failures = []
    per = LM_CFG["num_layers"] * TRAIN_MB
    bopt = base["options"]
    for rank, r in enumerate(ranks):
        opt = r["options"]
        for layout in ("speed", "memory"):
            run = opt["ring_" + layout]
            gap = _n_gap(run, base)
            chunks = run["launches"]["matmul_bias"]
            log(f"[N] (g) ring + fused QKV, {layout}, rank {rank}: losses {run['losses']}, largest difference to "
                f"tp = 1 {gap:.3e} (limit {N_LOSS_TOL}); ms/step {_n_steps_ms(run)[0]:.2f} (per step "
                f"{[round(x, 2) for x in run['ms']]}); the tp regions' host ms a step {_n_steps_ms(run)[1]:.2f}; "
                f"peak {run['peak']:.2f} GiB; matmul_bias launches {chunks} ({per * 2} a step: layers x microbatches "
                f"x tp); launches {run['launches']}")
            if not gap <= N_LOSS_TOL:
                failures.append(f"(g) {layout} rank {rank}: losses differ from tp = 1 by {gap:.3e}")
            if chunks != per * 2 * N_OPT_STEPS or run["sequence_parallel"] != (layout == "memory"):
                failures.append(f"(g) {layout} rank {rank}: {chunks} matmul_bias launches, sequence-parallel "
                                f"{run['sequence_parallel']}")
        drop, want = opt["dropout"], bopt["dropout"]
        gap, masks, heads = _n_gap(drop, want), _n_masks_equal(drop, want, rank), _n_heads_ok(drop, want, rank)
        control = _n_gap(opt["dropout_local_heads"], want)
        log(f"[N] (h) dropouts 0.1 at tp = 2 (memory layout, ring), rank {rank}: losses {drop['losses']} against tp = "
            f"1's {want['losses']}, largest difference {gap:.3e} (limit {N_DROP_TOL}); the first microbatch's "
            f"{len(drop['masks'])} masks equal tp = 1's (the rank's T half where sharded): {masks}; its "
            f"{len(drop['heads'])} attention calls hand the flash kernels the rank's global heads and tp = 1's seeds: "
            f"{heads} ({drop['heads'][:1]}); index-mapped dropout_fwd launches "
            f"{drop['launches']['dropout_fwd_index_map']} of {drop['launches']['dropout_fwd']}; ms/step "
            f"{_n_steps_ms(drop)[0]:.2f}; launches {_n_nonzero(drop)}")
        log(f"[N] (h) control, rank {rank}: the flash kernels hashing the rank's local heads: losses "
            f"{opt['dropout_local_heads']['losses']}, largest difference to tp = 1 {control:.3e}; (h)'s bound "
            f"{N_DROP_TOL} catches it: {control > N_DROP_TOL}")
        if not (gap <= N_DROP_TOL and masks and heads and drop["launches"]["dropout_fwd_index_map"] > 0):
            failures.append(f"(h) rank {rank}: loss gap {gap:.3e}, masks equal {masks}, heads {heads}")
        if not control > N_DROP_TOL:
            failures.append(f"(h) control rank {rank}: the local-heads masks differ from tp = 1 by only {control:.3e}, "
                            f"inside (h)'s bound {N_DROP_TOL}")
        for name, ref, label in (("ckpt", r["speed"], "(a)"), ("ckpt_dropout", drop, "(h)")):
            run = opt[name]
            gap = _n_gap(run, ref)
            log(f"[N] (i) checkpointing{' with the dropouts' if name != 'ckpt' else ''}, rank {rank}: losses "
                f"{run['losses']}, largest difference to {label} without it {gap:.3e} (limit {N_CKPT_TOL}); the "
                f"step's peak above what it found allocated {run['step_peak']:.3f} GiB against {ref['step_peak']:.3f}; "
                f"the run's peak {run['peak']:.2f} GiB against {ref['peak']:.2f}; ms/step {_n_steps_ms(run)[0]:.2f} "
                f"against {_n_steps_ms(ref)[0]:.2f}; launches {_n_nonzero(run)}")
            if not (gap <= N_CKPT_TOL and run["step_peak"] < ref["step_peak"]):
                failures.append(f"(i) {name} rank {rank}: loss gap {gap:.3e}, the step's peak {run['step_peak']:.3f} "
                                f"GiB against {ref['step_peak']:.3f}")
        fp16, w16 = opt["fp16"], bopt["fp16"]
        gap = _n_gap(fp16, w16)
        log(f"[N] (j) fp16, rank {rank}: losses {fp16['losses']} against tp = 1's {w16['losses']}, largest difference "
            f"{gap:.3e} (limit {N_LOSS_TOL}); overflow-free steps {fp16['finite']} (tp = 1 {w16['finite']}); loss "
            f"scale {fp16['scale']} (tp = 1 {w16['scale']}); ms/step {_n_steps_ms(fp16)[0]:.2f}; launches "
            f"{_n_nonzero(fp16)}")
        if not (gap <= N_LOSS_TOL and fp16["finite"] == w16["finite"] and fp16["scale"] == w16["scale"]):
            failures.append(f"(j) fp16 rank {rank}: loss gap {gap:.3e}, flags {fp16['finite']}, scale {fp16['scale']}")
        fp8, w8 = opt["fp8"], bopt["fp8"]
        gap = _n_gap(fp8, w8, relative=True)
        states = [_n_state_gap(g, w) for g, w in zip(fp8["quant"], w8["quant"])]
        first_w = all(g["amax_history"][i][0] == w["amax_history"][i][0]
                      for g, w in zip(fp8["quant"][:1], w8["quant"][:1])
                      for i, slot in enumerate(w["slots"]) if slot.endswith(".w"))
        state_gap = max(sg for sg, _ in states)
        live = all(ok for _, ok in states)
        log(f"[N] (j) fp8, rank {rank}: losses {fp8['losses']} against tp = 1's {w8['losses']}, largest relative "
            f"difference {gap:.3e} (limit {FP8_LOSS_TOL}); amax history's largest relative difference {state_gap:.3e} "
            f"(limit {N_STATE_TOL}), the same live slots {live}, the first step's weight slots equal {first_w}; "
            f"ms/step {_n_steps_ms(fp8)[0]:.2f}; launches {_n_nonzero(fp8)}")
        if not (gap <= FP8_LOSS_TOL and state_gap <= N_STATE_TOL and live and first_w):
            failures.append(f"(j) fp8 rank {rank}: loss gap {gap:.3e}, state gap {state_gap:.3e}, live {live}, "
                            f"weights {first_w}")
        words = [_n_word_gap(g, w) for g, w in zip(fp16["health"], w16["health"])]
        word_gap, same = max(x for x, _ in words), all(ok for _, ok in words) and len(words) == N_OPT_STEPS
        log(f"[N] (j) SMP_HEALTH_CHECK=cheap beside fp16, rank {rank}: the words' tags, counts and first bad "
            f"microbatches equal tp = 1's {same}, maxima within {word_gap:.3e} relative (limit {N_STATE_TOL}); words "
            f"{fp16['health']}; health_reduce launches {fp16['launches']['health_reduce']} (one a step: the "
            f"overflow flag's and the sentinel's)")
        if not (same and word_gap <= N_STATE_TOL and fp16["launches"]["health_reduce"] == N_OPT_STEPS):
            failures.append(f"(j) sentinel rank {rank}: words equal {same}, gap {word_gap:.3e}")
        for name, run in opt.items():
            try:
                _check_route(f"[N] ({name}) rank {rank}", run["launches"])
            except RuntimeError as e:
                failures.append(str(e))
    for name in set(ranks[0]["options"]) - N_CONTROLS:
        same = (ranks[0]["options"][name]["prints"] == ranks[1]["options"][name]["prints"]
                and ranks[0]["options"][name]["losses"] == ranks[1]["options"][name]["losses"])
        if not same:
            failures.append(f"({name}): the replicated parameters differ across the tp ranks")
    log(f"[N] (g)-(j) replicated parameters bit-equal across the ranks after every step: "
        f"{not any('replicated' in f for f in failures)}")
    return failures


def _n_rank_i(rank, world):
    """Phase I's rank: (a) and (g) (the ring in both layouts) with the ranks on
    cuda:0 and cuda:1."""
    device = f"cuda:{rank}"
    ids = _w_batch(device)
    return {"speed": _n_train(device, ids, 2),
            **{"ring_" + layout: _n_train(device, ids, 2, layout, **N_RING) for layout in ("speed", "memory")}}


def phase_i():
    """Hold (a) and (g) of phase N with the two tp ranks on cuda:0 and cuda:1
    (the tp regions and the ring's hops over NCCL; a machine with two
    cards)."""
    if torch.cuda.device_count() < 2:
        raise RuntimeError(f"tp ranks on separate cards need 2 cards, found {torch.cuda.device_count()}")
    ranks = run_ranks(2, _n_rank_i)
    base = _n_train("cuda", _w_batch("cuda"), 1)
    failures = []
    for name in ("speed", "ring_speed", "ring_memory"):
        runs = [r[name] for r in ranks]
        gap = max(_n_gap(run, base) for run in runs)
        ms, comm = _n_steps_ms(runs[0])
        same = runs[0]["prints"] == runs[1]["prints"]
        log(f"[I] {name}: tp = 2 on cuda:0-1, transport {runs[0]['transport']}: losses {runs[0]['losses']}, tp = 1 "
            f"{base['losses']}, largest difference {gap:.3e}; ms/step {ms:.2f} (tp = 1 {_n_steps_ms(base)[0]:.2f}), "
            f"global tokens/s {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f}; the tp regions' host ms a step {comm:.2f}; "
            f"replicated parameters bit-equal {same}; launches {runs[0]['launches']}")
        if gap > N_LOSS_TOL or not same:
            failures.append(f"{name}: loss gap {gap:.3e}, bit-equal {same}")
        if name != "speed" and runs[0]["launches"]["matmul_bias"] != LM_CFG["num_layers"] * TRAIN_MB * 2 * N_STEPS:
            failures.append(f"{name}: matmul_bias launches {runs[0]['launches']['matmul_bias']}")
    if failures:
        raise RuntimeError("phase I: tp = 2 over NCCL: " + "; ".join(failures))


# ----------------------------------------------------------------------
# Phase R's extension: rdp = 2 beside cp = 2, four ranks on one card
# ----------------------------------------------------------------------

RC_STEPS, RC_LAYERS = 2, 12


def _rc_rank(rank, world, device):
    """One rank of rdp 2 x cp 2 on ``device``: phase R's model and batch,
    this rank's rows (the rdp coordinate's), the ring within its cp group."""
    import smdistributed_modelparallel_tpu_torch as smp

    from smdistributed_modelparallel_tpu_torch.backend.state import state

    smp.init({"microbatches": CP_MB, "bf16": True, "context_parallel_degree": 2, "ddp": True}, device=device)
    module, ids, tgt = _cp_model_and_batch(state.device)
    ids, tgt = next(smp.shard_batches(iter([(ids, tgt)])))
    model = smp.DistributedModel(module)
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids_, tgt_):
        count = (tgt_ != -100).sum()
        loss = model(ids_, targets=tgt_).sum() / count
        model.backward(loss, num_tokens=count)
        return loss

    counters = {**_ids_counters(), **_flash_simt_counters()}
    _e_zero(counters)
    losses, ms, prints = [], [], []
    for _ in range(RC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(model, ids, tgt).reduce_mean()))
        optimizer.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        prints.append(_w_fingerprint(model))
    out = dict(losses=losses, ms=ms, prints=prints, launches={k: fn.launches for k, fn in counters.items()},
               coords=(state.topology.coords(state.rank)["rdp"], smp.cp_rank()), rows=int(ids.shape[0]))
    smp.reset()
    return out


def _phase_rc(device, base_losses):
    """rdp 2 x cp 2 against phase R's cp = 1 losses (the same weights and
    batch); returns the launches of the four ranks."""
    t0 = time.perf_counter()
    ranks = run_ranks(4, _rc_rank, device)
    took = time.perf_counter() - t0
    per_step = RC_LAYERS * 2 * CP_MB  # layers x ring steps x microbatches
    gap = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], base_losses))
    ms = sum(ranks[0]["ms"][1:]) / max(RC_STEPS - 1, 1)
    log(f"[R] rdp 2 x cp 2: 4 ranks on {device}, rows a rank {[r['rows'] for r in ranks]}, (rdp, cp) coordinates "
        f"{[r['coords'] for r in ranks]}; {RC_STEPS} steps (depth {RC_LAYERS} layers, none cut); ranks took "
        f"{took:.1f} s with start-up; losses {ranks[0]['losses']}, cp = 1 {base_losses[:RC_STEPS]}, largest "
        f"difference {gap:.3e} (limit {CP_LOSS_TOL:.0e}); ms/step {ms:.2f} (rank 0, per step "
        f"{[round(x, 2) for x in ranks[0]['ms']]}); launches {[r['launches'] for r in ranks]}")
    failures = []
    if not gap <= CP_LOSS_TOL:
        failures.append(f"losses differ from cp = 1 by {gap:.3e}")
    if any(r["prints"] != ranks[0]["prints"] or r["losses"] != ranks[0]["losses"] for r in ranks):
        failures.append("the replicas differ")
    for rank, r in enumerate(ranks):
        for k in _ids_counters():
            if r["launches"][k] != per_step * RC_STEPS:
                failures.append(f"rank {rank}: {k} launched {r['launches'][k]} times, expected {per_step * RC_STEPS}")
        try:
            _check_route(f"rank {rank} rdp x cp", r["launches"])
        except RuntimeError as e:
            failures.append(str(e))
    log(f"[R] rdp 2 x cp 2 replicas bit-equal after every step: {not any('replicas' in f for f in failures)}")
    if failures:
        raise RuntimeError("phase R (rdp x cp): " + "; ".join(failures))
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


# ----------------------------------------------------------------------
# Phase J: serving replicas over the native bus, two processes on one card
# ----------------------------------------------------------------------

J_ENV = {"SMP_SUPERVISOR": "on", "SMP_HEARTBEAT_INTERVAL": "0.2", "SMP_HEARTBEAT_MISS_BUDGET": "5",
         "SMP_COLLECTIVE_TIMEOUT": "120"}
J_SCALE = dict(n=12, n_sampled=3, prompt=(32, 128), new=(24, 24), seed=SEED + 8, prefix="c")
J_FAIL = dict(n=6, n_sampled=2, prompt=(32, 128), new=(24, 48), seed=SEED + 7, prefix="f")
J_PINNED = dict(n=2, n_sampled=1, prompt=(64, 64), new=(16, 16), seed=SEED + 9, prefix="pin")
J_SLOTS, J_BLOCKS = 4, 65
J_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_serving")


def _j_factory(warm=True):
    """A factory of GPT-2 124M serving engines from SEED (in the dtype
    ``smp.init`` named), and its module. With ``warm`` the engine's first
    request samples a token: a standby's warm start loads the threefry
    kernel's library (built by this call's first process, so from disk)."""
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.serving import ServeRequest, ServingEngine

    module = init_gpt2_weights_(gpt2_124m(device="cuda"), torch.Generator(device="cuda").manual_seed(SEED))

    def factory():
        engine = ServingEngine(module, params=module.state_dict(), max_slots=J_SLOTS, num_blocks=J_BLOCKS,
                               device="cuda")
        if warm:
            engine.run([ServeRequest("warm", list(range(8)), 2, temperature=1.0, seed=0)])
        return engine

    return factory, module


def _j_margin(module, reqs, results):
    """Largest gap of a greedy token to its row's maximum in a teacher-forced
    bf16 forward on the plain attention path, as a share of the row's max
    |logit| (phase S's check)."""
    worst = 0.0
    with torch.inference_mode(), _env(SMP_DISABLE_PALLAS_ATTN="1"):
        bf16_module = copy.deepcopy(module).to(torch.bfloat16)
        for r in reqs:
            if r.temperature > 0:
                continue
            toks = results[r.request_id]
            ids = torch.tensor([list(r.prompt) + toks[:-1]], device="cuda")
            rows = bf16_module(ids)[0, len(r.prompt) - 1:].float()
            picked = rows.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
            worst = max(worst, float(((rows.amax(dim=1) - picked) / rows.abs().amax(dim=1)).max()))
    return worst


def _j_serve_world(rank, world, feed):
    """World 1 (bf16): (c) the autoscale burst, (a) phase S's burst through
    the router over two live replicas, (d) the canary on rank 0. Rank 1
    parks as a ``ReplicaServer`` for (c) and (a)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.ops.dropout import threefry_bits
    from smdistributed_modelparallel_tpu_torch.serving import (
        AutoscalePolicy,
        LocalReplicaHandle,
        RemoteReplicaHandle,
        ReplicaServer,
        RequestRouter,
        ServingController,
    )

    os.environ.update(J_ENV)
    smp.init({"bf16": True, "ddp": True}, device="cuda:0")
    factory, module = _j_factory()
    threefry_bits.launches = 0
    if rank == 1:
        served = [sorted(ReplicaServer(factory, state.bus, controller_rank=0).serve(timeout_s=600.0))
                  for _ in ("c", "a")]
        smp.barrier()
        out = dict(served=served, threefry=threefry_bits.launches)
        smp.reset()
        return out

    out = {}
    # (c) the autoscale burst: one replica, a standby on rank 1.
    os.environ.update(SMP_AUTOSCALE="on", SMP_SLO="queue_depth=2", SMP_AUTOSCALE_COOLDOWN="0.5",
                      SMP_AUTOSCALE_MIN="1", SMP_AUTOSCALE_MAX="2", SMP_AUTOSCALE_HYSTERESIS="2",
                      SMP_CONTROLLER_PATH=feed)
    eng0 = factory()
    router = RequestRouter()
    seq = [0]

    def window():
        seq[0] += 1
        return {"seq": seq[0], "t_wall": time.time(),
                "queue_depth": max((h.load() for h in router.live_handles()), default=0)}

    ctl = ServingController.from_env(router=router, window_source=window)
    ctl.register_live(LocalReplicaHandle("replica0", eng0, version=0))
    remote = RemoteReplicaHandle("replica1", state.bus, peer=1, version=0)

    def activate():
        remote.activate(timeout_s=300.0)
        return remote

    ctl.add_standby("replica1", activate)
    reqs = s_requests(module.vocab_size, **J_SCALE)
    t0 = time.perf_counter()
    for req in reqs[:8]:
        router.dispatch(req)
    sent, deadline = 8, time.monotonic() + 300
    while time.monotonic() < deadline:
        if sent < len(reqs) and ctl.replicas == 2:
            router.dispatch(reqs[sent])
            sent += 1
        busy = router.step_all()
        ctl.tick()
        if sent == len(reqs) and not busy and all(r.request_id in ctl.results() for r in reqs):
            break
    burst_s = time.perf_counter() - t0
    down_deadline = time.monotonic() + 60
    while ctl.replicas > 1 and time.monotonic() < down_deadline:
        router.step_all()
        ctl.tick()
        time.sleep(0.01)
    results = ctl.results()
    out["c"] = dict(events=[{k: v for k, v in e.items() if k != "t_wall"} for e in ctl.scale_events],
                    results={r.request_id: list(results.get(r.request_id, ())) for r in reqs},
                    want={r.request_id: r.max_new_tokens for r in reqs}, routed=dict(router.routed), sent=sent,
                    burst_s=burst_s, margin=_j_margin(module, reqs, results))
    ctl.stop()
    for k in ("SMP_AUTOSCALE", "SMP_CONTROLLER_PATH"):
        os.environ.pop(k)

    # (a) phase S's burst through the router over two live replicas.
    remote = RemoteReplicaHandle("replica1", state.bus, peer=1, version=0)
    remote.activate(timeout_s=300.0)
    local = LocalReplicaHandle("replica0", eng0, version=0)
    router = RequestRouter()
    router.attach(local)
    router.attach(remote)
    reqs = s_requests(module.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = [router.dispatch(r) for r in reqs]
    while not all(r.request_id in router.results() for r in reqs):
        if not router.step_all():
            time.sleep(0.001)
    wall = time.perf_counter() - t0
    results = router.results()
    out["a"] = dict(placed=placed, wall=wall, tokens=sum(len(results[r.request_id]) for r in reqs),
                    results={r.request_id: list(results[r.request_id]) for r in reqs},
                    want={r.request_id: r.max_new_tokens for r in reqs}, margin=_j_margin(module, reqs, results),
                    routed=dict(router.routed))
    remote.deactivate()

    # (d) the canary on rank 0's replica: unchanged weights promote,
    # perturbed ones roll back.
    wins = []
    ctl = ServingController(router=RequestRouter(), policy=AutoscalePolicy({"queue_depth": 50.0}),
                            window_source=lambda: wins.pop(0) if wins else None, canary_windows=1)
    ctl.register_live(LocalReplicaHandle("primary", eng0, version=0))
    pinned = s_requests(module.vocab_size, **J_PINNED)
    params = {k: v.detach().clone() for k, v in module.state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    perturbed = {k: v + 0.02 * torch.randn(v.shape, generator=g, device=v.device) if v.is_floating_point() else v
                 for k, v in params.items()}
    promoted = ctl.start_canary(params, version=1, pinned=pinned)
    wins.append({"seq": 1, "queue_depth": 0.0})
    ctl.tick()
    rolled = ctl.start_canary(perturbed, version=2, pinned=pinned)
    out["d"] = dict(first=promoted, promotions=ctl.promotions, second=rolled, rollbacks=ctl.rollbacks,
                    version=eng0.weights_version)
    ctl.stop()
    eng0.close()
    smp.barrier()
    out["threefry"] = threefry_bits.launches
    smp.reset()
    return out


def _j_fail_world(rank, world):
    """World 2 (fp32): (b) replica failover. Rank 1 is SIGKILLed mid-decode
    by ``kill_replica@request=2:rank=1``; rank 0 re-admits its requests and
    finishes all six, against a never-killed engine's tokens."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.serving import ReplicatedServingEngine
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    os.environ.update(J_ENV, SMP_CHAOS="kill_replica@request=2:rank=1")
    smp.init({"ddp": True}, device="cuda:0")
    factory, module = _j_factory(warm=False)
    reqs = s_requests(module.vocab_size, **J_FAIL)
    rep = ReplicatedServingEngine(factory())
    mine = [r for i, r in enumerate(reqs) if i % world == rank]
    results = rep.run(mine, timeout_s=300.0, linger_s=60.0 if rank == 0 else 0.0)
    # The never-killed run, after the failover so that its detection is timed
    # while rank 0 serves.
    reference = factory().run(reqs)
    report = telemetry.report()["metrics"]
    phases = {s["labels"]["phase"]: s["value"] for s in report.get("smp_recovery_phase_seconds", {"series": []})["series"]}
    events = {s["labels"]["event"]: s["value"] for s in report["smp_serve_requests_total"]["series"]}
    out = dict(results={r.request_id: list(results.get(r.request_id, ())) for r in reqs},
               reference={k: list(v) for k, v in reference.items()},
               mttr=report["smp_recovery_seconds"]["series"][0]["value"], phases=phases, events=events,
               sampled=[r.request_id for r in reqs if r.temperature > 0])
    smp.reset()
    return out


# ----------------------------------------------------------------------
# Phase p: pipeline parallelism at pp = 2
# ----------------------------------------------------------------------

# P_LOSS_TOL: pp = 2's bf16 losses against pp = 1's, relative; 15x the
# largest gap measured on the H100 (6.5e-06). A looser bound misses faults
# that AdamW hides: its first update is about lr x sign(g), whatever the
# gradient's scale. The control run drops microbatch 0's backward and must
# land outside it.
P_STEPS, P_LOSS_TOL, P_SMALL_TOL = 3, 1e-4, 1e-5
P_SMALL_B, P_SMALL_T = 4, 64


def _p_module(kind, device):
    """The phase's models, their weights drawn from SEED: the zoo's GPT-2
    124M ("gpt2"), phase L's smp.nn head with fused_bias_gelu ("head"), a
    2-layer fp32 GPT-2 at d 128 drawn on the CPU ("small")."""
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2, gpt2_124m, init_gpt2_weights_

    if kind == "head":
        return _n_module(LM_CFG, device)
    if kind == "small":
        return init_gpt2_weights_(gpt2("gpt2_124m", max_len=128, d_model=128, n_layers=2, n_heads=4),
                                  torch.Generator().manual_seed(SEED + 7))
    return init_gpt2_weights_(gpt2_124m(device=device), torch.Generator(device=device).manual_seed(SEED))


def _p_gauges(schedule):
    """The pipeline gauges of ``schedule``: {name or name/state: value}."""
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

    out = {}
    for name, metric in telemetry.report()["metrics"].items():
        for series in metric["series"] if name.startswith("smp_pipeline_") else ():
            if series["labels"].get("schedule") == schedule:
                state_ = series["labels"].get("state")
                out[name + (f"/{state_}" if state_ else "")] = series["value"]
    return out


def _p_train(device, kind, pp, steps=P_STEPS, pipeline="interleaved", evaluate=False):
    """``steps`` AdamW steps of ``kind`` at ``pp`` stages (bf16, but the
    small model in fp32) on phase T's batch in 4 microbatches, the loss from
    the logits (loss mode is refused at pp > 1, as in the JAX package):
    losses, ms a step, the P2P transfers' host ms a step, the replicated
    parameters' fingerprint a step, launches, the peak, the stage's parameter
    bytes, the pipeline gauges and, with ``evaluate``, a forward-only step's
    loss."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn import vocab_parallel_cross_entropy

    small = kind == "small"
    on_card = torch.device(device).type == "cuda"
    smp.init({"microbatches": TRAIN_MB, "bf16": not small, "fused_qkv": kind == "head", "ddp": True,
              "pipeline_parallel_degree": pp, "pipeline": pipeline}, device=device)
    module = _p_module(kind, "cpu" if small else device)
    model = smp.DistributedModel(module, device=device)
    optimizer = smp.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids):
        logits = model(ids)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    @smp.step
    def eval_step(model, ids):
        logits = model(ids)
        return vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()

    if small:
        ids = torch.randint(0, 50257, (P_SMALL_B, P_SMALL_T), generator=torch.Generator().manual_seed(SEED + 8))
        ids = ids.to(device)
    else:
        ids = _w_batch(device)
    counters = _n_counters()
    _e_zero(counters)
    out = dict(losses=[], ms=[], prints=[], comm=[], peak=0.0)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(steps):
        t0 = time.perf_counter()
        out["losses"].append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
        if on_card:
            torch.cuda.synchronize(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["comm"].append(getattr(model, "_pp_comm_seconds", 0.0) * 1e3)
        out["prints"].append(_w_fingerprint(model, skip=model._pp_layer_params))
    if evaluate:
        out["eval"] = float(eval_step(model, ids).reduce_mean())
    if on_card:
        out["peak"] = torch.cuda.max_memory_allocated(device) / 2**30
    out.update(launches={k: fn.launches for k, fn in counters.items()},
               param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
               layers=sorted({next(int(x) for x in n.split(".") if x.isdigit()) for n in model._pp_layer_params}),
               gauges=_p_gauges("1f1b" if pipeline == "interleaved" else "fill_drain"),
               eval_gauges=_p_gauges("fill_drain") if evaluate else {},
               transport=getattr(smp.state.group("pp"), "transport", None))
    del model, optimizer, train_step, eval_step
    smp.reset()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _p_drop_microbatch0():
    """The control's fault: the last stage seeds microbatch 0's loss with 0,
    so that microbatch adds nothing to any stage's gradients (the cotangents
    it sends back are zeros), as if its backward had been skipped."""
    from smdistributed_modelparallel_tpu_torch.parallel.pipeline import StageExecutor

    backward_step = StageExecutor.backward_step

    def faulty(self, m, cot):
        if not (self.last and m == 0):
            return backward_step(self, m, cot)
        seed, self.seed = self.seed, 0.0
        try:
            return backward_step(self, m, cot)
        finally:
            self.seed = seed

    with mock.patch.object(StageExecutor, "backward_step", faulty):
        yield


def _p_rank(rank, world, device, full=True):
    """One stage on ``device`` (None: cuda:LOCAL_RANK): (a) GPT-2 124M under
    the default schedule and a forward-only step; with ``full``, its control
    (microbatch 0's backward dropped), (b) the fill-drain schedule, (c) the
    smp.nn head and (d) the small fp32 model on the card, then on the CPU."""
    device = device or f"cuda:{rank}"
    out = {"gpt2": _p_train(device, "gpt2", 2, evaluate=True)}
    if full:
        with _p_drop_microbatch0():
            out["control"] = _p_train(device, "gpt2", 2, steps=2)
        out["simple"] = _p_train(device, "gpt2", 2, steps=2, pipeline="simple")
        out["head"] = _p_train(device, "head", 2)
        out["small"] = {"card": _p_train(device, "small", 2, steps=2), "cpu": _p_train("cpu", "small", 2, steps=2)}
    return out


def _p_runs(device="cuda:0", full=True):
    """Phase p's runs: the two stages on ``device`` (gloo with pinned host
    copies), then pp = 1 of the same weights in this process."""
    t0 = time.perf_counter()
    ranks = run_ranks(2, _p_rank, device, full)
    ranks_s = time.perf_counter() - t0
    base = {"gpt2": _p_train("cuda", "gpt2", 1, evaluate=True)}
    if full:
        base["head"] = _p_train("cuda", "head", 1)
    return dict(ranks=ranks, base=base, ranks_s=ranks_s)


def phase_pipe(device="cuda:0", full=True):
    """Pipeline parallelism at pp = 2 against pp = 1: the stages on
    ``device`` (None: cuda:0 and cuda:1)."""
    runs = _p_runs(device, full)
    return _p_report(runs["ranks"], runs["base"], runs["ranks_s"], full)


def _p_expected(schedule):
    """The gauges the grid of S 2, M 4 (window min(pp + 1, M) = 3) gives:
    ``schedule_occupancy`` of ``build_1f1b_schedule``, or the fill-drain
    count, and (pp - 1)/(M + pp - 1)."""
    from smdistributed_modelparallel_tpu_torch.parallel.pipeline_1f1b import build_1f1b_schedule, schedule_occupancy

    S, M = 2, TRAIN_MB
    if schedule == "1f1b":
        busy, total = schedule_occupancy(*build_1f1b_schedule(S, M, min(S + 1, M)))
    else:
        busy, total = M * S, (M + S - 1) * S
    return {"smp_pipeline_bubble_fraction": 1.0 - busy / total,
            "smp_pipeline_bubble_fraction_theoretical": (S - 1) / (M + S - 1),
            "smp_pipeline_schedule_slots/busy": float(busy), "smp_pipeline_schedule_slots/total": float(total),
            "smp_pipeline_stages": float(S), "smp_pipeline_microbatches": float(M),
            "smp_pipeline_virtual_stages": 1.0}


def _p_report(ranks, base, ranks_s, full):
    failures = []
    layers = 12 // 2
    runs = ["gpt2"] + (["simple", "head"] if full else [])
    launches = {}
    for r in ranks:
        for name in runs:
            for k, n in r[name]["launches"].items():
                launches[k] = launches.get(k, 0) + n
    for run in base.values():
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
    _check_route("pipeline path", launches)
    for name in runs:
        steps = len(ranks[0][name]["losses"])
        ms = [sum(r[name]["ms"][1:]) / (steps - 1) for r in ranks]
        comm = [sum(r[name]["comm"][1:]) / (steps - 1) for r in ranks]
        want = base["head" if name == "head" else "gpt2"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(ranks[-1][name]["losses"], want["losses"]))
        base_ms = sum(want["ms"][1:]) / (len(want["ms"]) - 1)
        log(f"[p] ({name}) pp = 2 {'fill-drain' if name == 'simple' else '1F1B'}, "
            f"{'smp.nn head' if name == 'head' else 'GPT-2 124M'}, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} "
            f"microbatches, over {ranks[0][name]['transport']}: {max(ms):.2f} ms/step (steps 2-{steps}; stages "
            f"{ms[0]:.2f} / {ms[1]:.2f}), {TRAIN_BATCH * TRAIN_SEQ / max(ms) * 1e3:.1f} global tokens/s; pp = 1: "
            f"{base_ms:.2f} ms/step; P2P host ms a step {comm[0]:.2f} / {comm[1]:.2f}; peak "
            f"{ranks[0][name]['peak']:.2f} / {ranks[1][name]['peak']:.2f} GiB (pp = 1 {want['peak']:.2f}); "
            f"parameter bytes {ranks[0][name]['param_bytes']} / {ranks[1][name]['param_bytes']} (pp = 1 "
            f"{want['param_bytes']}); layers {ranks[0][name]['layers'][0]}-{ranks[0][name]['layers'][-1]} / "
            f"{ranks[1][name]['layers'][0]}-{ranks[1][name]['layers'][-1]}")
        log(f"[p] ({name}) losses {ranks[-1][name]['losses']} against pp = 1's {want['losses'][:steps]}: max "
            f"rel gap {gap:.3e} (limit {P_LOSS_TOL})")
        if gap > P_LOSS_TOL or not all(math.isfinite(x) for x in ranks[-1][name]["losses"]):
            failures.append(f"({name}) losses {gap:.3e} from pp = 1")
        if ranks[0][name]["losses"] != ranks[1][name]["losses"]:
            failures.append(f"({name}) the stages return different losses")
        if ranks[0][name]["prints"] != ranks[1][name]["prints"]:
            failures.append(f"({name}) replicated parameters differ across the stages")
        if not all(r[name]["param_bytes"] < want["param_bytes"] for r in ranks):
            failures.append(f"({name}) a stage holds the whole model's parameters")
        if [r[name]["layers"] for r in ranks] != [list(range(layers)), list(range(layers, 12))]:
            failures.append(f"({name}) stage layers {[r[name]['layers'] for r in ranks]}")
        per_step = {k: [r[name]["launches"][k] / steps for r in ranks]
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                    + (("matmul_bias", "bias_gelu_fwd", "bias_gelu_bwd") if name == "head" else ())}
        if name == "gpt2":  # its forward-only step: one more forward a microbatch and layer
            per_step["flash_fwd"] = [(r[name]["launches"]["flash_fwd"] - layers * TRAIN_MB) / steps for r in ranks]
        log(f"[p] ({name}) launches a step and rank (expected {layers * TRAIN_MB}: {layers} layers x {TRAIN_MB} "
            f"microbatches): {per_step}")
        if any(n != layers * TRAIN_MB for v in per_step.values() for n in v):
            failures.append(f"({name}) launches {per_step}")
        schedule = "fill_drain" if name == "simple" else "1f1b"
        expected = _p_expected(schedule)
        for r in ranks:
            if r[name]["gauges"] != expected:
                failures.append(f"({name}) gauges {r[name]['gauges']} against {expected}")
        log(f"[p] ({name}) gauges {ranks[0][name]['gauges']} (the grid's: equal)")
    got, want = ranks[-1]["gpt2"]["eval"], base["gpt2"]["eval"]
    log(f"[p] (b) forward-only step (fill-drain) after 3 steps: loss {got:.6f} against pp = 1's {want:.6f}")
    if abs(got - want) / abs(want) > P_LOSS_TOL or ranks[0]["gpt2"]["eval"] != got:
        failures.append(f"(b) forward-only loss {got} against {want}")
    for r in ranks:
        if r["gpt2"]["eval_gauges"] != _p_expected("fill_drain"):
            failures.append(f"(b) forward-only gauges {r['gpt2']['eval_gauges']}")
    if full:
        ctl, want = ranks[-1]["control"]["losses"], base["gpt2"]["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(ctl, want))
        log(f"[p] (a) control, microbatch 0's backward dropped (its loss seed 0 on the last stage): losses {ctl} "
            f"against pp = 1's {want[:len(ctl)]}: max rel gap {gap:.3e}; caught by the bound {P_LOSS_TOL}: "
            f"{gap > P_LOSS_TOL}, by 1e-2: {gap > 1e-2}")
        if not gap > P_LOSS_TOL:
            failures.append(f"(a) control: dropping microbatch 0's backward moved the losses by only {gap:.3e}")
        card, cpu = ranks[-1]["small"]["card"], ranks[-1]["small"]["cpu"]
        gap = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
        log(f"[p] (d) 2-layer fp32 model at pp = 2, card against CPU: losses {card['losses']} vs {cpu['losses']}, "
            f"max |gap| {gap:.3e} (limit {P_SMALL_TOL})")
        if gap > P_SMALL_TOL:
            failures.append(f"(d) fp32 card against CPU {gap:.3e}")
    log(f"[p] ranks {ranks_s:.1f} s")
    if failures:
        raise RuntimeError("phase p: " + "; ".join(failures))
    return launches, ranks


def phase_pipe_nccl():
    """Phase p's (a) on two cards (``--phases t``): the stages on cuda:0 and
    cuda:1 over NCCL."""
    return phase_pipe(device=None, full=False)


def phase_j():
    """Serving replicas: two processes on cuda:0 over the native bus (gloo
    for their start only), GPT-2 124M engines. Holds (a)-(d)."""
    import shutil

    failures = []
    feed = os.path.join(J_DIR, "controller.jsonl")
    os.makedirs(J_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        s0, s1 = run_ranks(2, _j_serve_world, feed)
        serve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        f0, _ = run_ranks(2, _j_fail_world, killed=(1,))
        fail_s = time.perf_counter() - t0
        feed_kinds = [json.loads(line)["kind"] for line in open(feed)]
    finally:
        shutil.rmtree(J_DIR, ignore_errors=True)
    log(f"[J] GPT-2 124M engines ({J_SLOTS} slots, {J_BLOCKS} blocks), two processes on cuda:0 over the native "
        f"bus; world 1 (bf16: (c), (a), (d)) took {serve_s:.1f} s, world 2 (fp32: (b)) {fail_s:.1f} s with start-up")
    # (c)
    c = s0["c"]
    up, down = (c["events"] + [None, None])[:2]
    whole = all(len(c["results"][rid]) == n for rid, n in c["want"].items())
    log(f"[J] (c) SMP_AUTOSCALE burst of {len(c['want'])} requests ({c['sent']} dispatched) in {c['burst_s']:.2f} s: "
        f"events {[(e['direction'], round(e['seconds'], 3), {k: round(v, 3) for k, v in e['phases'].items()}) for e in c['events']]}; "
        f"warm start {up and up.get('warm')}; routed {c['routed']}; every request finished once with its tokens "
        f"{whole}; greedy margin {c['margin']:.3e} (limit {S_MARGIN}); feed {feed_kinds}; rank 1 served "
        f"{[len(x) for x in s1['served']]}")
    if not (up and up["direction"] == "up" and down and down["direction"] == "down" and len(c["events"]) == 2):
        failures.append(f"(c) scale events {c['events']}")
    elif up["warm"].get("fresh", 0) != 0 or up["warm"].get("disk_cache", 0) < 1:
        failures.append(f"(c) the standby's warm start {up['warm']}: wanted no nvcc build and a load from disk")
    if not whole or c["routed"].get("replica1", 0) < 1 or c["margin"] > S_MARGIN:
        failures.append("(c) a request was dropped, cut or duplicated, or never reached the standby")
    # (a)
    a = s0["a"]
    whole = all(len(a["results"][rid]) == n for rid, n in a["want"].items())
    log(f"[J] (a) phase S's burst ({len(a['want'])} requests) through RequestRouter over two live replicas: "
        f"{a['wall'] * 1e3:.2f} ms, {a['tokens']} tokens, {a['tokens'] / a['wall']:.1f} tokens/s; routed "
        f"{a['routed']}; every request whole {whole}; greedy margin {a['margin']:.3e} (limit {S_MARGIN})")
    if not whole or a["margin"] > S_MARGIN or min(a["routed"].values()) < 1:
        failures.append("(a) the router's burst")
    # (d)
    d = s0["d"]
    log(f"[J] (d) canary: unchanged weights {'promoted' if d['first'] and d['promotions'] == 1 else 'NOT promoted'}, "
        f"perturbed weights {'rolled back' if d['second'] is False and d['rollbacks'] == 1 else 'NOT rolled back'}; "
        f"serving version {d['version']}")
    if not (d["first"] and d["promotions"] == 1 and d["second"] is False and d["rollbacks"] == 1
            and d["version"] == 1):
        failures.append(f"(d) canary {d}")
    # (b)
    equal = all(f0["results"][rid] == f0["reference"][rid] for rid in f0["reference"])
    log(f"[J] (b) kill_replica@request=2:rank=1 (fp32 engines): the survivor finished "
        f"{sum(1 for v in f0['results'].values() if v)} of {len(f0['reference'])} requests, tokens equal to the "
        f"never-killed engine's (sampled {f0['sampled']} included) {equal}; MTTR {f0['mttr']:.3f} s, phases "
        f"{ {k: round(v, 3) for k, v in f0['phases'].items()} }; serve events {f0['events']}")
    if not equal or set(f0["phases"]) != {"detect", "readmit", "first_token"}:
        failures.append("(b) the failover")
    if failures:
        raise RuntimeError("phase J: " + "; ".join(failures))
    return {"threefry_bits": s0["threefry"] + s1["threefry"]}


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
    out.update(_phase_c_dropout())
    out.update(_phase_c_health())
    return out


def sass_loop_counts(sass, kernel, stores):
    """Instructions of ``kernel``'s grid-stride loop in ``cuobjdump -sass``
    text, by pipe (PIPE_LANES): the instructions from the loop's head to its
    back edge that every iteration issues, leaving out those a conditional
    forward branch can jump over (the division that a dropped element skips,
    its slow-path call), so the counts are a floor. Where loops nest (the
    dropout kernels' runs of an index map around the loop along a run) the
    innermost one, whose span holds no other back edge. ``kernel`` is a
    substring of the mangled name; the loop must hold ``stores`` global
    stores, one element's (an unrolled loop would hold more, and raises)."""
    section = next(sec for sec in sass.split("Function : ")[1:] if kernel in sec.splitlines()[0])
    code = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", section)]
    back = [(at, int(m.group(1), 16)) for at, ins in code
            if (m := re.search(r"BRA (?:!?U?P\d, )?0x([0-9a-f]+)", ins)) and int(m.group(1), 16) < at]
    inner = [(e, h) for e, h in back if not any(h <= h2 and e2 <= e and (e2, h2) != (e, h) for e2, h2 in back)]
    if len(inner) != 1:
        raise RuntimeError(f"{kernel}: expected one innermost loop, found back edges {back}")
    end, head = inner[0]
    skipped = set()
    for at, ins in code:
        m = re.match(r"@!?U?P\d+ BRA (?:!?U?P\d, )?0x([0-9a-f]+)", ins)
        if m and head <= at < end and at < int(m.group(1), 16) <= end:
            skipped.update(range(at + 16, int(m.group(1), 16), 16))
    body = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0] for at, ins in code if head <= at <= end and at not in skipped]
    if sum(op.startswith("STG") for op in body) != stores:
        raise RuntimeError(f"{kernel}: the loop does not store {stores} value(s) an iteration: {body}")
    counts = {"alu": sum(op.startswith(_ALU_OPS) for op in body), "imad": sum(op.startswith("IMAD") for op in body),
              "mufu": sum(op.startswith("MUFU") for op in body), "issue": len(body)}
    counts["fma"] = counts["imad"] + sum(op.startswith(_FP32_OPS) for op in body)
    return counts


def _issue_bound(nbytes, counts, n):
    """(bound ms, what bounds it, the binding pipe) of a kernel moving
    ``nbytes`` and issuing ``counts`` (``sass_loop_counts``) for each of its
    ``n`` elements: the larger of the bytes at PEAK_BYTES_PER_S and the
    busiest pipe at its PIPE_LANES on every SM."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    pipe = max(counts, key=lambda k: counts[k] / PIPE_LANES[k])
    t_ops = n * counts[pipe] / (PIPE_LANES[pipe] * H100_SMS * H100_CLOCK_HZ) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), pipe


def _sass(name):
    """``cuobjdump -sass`` of the built library ``name`` (csrc/<name>.cu)."""
    from smdistributed_modelparallel_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(_build._target(name)[1])], capture_output=True, text=True,
                          check=True).stdout


def _phase_c_dropout():
    """The dropout kernels at the smp.nn path's hidden activation ([2048,
    768] bf16, rate 0.1) and ``threefry_bits`` at phase A's Gumbel draw ([4,
    50257]) and at [2048, 768], all by CUDA-graph replay in one call: the
    wrapper as the path calls it, the plain versions and the library call
    ``F.dropout`` (Philox: other bits, the same bytes; its autograd
    backward), which the port never calls; no PyTorch call draws threefry
    bits, so ``threefry_bits`` has none. Bounds: the bytes each input and
    output moves once, and the instructions of each kernel's compiled loop
    (``sass_loop_counts`` of this build) on its busiest pipe."""
    import torch.nn.functional as F

    from smdistributed_modelparallel_tpu_torch.ops import dropout as dr
    from smdistributed_modelparallel_tpu_torch.utils import random

    sass = _sass("dropout")
    sass_counts = {"dropout_fwd": sass_loop_counts(sass, "dropout_fwd_kernelI13__nv_bfloat16Lb0E", 2),
                   "dropout_fwd_index_map": sass_loop_counts(sass, "dropout_fwd_kernelI13__nv_bfloat16Lb1E", 2),
                   "dropout_bwd": sass_loop_counts(sass, "dropout_bwd_kernelI13__nv_bfloat16", 1),
                   "threefry_bits": sass_loop_counts(sass, "threefry_bits_kernelILb0E", 1)}
    for name, c in sass_counts.items():
        log(f"[C] {name} (bf16) compiled loop, instructions an element (cuobjdump, always issued): {c}")
    counters = {**_dropout_counters(), **_shard_counters()}
    saved = {k: fn.launches for k, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = random.key(SEED)
    N, D, rate = TRAIN_BATCH // TRAIN_MB * TRAIN_SEQ, LM_CFG["hidden_size"], 0.1
    n = N * D
    x = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
    y, mask = dr.dropout_fwd(x, rate, k)
    _, keep = dr.reference_dropout_fwd(x, rate, k)
    out = {}
    rows = (
        ("dropout_fwd", lambda: dr.dropout_fwd(x, rate, k), lambda: dr.reference_dropout_fwd(x, rate, k),
         cuda_graph_time_ms(lambda: F.dropout(x, rate, training=True)), n * (2 + 2 + 1)),
        ("dropout_bwd", lambda: dr.dropout_bwd(dy, mask, rate), lambda: dr.reference_dropout_bwd(dy, keep, rate),
         library_bwd_ms(lambda t: F.dropout(t, rate, training=True), (x,), dy), n * (2 + 1 + 2)),
    )
    for name, kernel, plain, library_ms, nbytes in rows:
        ms = cuda_graph_time_ms(kernel)
        plain_ms = cuda_graph_time_ms(plain, iters=5, replays=2)
        bound_ms, bound_by, pipe = _issue_bound(nbytes, sass_counts[name], n)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                         eager_ms=cuda_time_ms(kernel))
        log(f"[C] {name} [{N}, {D}] bf16 rate {rate}, device ms by CUDA-graph replay: the wrapper {ms:.4f} "
            f"({bound_ms / ms:.1%} of the bound), plain {plain_ms:.4f}, library (F.dropout, Philox) {library_ms:.4f}; "
            f"the wrapper eager {out[name]['eager_ms']:.4f} (CUDA events); bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes / 1e6:.2f} MB; busiest pipe {pipe}, {sass_counts[name][pipe]} an element)")

    # The index-mapped forward at a tp = 2 rank's T block of a microbatch's [2,
    # 1024, 768] hidden activation (phase N (h), the memory layout): 2 runs of
    # 512 x 768 at stride 1024 x 768; its library call F.dropout on the block.
    Bm, Tm = TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ
    xs = torch.randn((Bm, Tm // 2, D), generator=gen, device="cuda").to(torch.bfloat16)
    index = (Tm // 2 * D, Tm // 2 * D, Tm * D)
    ns = xs.numel()
    ms = cuda_graph_time_ms(lambda: dr.dropout_fwd(xs, rate, k, index))
    plain_ms = cuda_graph_time_ms(lambda: dr.reference_dropout_fwd(xs, rate, k, index), iters=5, replays=2)
    library_ms = cuda_graph_time_ms(lambda: F.dropout(xs, rate, training=True))
    nbytes = ns * (2 + 2 + 1)
    bound_ms, bound_by, pipe = _issue_bound(nbytes, sass_counts["dropout_fwd_index_map"], ns)
    out["dropout_fwd_index_map"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)
    log(f"[C] dropout_fwd with the index map, a tp rank's T block {list(xs.shape)} of [{Bm}, {Tm}, {D}] bf16 rate "
        f"{rate}, by CUDA-graph replay: the wrapper {ms:.4f} ({bound_ms / ms:.1%} of the bound), plain {plain_ms:.4f}, "
        f"library (F.dropout, Philox) {library_ms:.4f}; bound {bound_ms:.4f} ms by {bound_by} (busiest pipe {pipe})")

    for label, n_bits in (("Gumbel draw [4, 50257]", 4 * 50257), (f"[{N}, {D}]", n)):
        ms = cuda_graph_time_ms(lambda: dr.threefry_bits(k, n_bits, device="cuda"))
        plain_ms = cuda_graph_time_ms(lambda: dr.reference_threefry_bits(k, n_bits, device="cuda"), iters=5, replays=2)
        bound_ms, bound_by, pipe = _issue_bound(n_bits * 4, sass_counts["threefry_bits"], n_bits)
        log(f"[C] threefry_bits {label} ({n_bits} elements), device ms by CUDA-graph replay: the wrapper {ms:.4f} "
            f"({bound_ms / ms:.1%} of the bound), plain {plain_ms:.4f}; bound {bound_ms:.4f} ms by {bound_by} "
            f"(busiest pipe {pipe})")
        if "threefry_bits" not in out:  # the kernels line takes the main path's shape
            out["threefry_bits"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                                        bound_by=bound_by)
        else:
            out["threefry_bits"].update(path_mask_ms=ms, path_mask_bound_ms=bound_ms)
    for key, fn in counters.items():
        fn.launches = saved[key]  # timing launches do not count
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
    # The tp = 2 ring's QKV chunk (phase N (g)): a microbatch's sequence block
    # of 2 x 512 rows against the rank's 6 heads, [1024, 768] x [768, 1152].
    N, Fo = TRAIN_BATCH // TRAIN_MB * TRAIN_SEQ // 2, 3 * LM_CFG["hidden_size"] // 2
    x, w, b = mb_inputs(N, D, Fo, dtype, gen, {})
    route = mb._route(dtype, D, x.data_ptr(), w.data_ptr())
    ms = cuda_graph_time_ms(lambda: matmul_bias_fwd(x, w, b))
    plain_ms = cuda_graph_time_ms(lambda: reference_matmul_bias(x, w, b))
    library_ms = cuda_graph_time_ms(lambda: torch.addmm(b, x, w.t()))
    nbytes, flops = (N * D + Fo * D + Fo + N * Fo) * esz, 2 * N * D * Fo
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    out["matmul_bias"].update(ring_chunk_ms=ms, ring_chunk_plain_ms=plain_ms, ring_chunk_library_ms=library_ms,
                              ring_chunk_bound_ms=bound_ms, ring_chunk_route=route)
    log(f"[C] matmul_bias at the tp = 2 ring's QKV chunk N={N} D={D} F={Fo} bf16, by CUDA-graph replay: the wrapper "
        f"({route}) {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, library (torch.addmm) "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")

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
    # Phase G's decode step: the fused QKV and the MLP epilogue at N = 4 (its
    # batch) and 8 rows, bf16, the wrapper, its plain version and the library
    # call by graph replay. The bound is the bytes' (the weight dominates).
    for N in (4, 8):
        D, Fo = 768, 2304
        x, w, b = mb_inputs(N, D, Fo, dtype, gen, {})
        nbytes, flops = (N * D + Fo * D + Fo + N * Fo) * esz, 2 * N * D * Fo
        bound_ms, bound_by = _bound(nbytes, flops, dtype)
        mbt = dict(ms=cuda_graph_time_ms(lambda: matmul_bias_fwd(x, w, b)),
                   plain_ms=cuda_graph_time_ms(lambda: reference_matmul_bias(x, w, b)),
                   library_ms=cuda_graph_time_ms(lambda: torch.addmm(b, x, w.t())), bound_ms=bound_ms,
                   bound_by=bound_by, route=mb._route(dtype, D, x.data_ptr(), w.data_ptr()))
        out["matmul_bias"][f"decode_n{N}"] = mbt
        Fo = 3072
        xg, bgl, _ = gelu_inputs(N, Fo, dtype, gen, {})
        bound_ms, bound_by = _bound(2 * N * Fo * esz + Fo * esz, 10 * N * Fo, torch.float32)
        bgt = dict(ms=cuda_graph_time_ms(lambda: bg.bias_gelu_fwd(xg, bgl)),
                   plain_ms=cuda_graph_time_ms(lambda: bg.reference_bias_gelu(xg, bgl)),
                   library_ms=cuda_graph_time_ms(lambda: gelu(xg, bgl)), bound_ms=bound_ms, bound_by=bound_by,
                   route=bg._route(dtype, Fo, xg.data_ptr()))
        out["bias_gelu_fwd"][f"decode_n{N}"] = bgt
        for name, t, shape in (("matmul_bias", mbt, f"N={N} D=768 F=2304"), ("bias_gelu_fwd", bgt, f"[{N}, 3072]")):
            log(f"[C] {name} at phase G's decode shape {shape} bf16, graph replay: the wrapper ({t['route']}) "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}; bound {t['bound_ms']:.6f} "
                f"ms by {t['bound_by']}")
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


# Phase O: observability (telemetry, flight recorder, timeline, memory
# metrics, goodput, profiling, the serving time series), each run in a child
# process so env vars, singletons and at-exit dumps stay apart.
O_STEPS = 12
O_PROFILE = (10, 11)                  # SMP_PROFILE's window
O_TIMED = (2, 10)                     # ms/step over steps 2-9, before the capture
O_BLOCKS = ("off", "on", "on", "off")  # the in-process alternation of the overhead blocks
O_BLOCK_STEPS = (2, 4)                # a block's warm-up and timed steps
O_FLOP_TOL = 0.02                     # roofline FLOPs against torch's flop counter
O_SLO = "ttft_p99_ms=5000,itl_p99_ms=100"
O_KERNELS = {"flash_fwd": "flash_fwd_wgmma_kernel", "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel", "bias_gelu_fwd": "bias_gelu_fwd_vec_kernel",
             "bias_gelu_bwd": "bias_gelu_bwd_vec_kernel", "matmul_bias": "matmul_bias_wgmma_kernel"}
O_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_obs")


def _o_env(kind, out):
    """The observability variables of an "on" child of ``kind``."""
    if kind == "train":
        return {"SMP_TELEMETRY_PATH": os.path.join(out, "telemetry.json"),
                "SMP_TIMELINE_PATH": os.path.join(out, "timeline.json"),
                "SMP_FLIGHT_RECORDER_PATH": os.path.join(out, "ring.jsonl"),
                "SMP_WRITE_STEP_MEMORY_METRICS": "1",
                "SMP_STEP_MEMORY_METRICS_PATH": os.path.join(out, "memory.jsonl"),
                "SMP_GOODPUT": "1", "SMP_PROFILE": f"steps={O_PROFILE[0]}:{O_PROFILE[1]}",
                "SMP_PROFILE_PATH": os.path.join(out, "profile"), "SMP_WATCHDOG_TIMEOUT": "300",
                "SMP_WATCHDOG_PATH": os.path.join(out, "watchdog.json")}
    return {"SMP_TIMESERIES_INTERVAL": "0.5", "SMP_TIMESERIES_PATH": os.path.join(out, "windows.jsonl"),
            "SMP_SLO": O_SLO, "SMP_TELEMETRY_PATH": os.path.join(out, "telemetry.json")}


_O_VARS = set(_o_env("train", "")) | set(_o_env("serve", ""))


def _o_flops_plain(init_state, ids):
    """``torch.utils.flop_counter``'s count of one step of phase L's model on
    the plain path (``use_pallas_kernels: False``: every product an aten op
    the counter sees), forward and backward."""
    import smdistributed_modelparallel_tpu_torch as smp
    from torch.utils.flop_counter import FlopCounterMode

    model, optimizer, train_step = _lm_setup(init_state, False, "cuda", use_pallas_kernels=False)
    with FlopCounterMode(display=False) as counter:
        train_step(model, ids)
    torch.cuda.synchronize()
    del model, optimizer, train_step
    smp.reset()
    torch.cuda.empty_cache()
    return counter.get_total_flops()


def _o_overhead(module, ids):
    """The observability overhead in one process: blocks of phase L's step
    of ``module`` with every O1 variable but the capture's off and on, in
    turns (``O_BLOCKS``), each its own ``smp.init``, ``DistributedModel`` and
    AdamW, so the host's speed holds for both sides. Returns each block's
    ms/step, by side."""
    import smdistributed_modelparallel_tpu_torch as smp

    on_env = {k: v for k, v in _o_env("train", os.path.join(O_DIR, "train", "overhead")).items()
              if not k.startswith("SMP_PROFILE")}
    times = {"off": [], "on": []}
    for side in O_BLOCKS:
        with _env(**{k: v if side == "on" else None for k, v in on_env.items()}):
            _lm_init(True)
            model = smp.DistributedModel(module, device="cuda")
            optimizer, train_step = _lm_optimizer_step(model)
            for n in range(sum(O_BLOCK_STEPS)):
                if n == O_BLOCK_STEPS[0]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                train_step(model, ids)
                optimizer.step()
            torch.cuda.synchronize()
            times[side].append((time.perf_counter() - t0) * 1e3 / O_BLOCK_STEPS[1])
            del model, optimizer, train_step
            smp.shutdown()
    return times


def phase_o_child_train(on):
    """O1's run: 20 steps of phase L's fused path; prints ``O_CHILD {json}``."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    # _lm_setup's parts, timed apart: the goodput ledger's "startup" runs
    # from smp.init to the first step.
    marks = [time.perf_counter()]
    _lm_init(True)
    marks.append(time.perf_counter())
    module = smp.nn.DistributedTransformerLMHead(**LM_CFG, fused_bias_gelu=True, device="meta")
    module.load_state_dict({k: v.clone() for k, v in init_state.items()}, assign=True)
    marks.append(time.perf_counter())
    model = smp.DistributedModel(module, device="cuda")
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    optimizer, train_step = _lm_optimizer_step(model)
    marks.append(time.perf_counter())
    t_setup, setup_s = marks[0], marks[-1] - marks[0]
    setup_split = dict(zip(("init", "module", "model", "optimizer"), np.diff(marks).tolist()))
    counters = {**_flash_counters(), **_new_counters()}
    for fn in counters.values():
        fn.launches = 0
    losses, window, timed = [], None, {}
    for n in range(O_STEPS):
        if n == O_TIMED[0]:
            torch.cuda.synchronize()
            timed["t0"] = time.perf_counter()
        if n == O_TIMED[1]:
            torch.cuda.synchronize()
            timed["t1"] = time.perf_counter()
        if n == O_PROFILE[0]:
            window = {k: fn.launches for k, fn in counters.items()}
        losses.append(train_step(model, ids).reduce_mean())
        if n == O_PROFILE[1]:
            window = {k: fn.launches - window[k] for k, fn in counters.items()}
        if n == O_STEPS - 1:
            peak = torch.cuda.max_memory_allocated()  # what the step's end edge just read
        optimizer.step()
    torch.cuda.synchronize()
    out = dict(losses=[float(x) for x in losses], peak=peak, window=window, setup_s=setup_s, setup_split=setup_split,
               steps_s=time.perf_counter() - t_setup - setup_s,
               launches={k: fn.launches for k, fn in counters.items()},
               ms=(timed["t1"] - timed["t0"]) * 1e3 / (O_TIMED[1] - O_TIMED[0]))
    if on:
        led = smp.goodput.ledger
        now = led._clock()
        secs, wall = led.seconds(now), led.wall_seconds(now)
        out.update(goodput=dict(seconds=secs, wall=wall, fraction=led.goodput_fraction(now)),
                   trace=smp.profiling.capture.last_trace)
    del model, optimizer, train_step
    t0 = time.perf_counter()
    smp.shutdown()
    out["shutdown_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if not on:
        t0 = time.perf_counter()
        out["plain_flops"] = _o_flops_plain(init_state, ids)
        out["flops_s"] = time.perf_counter() - t0
        os.makedirs(os.path.join(O_DIR, "train", "overhead"), exist_ok=True)
        t0 = time.perf_counter()
        out["blocks"] = _o_overhead(module, ids)
        out["blocks_s"] = time.perf_counter() - t0
    print("O_CHILD " + json.dumps(out), flush=True)


def phase_o_child_serve(on):
    """O2's run: phase S's burst on GPT-2 124M; prints ``O_CHILD {json}``."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    smp.init({"bf16": True})
    g = torch.Generator(device="cuda").manual_seed(SEED)
    module = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
    model = smp.DistributedModel(module, device="cuda")
    engine = ServingEngine(model, max_slots=S_SLOTS, num_blocks=S_BLOCKS)
    engine.run(s_requests(module.vocab_size, n=2, n_sampled=1, prompt=(40, 40), new=(4, 4), seed=SEED + 2,
                          prefix="warm"))
    reqs = s_requests(module.vocab_size)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    wall = time.perf_counter() - t0
    served = sum(len(v) for v in engine.results.values())  # the warm-up's streams included
    if on:
        engine.timeseries.sample()  # the last, partial window
    engine.close()
    smp.shutdown()
    print("O_CHILD " + json.dumps(dict(results={r.request_id: results[r.request_id] for r in reqs}, wall=wall,
                                       served=served)), flush=True)


def _o_child(kind, on, out):
    """Run one O child (``--o-child kind:on|off``) with its variables set
    (on) or unset (off); return its result."""
    env = {k: v for k, v in os.environ.items() if k not in _O_VARS}
    if on:
        env.update(_o_env(kind, out))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--o-child", f"{kind}:{'on' if on else 'off'}"],
                         capture_output=True, text=True, timeout=600, env=env)
    if res.returncode != 0:
        raise RuntimeError(f"phase O {kind} child ({'on' if on else 'off'}) exited {res.returncode}:\n"
                           f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    child = json.loads(next(ln for ln in res.stdout.splitlines() if ln.startswith("O_CHILD "))[8:])
    child["child_s"] = time.perf_counter() - t0
    return child


def _o_metric(doc, name, **labels):
    for s in doc["metrics"].get(name, {}).get("series", []):
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return None


def _o_script(name, *args):
    res = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", name),
                          *map(str, args)], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"scripts/{name} exited {res.returncode} on phase O's dumps:\n{res.stderr[-3000:]}")
    return res.stdout


def _o_trace_split(path, steps):
    """Host time by ``smp_phase/*`` region and device time by kernel in the
    Chrome trace ``path`` of ``steps`` steps, each a mean a step (ms), and
    each kernel's count over the trace."""
    events = json.loads(open(path).read())["traceEvents"]
    host, device, counts = {}, {}, {}
    for e in events:
        name, dur = e.get("name", ""), e.get("dur", 0) / 1e3
        if e.get("cat") in ("user_annotation", "cpu_op", "python_function") and name.startswith("smp_phase/"):
            host[name] = host.get(name, 0.0) + dur / steps
        elif e.get("cat") == "kernel":
            device[name] = device.get(name, 0.0) + dur / steps
            counts[name] = counts.get(name, 0) + 1
    return host, device, counts


def phase_o():
    """O1 and O2 (see the module docstring); returns O1's on-run launches
    (its 20 steps, counted from 0 just before the first)."""
    import shutil

    shutil.rmtree(O_DIR, ignore_errors=True)
    os.makedirs(O_DIR)
    try:
        return _phase_o()
    finally:
        shutil.rmtree(O_DIR, ignore_errors=True)


def _phase_o():
    t_phase = time.perf_counter()
    train_dir, serve_dir = os.path.join(O_DIR, "train"), os.path.join(O_DIR, "serve")
    os.makedirs(train_dir)
    os.makedirs(serve_dir)
    off = _o_child("train", False, train_dir)
    on = _o_child("train", True, train_dir)
    log(f"[O1] smp.nn GPT-2 124M, {O_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} microbatches, "
        f"fused: observability off {off['ms']:.2f} ms/step, on {on['ms']:.2f} ms/step (steps {O_TIMED[0]}-"
        f"{O_TIMED[1] - 1}, before the capture), on/off {on['ms'] / off['ms']:.4f}; children {off['child_s']:.1f} s "
        f"and {on['child_s']:.1f} s (model set-up {off['setup_s']:.1f} / {on['setup_s']:.1f} s, 20 steps "
        f"{off['steps_s']:.1f} / {on['steps_s']:.1f} s, shutdown {off['shutdown_s']:.2f} / {on['shutdown_s']:.2f} s, "
        f"the flop count {off['flops_s']:.1f} s); on's set-up: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in on["setup_split"].items()))
    blocks = off["blocks"]
    ratio = np.mean(blocks["on"]) / np.mean(blocks["off"])
    log(f"[O1] overhead in one process ({O_BLOCK_STEPS[1]} timed steps a block after {O_BLOCK_STEPS[0]}, blocks "
        f"{' '.join(O_BLOCKS)}, the capture off; {off['blocks_s']:.1f} s): off "
        + ", ".join(f"{t:.2f}" for t in blocks["off"]) + " ms/step, on " + ", ".join(f"{t:.2f}" for t in blocks["on"])
        + f" ms/step; on/off {ratio:.4f}")
    failures = []
    # (a) observability reads and never alters.
    if on["losses"] != off["losses"]:
        failures.append(f"(a) losses differ: on {on['losses']} off {off['losses']}")
    log(f"[O1] (a) 20 losses bit-equal on and off: {on['losses'] == off['losses']}; last {on['losses'][-1]:.6f}")
    doc = json.loads(open(os.path.join(train_dir, "telemetry.json")).read())
    # (b)
    steps = _o_metric(doc, "smp_step_total")
    if steps != O_STEPS:
        failures.append(f"(b) smp_step_total {steps}, expected {O_STEPS}")
    # (c) the peak-memory gauge is the allocator's peak.
    gauge = _o_metric(doc, "smp_device_peak_hbm_bytes", device="cuda:0")
    log(f"[O1] (b) smp_step_total {steps}; (c) smp_device_peak_hbm_bytes{{device=cuda:0}} {gauge} against "
        f"torch.cuda.max_memory_allocated() {on['peak']} ({on['peak'] / 2**30:.3f} GiB)")
    if gauge != on["peak"]:
        failures.append(f"(c) peak gauge {gauge} != max_memory_allocated {on['peak']}")
    # (d) every second of the ledger's wall lands in one state.
    gp = on["goodput"]
    total = sum(gp["seconds"].values())
    log(f"[O1] (d) goodput: wall {gp['wall']:.3f} s, states sum {total:.3f} s, fraction {gp['fraction']:.4f}; "
        + ", ".join(f"{k} {v / gp['wall']:.4f}" for k, v in sorted(gp["seconds"].items(), key=lambda kv: -kv[1])))
    if abs(total - gp["wall"]) > 1e-6 * max(gp["wall"], 1.0):
        failures.append(f"(d) goodput states sum to {total}, the ledger's wall is {gp['wall']}")
    # (e) the capture names the path's kernels as often as they were launched.
    n_win = O_PROFILE[1] - O_PROFILE[0] + 1
    host, device, counts = _o_trace_split(on["trace"], n_win)
    traced = {k: sum(c for name, c in counts.items() if kernel in name) for k, kernel in O_KERNELS.items()}
    log(f"[O1] (e) trace {os.path.relpath(on['trace'], O_DIR)}: kernel counts {traced}; launch counters over steps "
        f"{O_PROFILE[0]}-{O_PROFILE[1]} {on['window']}")
    if traced != on["window"] or not all(traced.values()):
        failures.append(f"(e) traced kernels {traced} != launches {on['window']}")
    busy = sum(device.values())
    log(f"[O1] region split, mean of the {n_win} captured steps: host "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(host.items(), key=lambda kv: -kv[1]))
        + f"; device busy {busy:.2f} ms")
    for name, ms in sorted(device.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[O1]   {ms:9.3f} ms  x{counts[name] // n_win:<4d} {name[:90]}")
    # (f) the sampled roofline.
    mfu = _o_metric(doc, "smp_mfu", step="step")
    flops = _o_metric(doc, "smp_roofline_flops", step="step")
    rel = abs(flops - off["plain_flops"]) / off["plain_flops"] if flops else float("inf")
    log(f"[O1] (f) smp_mfu {mfu} (last sampled step; peaks {_o_metric(doc, 'smp_roofline_peak_flops_per_s', step='step')} "
        f"FLOP/s), roofline FLOPs {flops} against torch.utils.flop_counter's {off['plain_flops']} over one plain-path "
        f"step: rel diff {rel:.3e} (limit {O_FLOP_TOL})")
    if not (mfu is not None and 0 < mfu <= 1) or rel > O_FLOP_TOL:
        failures.append(f"(f) smp_mfu {mfu}, FLOPs rel diff {rel}")
    # (g) the stdlib scripts read the dumps.
    report = _o_script("telemetry_report.py", os.path.join(train_dir, "telemetry.json"))
    _o_script("trace_fuse.py", "-o", os.path.join(train_dir, "fused.json"), os.path.join(train_dir, "timeline.json"),
              os.path.join(train_dir, "ring.jsonl"), os.path.join(train_dir, "telemetry.json"))
    _o_script("perf_ledger.py", "--repo", train_dir)
    for line in report.splitlines():
        if any(w in line for w in ("steps:", "MFU", "peak HBM", "goodput")):
            log(f"[O1] (g) telemetry_report: {line.strip()}")
    launches = {**{k: 0 for k in _flash_counters()}, **on["launches"]}
    want = O_STEPS * LM_CFG["num_layers"] * TRAIN_MB
    if any(n != want for n in on["launches"].values()):
        failures.append(f"launches over the {O_STEPS} steps {on['launches']}, expected {want} each")

    # The burst with every variable off is phase S's when it ran in this call
    # (the same model, weights and requests), else a child of its own.
    if _S_BF16:
        s_off = dict(results=_S_BF16["results"], wall=_S_BF16["numbers"]["wall_ms"] / 1e3, child_s=0.0, src="phase S")
    else:
        s_off = dict(_o_child("serve", False, serve_dir), src="a child")
    s_on = _o_child("serve", True, serve_dir)
    windows = [json.loads(ln) for ln in open(os.path.join(serve_dir, "windows.jsonl"))]
    gen = sum(w["tokens_generated"] for w in windows)
    log(f"[O2] phase S's burst: {sum(len(v) for v in s_on['results'].values())} tokens; off ({s_off['src']}) "
        f"{s_off['wall'] * 1e3:.1f} ms, on {s_on['wall'] * 1e3:.1f} ms; tokens equal: "
        f"{s_on['results'] == s_off['results']}; {len(windows)} windows, generated deltas sum {gen} against "
        f"{s_on['served']} served (warm-up included); children {s_off['child_s']:.1f} s and {s_on['child_s']:.1f} s")
    for w in windows:
        slo = w.get("slo", {})
        log(f"[O2]   window {w['seq']}: {w['window_s']:.3f} s, {w['tokens_per_s']:.1f} tokens/s, "
            f"{w['requests_per_s']:.2f} requests/s, ttft p99 {w.get('ttft_p99_ms', float('nan')):.1f} ms, itl p99 "
            f"{w.get('itl_p99_ms', float('nan')):.2f} ms, SLO ok {slo.get('ok')} {sorted(slo.get('violations', {}))}")
    if s_on["results"] != s_off["results"]:
        failures.append("O2: the burst's tokens differ with the time series on")
    if gen != s_on["served"]:
        failures.append(f"O2: windows' generated deltas sum to {gen}, {s_on['served']} tokens served")
    slo = _o_script("slo_report.py", os.path.join(serve_dir, "windows.jsonl"))
    for line in slo.splitlines()[-4:]:
        log(f"[O2] slo_report: {line.strip()}")
    log(f"[O] phase O {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise RuntimeError("phase O: " + "; ".join(failures))
    return launches


# ----------------------------------------------------------------------
# Phase V: resilience (the health sentinel, OOM post-mortem, preemption,
# chaos, supervisor, fleet) on phase L's model and phase S's burst
# ----------------------------------------------------------------------

V_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_resilience")
V_BLOCKS = ("off", "cheap", "cheap", "off")  # V1's in-process alternation
V_BLOCK_STEPS = (2, 4)                      # a block's warm-up and timed steps
V_FULL_STEPS = 4
V_POISON = ("transformer.seq_layers.5.output.fc.weight", (0, 0))  # layer 5's MLP weight, one element
V_LAYER_FAULT = "transformer/seq_layers/__call__/0/0/0"  # the scanned stack's output (the CPU parity test's kind)
V_BAD_ROW = (4, 7)                          # a row of microbatch 2 of 4 (rows 4-5 of 8)
V_CALLS = 6                                 # the uninterrupted run; the preempted run saves at its third call
V_WEDGE_MS = 500
V_FLEET_INTERVAL = "0.5"


def _v_init():
    """Phase L's weights and batch from the seed (as O1's child draws them)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn.transformer import init_weights_

    g = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_weights_(smp.nn.DistributedTransformerLMHead(**LM_CFG, device="cuda"), LM_CFG["initializer_range"], g)
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    ids = torch.randint(0, LM_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    return init_state, ids


def _v_calls(model, optimizer, train_step, ids, n, out=None):
    """``n`` calls of the step and the optimizer; the losses as Python floats,
    each also printed (``V_LOSS``) when ``out`` is a child's stdout."""
    losses = []
    for _ in range(n):
        losses.append(float(train_step(model, ids).reduce_mean()))
        optimizer.step()
        if out is not None:
            print(f"V_LOSS {losses[-1]!r}", file=out, flush=True)
    return losses


def phase_v_child(spec):
    """V4's children (``--v-child KIND:DIR``): ``preempt`` trains under the
    parent's ``SMP_CHAOS=sigterm@step=3`` (the emergency save exits the
    process), ``file`` trains until the parent touches ``SMP_PREEMPTION_FILE``
    (after its second call), ``resume`` resumes DIR's newest checkpoint and
    trains three calls."""
    import smdistributed_modelparallel_tpu_torch as smp

    ckpt_mod = importlib.import_module("smdistributed_modelparallel_tpu_torch.checkpoint")  # smp.checkpoint is remat
    kind, root = spec.split(":", 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_state, ids = _v_init()
    save = ckpt_mod.save_checkpoint

    def timed_save(*args, **kw):  # the emergency save, timed; the process exits right after it
        t0 = time.perf_counter()
        out = save(*args, **kw)
        print("V_SAVE " + json.dumps(dict(seconds=time.perf_counter() - t0, tag=kw.get("tag"),
                                          user=kw.get("user_content"))), flush=True)
        return out

    ckpt_mod.save_checkpoint = timed_save
    if kind == "resume":
        _lm_init(True)
        user = smp.resume_from_checkpoint(root)
        step_count = smp.state.step_count
        model = smp.DistributedModel(_k_other_model(SEED + 1), device="cuda")  # the stashed state overwrites it
        optimizer, train_step = _lm_optimizer_step(model)
        losses = _v_calls(model, optimizer, train_step, ids, 3)
        print("V_CHILD " + json.dumps(dict(user=user, step_count=step_count, losses=losses)), flush=True)
        return 0
    model, optimizer, train_step = _lm_setup(init_state, True, "cuda")
    if kind == "file":
        _v_calls(model, optimizer, train_step, ids, 2, out=sys.stdout)
        print("V_READY", flush=True)
        deadline = time.monotonic() + 120
        while not os.path.exists(os.environ["SMP_PREEMPTION_FILE"]) and time.monotonic() < deadline:
            time.sleep(0.05)
    _v_calls(model, optimizer, train_step, ids, V_CALLS, out=sys.stdout)
    print("V_NOT_PREEMPTED", flush=True)  # reached only if no emergency save exited the process
    return 3


def _v_child(kind, root, env, ready=None):
    """Run one V4 child with ``env`` added; when it prints ``V_READY``, call
    ``ready()``. Returns (exit code, its stdout lines, its wall seconds)."""
    t0 = time.perf_counter()
    err_path = os.path.join(V_DIR, f"{kind}.stderr")
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--v-child", f"{kind}:{root}"],
                                stdout=subprocess.PIPE, stderr=err_file, text=True, env={**os.environ, **env})
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if line.startswith("V_READY") and ready is not None:
                    ready()
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    err = open(err_path).read()
    if proc.returncode != 0:
        raise RuntimeError(f"phase V {kind} child exited {proc.returncode}:\n" + "\n".join(lines[-20:])
                           + f"\n{err[-4000:]}")
    return lines, time.perf_counter() - t0


def _v_tagged(lines, tag):
    return [ln[len(tag) + 1:] for ln in lines if ln.startswith(tag + " ")]


def _v1_block(init_state, ids, mode, steps, spy=None):
    """One V1 block: its own ``smp.init``, model and AdamW from the same
    weights, ``steps`` calls under ``SMP_HEALTH_CHECK=mode``, counted
    with ``torch.cuda.set_sync_debug_mode("warn")`` on."""
    import warnings

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.ops.health_reduce import health_reduce
    from smdistributed_modelparallel_tpu_torch.utils import health

    with _env(SMP_HEALTH_CHECK=None if mode == "off" else mode), \
            (mock.patch.object(health.HealthCollector, "pack", spy) if spy else contextlib.nullcontext()):
        model, optimizer, train_step = _lm_setup(init_state, True, "cuda")
        health_reduce.launches = 0
        losses, t0 = [], None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for n in range(steps):
                    if n == V_BLOCK_STEPS[0]:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    losses.append(train_step(model, ids).reduce_mean())
                    optimizer.step()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # torch's warning at each synchronizing tensor operation (.item(),
        # a copy to the host, ...); not the mode's one-time "prototype" notice.
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
        mon = health.monitor
        out = dict(losses=[float(x) for x in losses], syncs=len(syncs), sync_kinds=sorted(set(syncs)),
                   launches=health_reduce.launches, checked=list(mon.checked_steps), pending=mon.pending_step,
                   last=mon.last_check, ms=(t1 - t0) * 1e3 / (steps - V_BLOCK_STEPS[0]) if t0 else None,
                   kept_bytes=sum(p.numel() * 2 for p in model.parameters()))
        del model, optimizer, train_step
        smp.reset()
    torch.cuda.empty_cache()
    return out


def _v1(init_state, ids, failures):
    """The sentinel: blocks off, cheap, cheap, off, then full (V1)."""
    from smdistributed_modelparallel_tpu_torch.ops.health_reduce import health_reduce, reference_health_reduce
    from smdistributed_modelparallel_tpu_torch.utils import health

    steps = sum(V_BLOCK_STEPS)
    captured = []
    pack = health.HealthCollector.pack

    def spy(self, group=None):  # the last step's entries, for the kernel's time a step
        captured[:] = [list(self.entries)]
        return pack(self, group)

    blocks = [_v1_block(init_state, ids, mode, steps, spy=spy if i == 2 else None) for i, mode in enumerate(V_BLOCKS)]
    full = _v1_block(init_state, ids, "full", V_FULL_STEPS)
    off = [b for b, m in zip(blocks, V_BLOCKS) if m == "off"]
    cheap = [b for b, m in zip(blocks, V_BLOCKS) if m == "cheap"]
    ms_off, ms_cheap = np.mean([b["ms"] for b in off]), np.mean([b["ms"] for b in cheap])
    log(f"[V1] smp.nn GPT-2 124M, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} microbatches, fused, bf16: "
        f"{V_BLOCK_STEPS[1]} timed steps a block after {V_BLOCK_STEPS[0]}, blocks {' '.join(V_BLOCKS)}: off "
        + ", ".join(f"{b['ms']:.2f}" for b in off) + " ms/step, cheap " + ", ".join(f"{b['ms']:.2f}" for b in cheap)
        + f" ms/step; cheap/off {ms_cheap / ms_off:.4f}")
    # (a) the sentinel only reads.
    for b, mode in zip(blocks + [full], V_BLOCKS + ("full",)):
        want = off[0]["losses"][:len(b["losses"])]
        if b["losses"] != want:
            failures.append(f"V1 (a) {mode} losses {b['losses']} != off {want}")
    log(f"[V1] (a) losses bit-equal across blocks and full: "
        f"{all(b['losses'] == off[0]['losses'][:len(b['losses'])] for b in blocks + [full])}; last "
        f"{off[0]['losses'][-1]:.6f}")
    # (b) one step behind in cheap, synchronous in full; (c) the tags; (e) one launch a step.
    for b in cheap:
        if b["checked"] != list(range(steps - 1)) or b["pending"] != steps - 1:
            failures.append(f"V1 (b) cheap checked {b['checked']} pending {b['pending']}")
    if full["checked"] != list(range(V_FULL_STEPS)) or full["pending"] is not None:
        failures.append(f"V1 (b) full checked {full['checked']} pending {full['pending']}")
    for b, want in ((cheap[-1], {"loss", "outputs", "grads"}), (full, {"loss", "outputs", "grads", "params"})):
        tags = b["last"]["tags"]
        if set(tags) != want or any(d["bad"] != 0 for d in tags.values()):
            failures.append(f"V1 (c) tags {tags}")
    log(f"[V1] (b) cheap checked steps {cheap[-1]['checked']} (pending {cheap[-1]['pending']}), full "
        f"{full['checked']} (pending {full['pending']}); (c) cheap tags "
        + ", ".join(f"{k} bad {d['bad']:g} absmax {d['absmax']:.6g}" for k, d in cheap[-1]["last"]["tags"].items())
        + "; full adds params absmax " + f"{full['last']['tags']['params']['absmax']:.6g}")
    # (d) no synchronizing call the off blocks do not make.
    worst_cheap, least_off = max(b["syncs"] for b in cheap), min(b["syncs"] for b in off)
    log(f"[V1] (d) synchronizing calls a block (sync debug mode 'warn', {steps} steps): off "
        f"{[b['syncs'] for b in off]} {off[0]['sync_kinds']}, cheap {[b['syncs'] for b in cheap]} "
        f"{cheap[0]['sync_kinds']}, full {full['syncs']}")
    if worst_cheap > least_off:
        failures.append(f"V1 (d) cheap blocks made {worst_cheap} synchronizing calls, off {least_off}")
    launches = [b["launches"] for b in cheap] + [full["launches"]]
    log(f"[V1] (e) health_reduce launches: cheap blocks {launches[:-1]}, full {launches[-1]}, off "
        f"{[b['launches'] for b in off]}")
    if launches != [steps, steps, V_FULL_STEPS] or any(b["launches"] for b in off):
        failures.append(f"V1 (e) health_reduce launches {launches}, off {[b['launches'] for b in off]}")
    entries = captured[0]
    kernel_ms = cuda_graph_time_ms(lambda: health_reduce(entries))
    plain_ms = cuda_graph_time_ms(lambda: reference_health_reduce(entries), iters=5, replays=2)
    nbytes = sum(p.numel() * p.element_size() for _, leaves, _ in entries for leaf in leaves
                 for p in (leaf if isinstance(leaf, list) else [leaf]))
    log(f"[V1] the sentinel's reduce a step ({len(entries)} entries, "
        f"{sum(len(leaves) for _, leaves, _ in entries)} leaves, {nbytes / 1e6:.1f} MB): health_reduce "
        f"{kernel_ms:.4f} ms, plain version {plain_ms:.4f} ms (CUDA-graph replay); the bisector keeps the step's "
        f"bf16 parameter casts one step longer: {cheap[0]['kept_bytes'] / 2**20:.1f} MiB (no clone under bf16)")
    return {"health_reduce": steps * len(cheap) + V_FULL_STEPS}, dict(ms_off=ms_off, ms_cheap=ms_cheap,
                                                                       kernel_ms=kernel_ms, plain_ms=plain_ms)


def _v_weighted_session(init_state):
    """Phase L's model with a step whose loss weighs each token by a float
    input ``w`` [B, T - 1] (the sentinel's ``input:`` case needs one)."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.nn import vocab_parallel_cross_entropy

    _lm_init(True)
    module = smp.nn.DistributedTransformerLMHead(**LM_CFG, fused_bias_gelu=True, device="meta")
    module.load_state_dict({k: v.clone() for k, v in init_state.items()}, assign=True)
    model = smp.DistributedModel(module, device="cuda")
    optimizer, _ = _lm_optimizer_step(model)

    @smp.step
    def weighted(model, ids, w):
        loss = (vocab_parallel_cross_entropy(model(ids)[:, :-1], ids[:, 1:]) * w).mean()
        model.backward(loss)
        return loss

    return model, optimizer, weighted


def _v2(init_state, ids, failures):
    """A trip and its attribution, twice: layer 5's MLP weight poisoned, and
    a NaN input row in microbatch 2 (V2)."""
    import smdistributed_modelparallel_tpu_torch as smp

    out = {}
    for case, want in (("layer", (V_LAYER_FAULT, 0)), ("input", ("input:0/2", 2))):
        d = os.path.join(V_DIR, f"trip_{case}")
        os.makedirs(d)
        paths = {k: os.path.join(d, f) for k, f in (("SMP_HEALTH_PATH", "health.json"),
                                                    ("SMP_TELEMETRY_PATH", "telemetry.json"),
                                                    ("SMP_FLIGHT_RECORDER_PATH", "ring.jsonl"))}
        with _env(SMP_HEALTH_CHECK="cheap", **paths):
            model, optimizer, weighted = _v_weighted_session(init_state)
            w = torch.ones(TRAIN_BATCH, TRAIN_SEQ - 1, device="cuda")
            weighted(model, ids, w)
            optimizer.step()
            if case == "layer":
                name, idx = V_POISON
                with torch.no_grad():
                    dict(model.module.named_parameters())[name][idx] = float("nan")
            else:
                w[V_BAD_ROW] = float("nan")
            weighted(model, ids, w)
            torch.cuda.synchronize()
            t0 = time.time()
            smp.shutdown()  # the flush decodes the faulting step's word: trip, bisection, dumps
        dump = json.loads(open(paths["SMP_HEALTH_PATH"]).read())
        trip = dump["trips"][-1] if dump.get("trips") else {}
        att = trip.get("attribution") or {}
        tel = json.loads(open(paths["SMP_TELEMETRY_PATH"]).read())
        faults = [s for s in tel["metrics"].get("smp_health_fault_total", {}).get("series", [])]
        ring = [json.loads(x) for x in open(paths["SMP_FLIGHT_RECORDER_PATH"]).read().splitlines()[1:]]
        health_events = sorted({e.get("event") for e in ring if e.get("kind") == "health"})
        seconds = trip.get("time", t0) - t0
        out[case] = seconds
        log(f"[V2] {case}: trip at step {trip.get('step')}, tags "
            + ", ".join(f"{k} bad {v['bad']:g} mb {v['microbatch']}" for k, v in trip.get("tags", {}).items())
            + f"; attribution {att}; smp_health_fault_total {[(s['labels'], s['value']) for s in faults]}; ring "
            f"health events {health_events}; flush with bisection {seconds:.3f} s")
        if (att.get("layer"), att.get("microbatch")) != want or att.get("params_source") != "dispatch":
            failures.append(f"V2 {case}: attribution {att}, expected layer/microbatch {want}")
        if case == "layer" and att.get("param") != "transformer/seq_layers/layer/output/fc/kernel":
            failures.append(f"V2 layer: param {att.get('param')}")
        if [s["value"] for s in faults] != [1.0] or not {"trip", "fault"} <= set(health_events):
            failures.append(f"V2 {case}: fault counter {faults}, ring health events {health_events}")
        smp.reset()
        torch.cuda.empty_cache()
    return out


def _v3(failures):
    """The OOM post-mortem: a step that asks for twice the card's free
    memory (V3)."""
    import smdistributed_modelparallel_tpu_torch as smp

    path = os.path.join(V_DIR, "oom.json")
    with _env(SMP_HEALTH_PATH=path):
        smp.init({})
        model = smp.DistributedModel(torch.nn.Linear(8, 8), device="cuda")
        free, total = torch.cuda.mem_get_info()

        @smp.step
        def hog(model, x):
            big = torch.empty(2 * free, dtype=torch.uint8, device="cuda")
            loss = model(x).sum() + big[:1].float().sum()
            model.backward(loss)
            return loss

        caught = None
        try:
            hog(model, torch.zeros(2, 8, device="cuda"))
        except torch.OutOfMemoryError as e:
            caught = e
        oom = [(s["labels"], s["value"]) for s in smp.telemetry.report()["metrics"]
               .get("smp_oom_total", {}).get("series", [])]
        smp.reset()
    dump = json.loads(open(path).read()) if os.path.exists(path) else {}
    dev = (dump.get("device_memory_stats") or {}).get("cuda:0", {})
    live = dump.get("live_buffers") or {}
    log(f"[V3] a step allocating {2 * free / 2**30:.2f} GiB ({free / 2**30:.2f} GiB free of {total / 2**30:.2f}): "
        f"{type(caught).__name__ if caught else 'no error'} reached the caller; dump keys {sorted(dump)}; "
        f"device_memory_stats[cuda:0] {dev}; live tensors {live.get('count')} ({live.get('total_bytes')} bytes); "
        f"smp_oom_total {oom}")
    if caught is None:
        failures.append("V3: no torch.OutOfMemoryError reached the caller")
    if dev.get("bytes_limit") != total or not live.get("top_by_bytes") or dump.get("memory_analysis", 0) is not None:
        failures.append(f"V3: dump {dump}")
    if oom != [({"step": "step"}, 1.0)]:
        failures.append(f"V3: smp_oom_total {oom}")


def _v4_wedge(init_state, ids, failures):
    """``wedge@step=2:ms=500`` (V4). The stall lands inside the third call's
    ``step/dispatch`` region: the chaos event's time in the flight recorder
    (one ``perf_counter`` with the timeline's spans, each from its own origin)
    and the 500 ms after it lie inside that region and in no other, and the
    goodput ledger attributes 500 ms (to 50 ms) to ``wedged``. The region's
    length less 500 ms is printed, not held: it is the step's host dispatch
    time, which swings by a third between calls on a shared host."""
    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder

    timeline = os.path.join(V_DIR, "wedge_timeline.json")
    with _env(SMP_CHAOS=f"wedge@step=2:ms={V_WEDGE_MS}", SMP_TIMELINE_PATH=timeline, SMP_GOODPUT="1"):
        model, optimizer, train_step = _lm_setup(init_state, True, "cuda")
        _v_calls(model, optimizer, train_step, ids, 4)
        injected = [(s["labels"], s["value"]) for s in smp.telemetry.report()["metrics"]
                    .get("smp_chaos_injected_total", {}).get("series", [])]
        led = smp.goodput.ledger
        wedged_ms = led.seconds(led._clock()).get("wedged", 0.0) * 1e3
        # The ring's microseconds on the timeline's clock.
        shift_us = (flight_recorder._t0 - state.timeline._t0) * 1e6
        wedge_at = [e["ts_us"] + shift_us for e in flight_recorder.snapshot()
                    if e["kind"] == "chaos" and e.get("fault") == "wedge"]
        del model, optimizer, train_step
        smp.shutdown()
    events = json.loads(open(timeline).read())["traceEvents"]
    regions = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name") == "smp_phase/step/dispatch" and "dur" in e]
    dispatch = [(end - begin) / 1e3 for begin, end in regions]
    # The ring rounds its times to 0.1 us.
    holding = [i for i, (begin, end) in enumerate(regions)
               for t in wedge_at if begin - 0.1 <= t and t + wedged_ms * 1e3 <= end + 0.1]
    log(f"[V4] wedge@step=2:ms={V_WEDGE_MS}: step/dispatch regions {[round(x, 2) for x in dispatch]} ms (the third "
        f"less {V_WEDGE_MS}: {dispatch[2] - V_WEDGE_MS if len(dispatch) == 4 else None}); the wedge at "
        f"{[round(t / 1e3, 3) for t in wedge_at]} ms on the timeline, inside region(s) {holding} "
        f"{[(round(b / 1e3, 3), round(e / 1e3, 3)) for b, e in regions]}; goodput `wedged` {wedged_ms:.1f} ms; "
        f"smp_chaos_injected_total {injected}")
    if len(dispatch) != 4 or len(wedge_at) != 1 or holding != [2] \
            or not V_WEDGE_MS <= wedged_ms <= V_WEDGE_MS + 50 or injected != [({"fault": "wedge"}, 1.0)]:
        failures.append(f"V4 wedge: dispatch {dispatch} ms, wedge at {wedge_at} us inside regions {holding}, "
                        f"wedged {wedged_ms} ms, injected {injected}")


def _v4_preemption(init_state, ids, failures):
    """The preemption pair, the sentinel file (V4)."""
    import smdistributed_modelparallel_tpu_torch as smp

    model, optimizer, train_step = _lm_setup(init_state, True, "cuda")
    want = _v_calls(model, optimizer, train_step, ids, V_CALLS)
    del model, optimizer, train_step
    smp.reset()
    torch.cuda.empty_cache()
    out = {}
    for kind, env in (("preempt", {"SMP_CHAOS": "sigterm@step=3", "SMP_SUPERVISOR": "on"}),
                      ("file", {"SMP_PREEMPTION_FILE": os.path.join(V_DIR, "preempt_now")})):
        root = os.path.join(V_DIR, f"emergency_{kind}")
        touch = (lambda: open(env["SMP_PREEMPTION_FILE"], "w").close()) if kind == "file" else None
        lines, wall = _v_child(kind, root, {**env, "SMP_EMERGENCY_CKPT_PATH": root}, ready=touch)
        losses = [float(x) for x in _v_tagged(lines, "V_LOSS")]
        saves = [json.loads(x) for x in _v_tagged(lines, "V_SAVE")]
        newest = open(os.path.join(root, "newest")).read().strip() if os.path.exists(
            os.path.join(root, "newest")) else None
        ckpt_dir = os.path.join(root, f"{newest}_partial")
        committed = newest is not None and os.path.exists(os.path.join(ckpt_dir, ".committed"))
        nbytes = _dir_bytes(ckpt_dir) if committed else 0
        out[kind] = dict(seconds=saves[-1]["seconds"] if saves else None, bytes=nbytes)
        log(f"[V4] {kind}: exit 0 after {len(losses)} printed losses (bit-equal to the uninterrupted run's "
            f"first ones: {losses == want[:len(losses)]}); emergency checkpoint {newest} committed {committed}, "
            f"{nbytes / 2**20:.1f} MiB, saved in {out[kind]['seconds']} s, user_content "
            f"{saves[-1]['user'] if saves else None}; child {wall:.1f} s")
        reason = "sigterm" if kind == "preempt" else "sentinel_file"
        if newest != "preempt_step_3" or not committed or losses != want[:2] or not saves \
                or saves[-1]["user"] != {"preemption_reason": reason, "step_count": 3}:
            failures.append(f"V4 {kind}: newest {newest}, committed {committed}, losses {losses}, saves {saves}")
        probe = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                                             "resilience_probe.py"), root],
                               capture_output=True, text=True, timeout=120)
        log(f"[V4] resilience_probe.py {os.path.basename(root)}: exit {probe.returncode}; "
            + " | ".join(ln.strip() for ln in probe.stdout.splitlines()[:3]))
        if probe.returncode != 0:
            failures.append(f"V4 {kind}: resilience_probe.py exit {probe.returncode}: {probe.stdout[-500:]}")
    lines, wall = _v_child("resume", os.path.join(V_DIR, "emergency_preempt"), {})
    res = json.loads(_v_tagged(lines, "V_CHILD")[-1])
    log(f"[V4] resume: user_content {res['user']}, step_count {res['step_count']}, losses {res['losses']} against "
        f"the uninterrupted run's calls 3-5 {want[2:5]} (the third call's update was not applied before the save, "
        f"so the resumed run repeats it): bit-equal {res['losses'] == want[2:5]}; child {wall:.1f} s")
    if res["losses"] != want[2:5] or res["step_count"] != 3:
        failures.append(f"V4 resume: losses {res['losses']} != {want[2:5]}, step_count {res['step_count']}")
    return out


def _v4_burst(failures):
    """Phase S's burst with the fleet plane on, its scrape endpoint fetched
    during the burst; then ``corrupt_weights`` on an ``adopt_params`` (V4)."""
    import threading
    import urllib.request

    import smdistributed_modelparallel_tpu_torch as smp
    from smdistributed_modelparallel_tpu_torch.models.gpt2 import gpt2_124m, init_gpt2_weights_
    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine
    from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet

    def engine_of():
        g = torch.Generator(device="cuda").manual_seed(SEED)
        module = init_gpt2_weights_(gpt2_124m(device="cuda"), g)
        engine = ServingEngine(smp.DistributedModel(module, device="cuda"), max_slots=S_SLOTS, num_blocks=S_BLOCKS)
        engine.run(s_requests(module.vocab_size, n=2, n_sampled=1, prompt=(40, 40), new=(4, 4), seed=SEED + 2,
                              prefix="warm"))
        return engine, module

    reqs = None
    if _S_BF16:
        off, src = _S_BF16["results"], "phase S"
    else:
        smp.init({"bf16": True})
        engine, module = engine_of()
        reqs = s_requests(module.vocab_size)
        off, src = engine.run(reqs), "an off run"
        del engine, module
        smp.reset()
    serve_dir = os.path.join(V_DIR, "serve")
    os.makedirs(serve_dir)
    fleet_path = os.path.join(V_DIR, "fleet.jsonl")
    with _env(SMP_FLEET_INTERVAL=V_FLEET_INTERVAL, SMP_METRICS_PORT="0", SMP_FLEET_PATH=fleet_path,
              SMP_TELEMETRY_PATH=os.path.join(serve_dir, "telemetry.json")):
        smp.init({"bf16": True})
        engine, module = engine_of()
        reqs = reqs or s_requests(module.vocab_size)
        port = fleet.plane.bound_port
        scraped = {}

        def scrape():  # once the burst is under way
            deadline = time.monotonic() + 60
            while not engine.busy and time.monotonic() < deadline:
                time.sleep(0.002)
            for route in ("/metrics", "/metrics.json", "/fleet"):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as resp:
                    scraped[route] = (resp.status, engine.busy)

        fetcher = threading.Thread(target=scrape)
        t0 = time.perf_counter()
        fetcher.start()
        results = engine.run(reqs)
        wall = time.perf_counter() - t0
        fetcher.join(timeout=60)
        time.sleep(float(V_FLEET_INTERVAL) + 0.05)
        fleet.tick()  # a window past the burst: the report holds every observation
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet", timeout=30) as resp:
            report = json.loads(resp.read())
        # corrupt_weights on an adoption of the same weights.
        sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
        with _env(SMP_CHAOS="corrupt_weights@version=1"):
            engine.adopt_params(sd, version=1)
        adopted = engine.decode_mod.state_dict()
        bad = [k for k, v in sd.items() if v.is_floating_point() and not torch.equal(
            adopted[k], (v * 1.01 + 0.01).to(adopted[k].dtype))]
        injected = [(s["labels"], s["value"]) for s in smp.telemetry.report()["metrics"]
                    .get("smp_chaos_injected_total", {}).get("series", [])]
        engine.close()
        smp.shutdown()
    windows = [json.loads(x) for x in open(fleet_path).read().splitlines()]
    equal = {r.request_id: results[r.request_id] for r in reqs} == {r.request_id: off[r.request_id] for r in reqs}
    log(f"[V4] burst with the fleet plane on ({V_FLEET_INTERVAL} s, port {port}): {wall * 1e3:.1f} ms, "
        f"{sum(len(v) for v in results.values())} tokens; tokens equal to {src}'s: {equal}; scraped during the "
        f"burst (status, engine busy): {scraped}; {len(windows)} fleet windows (seq "
        f"{[w['seq'] for w in windows]}, resync {[w['resync'] for w in windows]})")
    if not equal or set(scraped) != {"/metrics", "/metrics.json", "/fleet"} or any(
            st != 200 or not busy for st, busy in scraped.values()) or not windows:
        failures.append(f"V4 burst: tokens equal {equal}, scraped {scraped}, windows {len(windows)}")
    # The fleet report's percentiles against telemetry_report.py's offline merge of the rank's dump.
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    offline = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, sys.argv[1]); import telemetry_report as t\n"
         "m = t._merge_fallback(t.load_rank_dumps(sys.argv[2]))\n"
         "out = {}\n"
         "for s in m['metrics']['smp_serve_latency_seconds']['series']:\n"
         "    out[s['labels']['kind']] = {f'p{int(q * 100)}_s': t._quantile_from_counts(s['buckets'], s['counts'], q)"
         " for q in (0.5, 0.9, 0.99)}\n"
         "print(json.dumps(out))", scripts, serve_dir], capture_output=True, text=True, timeout=120)
    cli = subprocess.run([sys.executable, os.path.join(scripts, "telemetry_report.py"), serve_dir],
                         capture_output=True, text=True, timeout=120)
    merged = json.loads(offline.stdout) if offline.returncode == 0 else {}
    fleet_pct = {k: {s: v[s] for s in ("p50_s", "p90_s", "p99_s")} for k, v in report["percentiles"].items()
                 if k in ("ttft", "itl")}
    log(f"[V4] fleet report percentiles {fleet_pct}; telemetry_report.py --dir merge "
        f"{ {k: merged.get(k) for k in fleet_pct} }; telemetry_report.py exit {cli.returncode}")
    if not fleet_pct or any(merged.get(k) != v for k, v in fleet_pct.items()) or cli.returncode != 0:
        failures.append(f"V4 burst: fleet percentiles {fleet_pct} vs offline {merged}, report exit {cli.returncode}")
    log(f"[V4] corrupt_weights@version=1 on adopt_params: every float leaf x * 1.01 + 0.01: {not bad}; "
        f"smp_chaos_injected_total {injected}")
    if bad or injected != [({"fault": "corrupt_weights"}, 1.0)]:
        failures.append(f"V4 corrupt_weights: {bad[:5]}, {injected}")


def phase_v():
    """V1-V4 (see the module docstring); returns V1's launches of the
    sentinel's kernel and the numbers PERF.md keeps."""
    import shutil

    shutil.rmtree(V_DIR, ignore_errors=True)
    os.makedirs(V_DIR)
    try:
        return _phase_v()
    finally:
        shutil.rmtree(V_DIR, ignore_errors=True)


def _phase_v():
    import smdistributed_modelparallel_tpu_torch as smp

    t_phase = time.perf_counter()
    smp.reset()  # a clean monitor, registry and listener
    failures = []
    init_state, ids = _v_init()
    t = time.perf_counter()
    launches, numbers = _v1(init_state, ids, failures)
    log(f"[V] V1 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    numbers["bisect_s"] = _v2(init_state, ids, failures)
    log(f"[V] V2 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _v3(failures)
    log(f"[V] V3 {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _v4_wedge(init_state, ids, failures)
    numbers["save"] = _v4_preemption(init_state, ids, failures)
    log(f"[V] V4 preemption and wedge {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _v4_burst(failures)
    log(f"[V] V4 burst {time.perf_counter() - t:.1f} s")
    log(f"[V] phase V {time.perf_counter() - t_phase:.1f} s; numbers {json.dumps(numbers)}")
    if failures:
        raise RuntimeError("phase V: " + "; ".join(failures))
    return launches


def _profile_report(label, prof, wall_ms, top):
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[P] {label}: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms, "
        f"idle share {1 - device_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[P]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def phase_p():
    """Where one greedy ``generate``, phase S's serving burst, one training step, one capacity step
    (fused CE and materialized logits), the smp.nn path's steps (fused,
    unfused, fp8, with dropout, and with dropout and checkpointed layers) and
    phase G's smp.nn generate spend their time, by torch.profiler:
    device time by kernel and the device's idle share of the wall time."""
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

    from smdistributed_modelparallel_tpu_torch.serving import ServingEngine

    engine = ServingEngine(model, max_slots=S_SLOTS, num_blocks=S_BLOCKS)
    engine.run(s_requests(50257, n=2, n_sampled=1, prompt=(40, 40), new=(4, 4), seed=SEED + 2, prefix="warm"))  # warm-up
    reqs = s_requests(50257)
    prof, wall_ms = profiled(lambda: engine.run(reqs))
    _profile_report(f"serving engine burst ({len(reqs)} requests, {S_SLOTS} slots, {S_BLOCKS} blocks; phase S)", prof,
                    wall_ms, 12)
    del engine

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
    for label, fused, cfg, smp_cfg in (("fused", True, LM_CFG, {}), ("unfused", False, LM_CFG, {}),
                                       ("fused, matmul_precision: fp8", True, LM_CFG, {"matmul_precision": "fp8"}),
                                       ("fused, dropout 0.1", True, LM_DROP_CFG, {}),
                                       ("fused, dropout 0.1, activation checkpointing (recompute: full)", True,
                                        dict(LM_DROP_CFG, activation_checkpointing=True), {})):
        model, optimizer, train_step = _lm_setup(lm_state, fused, "cuda", cfg, **smp_cfg)
        for _ in range(TRAIN_WARMUP):
            train_step(model, ids)
            optimizer.step()
        prof, wall_ms = profiled(one_step)
        _profile_report(f"smp.nn step batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MB} microbatches, {label}", prof,
                        wall_ms, 16)
        del model, optimizer, train_step

    # The smp.nn generate of phase G's G1 (padded prompts, the fused knobs).
    smp.init({"bf16": True, "fused_qkv": True})
    lm = smp.nn.DistributedTransformerLMHead(**LM_CFG, fused_bias_gelu=True, device="meta")
    lm.load_state_dict(lm_state, assign=True)
    model = smp.DistributedModel(lm, device="cuda")
    ids, mask, _ = g_prompts(LM_CFG["vocab_size"])
    smp.generate(model, ids, 2, attention_mask=mask)
    for new in (1, G_NEW):
        prof, wall_ms = profiled(lambda: smp.generate(model, ids, new, attention_mask=mask))
        _profile_report(f"smp.nn generate, phase G's padded batch {tuple(ids.shape)}, new={new}", prof, wall_ms, 10)
    del model, lm

    # Phase H1's training step: GPT-2 124M from smp.from_hf, dropouts 0.1.
    smp.init({"bf16": True, "fused_qkv": True, "microbatches": TRAIN_MB})
    model = smp.from_hf(hf_model(HF_CONFIGS["gpt2"], 0.02, g), fused_bias_gelu=True)
    optimizer, train_step = _lm_optimizer_step(model)
    ids = torch.randint(0, 50257, (TRAIN_BATCH, TRAIN_SEQ), generator=g, device="cuda")
    for _ in range(TRAIN_WARMUP):
        train_step(model, ids)
        optimizer.step()
    prof, wall_ms = profiled(one_step)
    _profile_report(f"smp.from_hf GPT-2 step batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MB} microbatches, fused, "
                    "dropout 0.1 (phase H1)", prof, wall_ms, 16)
    smp.reset()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=DEFAULT_PHASES,
                        help="phases to run: A, S, G, T, F, L, D, M, Q, R, U, W, N, p, J, K, H, E, O, V, B, C (the "
             "default, all twenty-two), "
             "P (profiles), t (phase p (a) on two cards, over NCCL), r (phase R's ranks on two cards, over NCCL), Y (phase W's ranks on two cards, over "
             "NCCL), Z (phase U's ranks on two cards, over NCCL), I (phase N (a) and (g) on two cards, over NCCL) "
             "and X (GPT-2 1.5B at 16 x 1024 with checkpointing off)")
    parser.add_argument("--k-child", metavar="DIR", help=argparse.SUPPRESS)  # phase K's resumed run
    parser.add_argument("--o-child", metavar="KIND:ON", help=argparse.SUPPRESS)  # phase O's runs
    parser.add_argument("--v-child", metavar="KIND:DIR", help=argparse.SUPPRESS)  # phase V's runs
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an H100.", file=sys.stderr)
        return 2
    import smdistributed_modelparallel_tpu_torch  # noqa: F401  (fails outside the repo)

    if args.k_child:
        phase_k_child(args.k_child)
        return 0
    if args.v_child:
        return phase_v_child(args.v_child)
    if args.o_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind, state = args.o_child.split(":")
        (phase_o_child_train if kind == "train" else phase_o_child_serve)(state == "on")
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    started = time.perf_counter()
    build()
    log(f"[time] build {time.perf_counter() - started:.1f} s")
    serve_launches, train_launches, cap_launches, lm_launches, q_launches, cp_launches = {}, {}, {}, {}, {}, {}
    k_launches, d_launches, m_launches, s_launches, g_launches, h_launches = {}, {}, {}, {}, {}, {}
    e_launches, o_launches, v_launches, w_launches, u_launches, j_launches = {}, {}, {}, {}, {}, {}
    n_launches, p_launches = {}, {}
    errs = timing = None
    mark = [time.perf_counter()]

    def timed(letter):
        """Log the seconds since the last phase ended."""
        now = time.perf_counter()
        log(f"[time] phase {letter} {now - mark[0]:.1f} s")
        mark[0] = now
    if "A" in args.phases:
        serve_launches = phase_a()
        timed("A")
    if "S" in args.phases:
        s_launches = phase_s()
        timed("S")
    if "G" in args.phases:
        g_launches = phase_g()
        timed("G")
    if "T" in args.phases:
        train_launches, _ = phase_t()
        timed("T")
    if "F" in args.phases:
        cap_launches, _ = phase_f()
        timed("F")
    if "L" in args.phases:
        lm_launches, _ = phase_l()
        timed("L")
    if "D" in args.phases:
        d_launches, _ = phase_d()
        timed("D")
    if "M" in args.phases:
        m_launches, _ = phase_m()
        timed("M")
    if "X" in args.phases:
        phase_x()
        timed("X")
    if "Q" in args.phases:
        q_launches, _ = phase_q()
        timed("Q")
    if "R" in args.phases:
        cp_launches, _ = phase_r()
        timed("R")
    if "r" in args.phases:
        phase_r(device=None)
        timed("r")
    if "U" in args.phases:
        u_launches, _ = phase_u()
        timed("U")
    if "Z" in args.phases:
        phase_z()
        timed("Z")
    if "W" in args.phases:
        w_launches, _ = phase_w()
        timed("W")
    if "Y" in args.phases:
        phase_y()
        timed("Y")
    if "N" in args.phases:
        n_launches, _ = phase_n()
        timed("N")
    if "I" in args.phases:
        phase_i()
        timed("I")
    if "p" in args.phases:
        p_launches, _ = phase_pipe()
        timed("p")
    if "t" in args.phases:
        phase_pipe_nccl()
        timed("t")
    if "J" in args.phases:
        j_launches = phase_j()
        timed("J")
    if "K" in args.phases:
        k_launches, _ = phase_k(smi)
        timed("K")
    if "H" in args.phases:
        h_launches = phase_h()
        timed("H")
    if "E" in args.phases:
        e_launches = phase_e()
        timed("E")
    if "O" in args.phases:
        o_launches = phase_o()
        timed("O")
    if "V" in args.phases:
        v_launches = phase_v()
        timed("V")
    if "B" in args.phases:
        errs = phase_b()
        timed("B")
    if "C" in args.phases:
        timing = phase_c()
        timed("C")
    if "P" in args.phases:
        phase_p()
        timed("P")

    log(f"[time] all phases {time.perf_counter() - started:.1f} s")
    if not set(DEFAULT_PHASES) <= set(args.phases):
        return 0  # a partial run prints no result
    fwd_err, bwd_err, new_err = errs
    # Launches on the main paths: serving's prefills (A), training (T), the
    # capacity path (F), the smp.nn path (L), its fp8 run (Q) and the
    # context-parallel run (R: both ranks and the cp = 1 run), the
    # checkpointed run (K: before and after the save, the resumed child and
    # the full-checkpoint resume), the dropout run (D: its timed blocks) and
    # the checkpointed runs (M: every block and every 1.5B run), the serving
    # engine's burst (S), generation through the smp.nn LM head (G: G1-G4),
    # the HF models through smp.from_hf (H: H1's training and generation, H2's
    # bf16 forwards) and the encoder-decoder and MoE paths (E: E1's training,
    # generation and checkpointed steps, E2's T5 training, E3's MoE training
    # and decoding, E4's forward), the observability runs (O: O1's 20
    # steps with every variable on), the sentinel's runs (V: V1's cheap
    # and full blocks), the data-parallel run (W: both ranks' 6 steps
    # and the rdp = 1 run), the expert-parallel run (U: both ranks' steps
    # and the ep = 1 run), phase R's rdp x cp run (its four ranks' steps,
    # in R's count), the serving replicas (J: world 1's sampled streams) and
    # the tensor-parallel run (N: both ranks' steps in both layouts, their
    # fused-CE steps and generates, and the tp = 1 run), each counted from 0
    # just before it.
    paths = (serve_launches, train_launches, cap_launches, lm_launches, q_launches, cp_launches, k_launches,
             d_launches, m_launches, s_launches, g_launches, h_launches, e_launches, o_launches, v_launches,
             w_launches, u_launches, j_launches, n_launches, p_launches)
    launches = {k: sum(p.get(k, 0) for p in paths) for k in set().union(*paths)}
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
    ] + [  # no Pallas kernel: XLA fuses jax.random's threefry into the select; max_abs_err over phase B's sweep
        dict(name=name, route="cuda", source=src + "dropout.cu", replaces="XLA's threefry and select (no Pallas kernel)",
             launches=launches[name], max_abs_err=new_err[name], **timing[name])
        for name in ("threefry_bits", "dropout_fwd", "dropout_bwd")
    ] + [  # the same forward kernel under the index map of a tp rank's shard (its launches on the path: phase N (h),
           # (i)); max_abs_err over phase B's shard sweep, times at a rank's T block (C)
        dict(name="dropout_fwd_index_map", route="cuda", source=src + "dropout.cu",
             replaces="XLA's partitioned threefry and select over a tp shard (no Pallas kernel)",
             launches=launches["dropout_fwd_index_map"], max_abs_err=new_err["dropout_fwd_index_map"],
             **timing["dropout_fwd_index_map"])
    ] + [  # no Pallas kernel: XLA fuses the sentinel's reduces into the step program; phase B's sweep, times at V1's step
        dict(name="health_reduce", route="cuda", source=src + "health_reduce.cu",
             replaces="XLA's fused sentinel reduce (no Pallas kernel)", launches=launches["health_reduce"],
             max_abs_err=new_err["health_reduce"], **timing["health_reduce"])
    ]
    kernels[[k["name"] for k in kernels].index("matmul_bias")]["ring_chunk_max_abs_err"] = (
        new_err["matmul_bias_ring_chunk"])  # phase B's bf16 ring_chunk case, the tp = 2 ring's QKV chunk
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
