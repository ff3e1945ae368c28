"""Declarative configuration schema of the PyTorch port.

A key-for-key copy of ``smdistributed_modelparallel_tpu/backend/schema.py``
(same types, defaults, bounds, aliases and ``requires`` rules), so that both
packages resolve a user config to the same values. Descriptions are the
JAX package's; where a key means something else on a CUDA device, the
description says so. Keys whose feature has not been ported yet are accepted
and resolved but have no effect in this package.

A formula default/bound is a string containing ``(other_param)`` references;
it is evaluated after its dependencies (see ``DependencyIterator`` in
``config.py``).
"""

# Each entry: type (a python type, a tuple of types, or 'none-able' via tuple
# containing type(None)), default, optional lower_bound/upper_bound (number or
# formula str), options list, alias str, requires / requires_not /
# requires_either dicts, dependencies list, internal / deprecated flags.

SCHEMA = {
    "pipeline_parallel_degree": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "alias": "partitions",
        "description": "Pipeline parallelism degree.",
    },
    "tensor_parallel_degree": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "requires": {"ddp": True},
        "dependencies": ["ddp"],
        "description": "Tensor parallelism degree.",
    },
    "microbatches": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "description": "Number of microbatches the incoming batch is split into; "
        "batch size must be divisible by this value.",
    },
    "pipeline": {
        "type": str,
        "default": "interleaved",
        "options": ["simple", "interleaved", "zero_bubble", "_only_forward"],
        "description": "Pipelining schedule. 'interleaved' lowers to a 1F1B "
        "schedule in the compiled microbatch loop; 'simple' to all-forward-"
        "then-all-backward; 'zero_bubble' to the ZB-H1 split-backward "
        "schedule (input-grad pass on the critical path, weight-grad pass "
        "deferred into the cooldown bubble — bound "
        "2(pp-1)/(3*v*mb+2(pp-1)), below the interleaved floor at the same "
        "activation memory; composes with virtual_pipeline_degree).",
    },
    "virtual_pipeline_degree": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "alias": "virtual_pipeline_parallel_degree",
        "requires": {"pipeline": ["interleaved", "zero_bubble"]},
        "dependencies": ["pipeline"],
        "description": "Megatron-style interleaved virtual pipeline stages: "
        "each pipeline rank owns this many non-contiguous model chunks "
        "(chunk c runs on stage c mod pp), shrinking the 1F1B bubble floor "
        "from (pp-1)/(mb+pp-1) to (pp-1)/(v*mb+pp-1) at the cost of v x "
        "more stage-boundary collective-permutes per microbatch. Requires "
        "the 1F1B ('interleaved') schedule; no effect at "
        "pipeline_parallel_degree 1.",
    },
    "horovod": {
        "advisory": "SPMD collectives replace horovod",
        "type": bool,
        "default": False,
        "description": "Reference-compat flag (TF/Horovod DP). Accepted, unused on TPU.",
    },
    "ddp": {
        "type": bool,
        "default": False,
        "requires": {"horovod": False},
        "dependencies": ["horovod"],
        "description": "Enable data parallelism (reference: PyTorch DDP). Required "
        "for data and tensor parallelism; on TPU this toggles the dp/rdp mesh axes.",
    },
    "sharded_data_parallel_degree": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "requires": {
            "tensor_parallel_degree": 1,
            "pipeline_parallel_degree": 1,
            "shard_optimizer_state": False,
        },
        "dependencies": [
            "tensor_parallel_degree",
            "pipeline_parallel_degree",
            "shard_optimizer_state",
        ],
        "description": "Sharded data parallelism (reference: ZeRO-2D / DeepSpeed "
        "stage 3). On TPU this lowers to fully-sharded parameter PartitionSpecs "
        "over the dp axis.",
    },
    "sdp_reduce_bucket_size": {
        "type": int,
        "default": int(5e8),
        "description": "Gradient-reduction bucket size in elements. Advisory on TPU "
        "(XLA fuses reductions); kept for config compatibility.",
    },
    "sdp_param_persistence_threshold": {
        "type": int,
        "default": int(1e6),
        "description": "Parameters smaller than this many elements are kept "
        "replicated rather than sharded under sharded data parallelism.",
    },
    "sdp_max_live_parameters": {
        "type": int,
        "default": int(1e9),
        "description": "Max number of parameters simultaneously in recombined "
        "(allgathered) state. Advisory on TPU; XLA schedules allgathers.",
    },
    "sdp_hierarchical_allgather": {
        "type": bool,
        "default": True,
        "description": "Hierarchical (intra- then inter-host) parameter allgather. "
        "On TPU, ICI/DCN hierarchy is chosen by XLA from the mesh layout.",
    },
    "sdp_gradient_clipping": {
        "type": float,
        "default": 1.0,
        "description": "Global grad-norm clip value applied under sharded data parallelism.",
    },
    "sharded_params": {
        "type": str,
        "default": "none",
        "options": ["none", "zero3"],
        "requires": {
            "ddp": True,
            "sharded_data_parallel_degree": 1,
            "horovod": False,
        },
        "dependencies": [
            "ddp", "sharded_data_parallel_degree", "horovod",
        ],
        "description": "Fully-sharded parameters (ZeRO-3 / FSDP over the rdp "
        "mesh axis): 'zero3' stores every parameter >= "
        "sdp_param_persistence_threshold elements sharded over rdp, "
        "all-gathers each layer's params just-in-time in forward (and "
        "regathers in backward), and reduce-scatters gradients in "
        "zero3_bucket_mb buckets overlapped with the backward. Env alias: "
        "SMP_ZERO3=1. Mutually exclusive with the legacy zero2d knob "
        "(sharded_data_parallel_degree).",
    },
    "zero3_bucket_mb": {
        "type": int,
        "default": 25,
        "lower_bound": 1,
        "description": "Gradient reduce-scatter bucket size in MiB under "
        "sharded_params: zero3 (reference: DeepSpeed reduce_bucket_size). "
        "Env alias: SMP_ZERO3_BUCKET_MB.",
    },
    "_sharded_data_parallelism_config": {
        "type": (str, dict, type(None)),
        "default": None,
        "internal": True,
        "description": "DeepSpeed-style sharded-DP overrides: a JSON file "
        "path or an inline dict (zero_optimization.* keys map onto sdp_*).",
    },
    "ddp_port": {
        "advisory": "no TCP rendezvous under the JAX runtime",
        "type": (int, type(None)),
        "default": None,
        "lower_bound": 0,
        "requires": {"ddp": True},
        "dependencies": ["ddp"],
        "description": "Reference-compat; coordination port for jax.distributed.",
    },
    "ddp_dist_backend": {
        "type": str,
        "default": "xla",
        "options": ["xla", "nccl"],
        "description": "Collective backend. On TPU always 'xla' (ICI collectives); "
        "'nccl' is accepted for config compatibility and treated as 'xla'.",
    },
    "contiguous": {
        "advisory": "TF-runtime key; the single JAX runtime has no graph split",
        "type": bool,
        "default": True,
        "description": "Force pipeline stages to be contiguous layer ranges "
        "(reference: TF subgraph contiguity). The TPU pipeline is always "
        "contiguous-per-stage; False is accepted and ignored.",
    },
    "placement_strategy": {
        "type": str,
        "default": "cluster",
        "options": ["cluster", "spread", "PDT", "PTD", "DPT", "DTP", "TPD", "TDP"],
        "description": "Mapping of (pp, rdp, tp) onto physical devices; the "
        "right-most letter varies fastest over neighboring devices. 'cluster'="
        "'DPT', 'spread'='TPD'. Lowers directly to jax.sharding.Mesh axis order.",
    },
    "optimize": {
        "type": str,
        "default": "speed",
        "options": ["speed", "memory"],
        "description": "DistributedTransformer layout: 'speed' = head-partitioned "
        "(Megatron-style allgather/reduce), 'memory' = input-partitioned "
        "(all-to-all scatter-merge).",
    },
    "auto_partition": {
        "type": bool,
        "default": True,
        "requires_not": {"default_partition": None},
        "dependencies": ["default_partition"],
        "description": "Enable auto-partitioning of modules across pipeline stages.",
    },
    "default_partition": {
        "type": (int, type(None)),
        "default": None,
        "lower_bound": 0,
        "upper_bound": "(pipeline_parallel_degree) - 1",
        "dependencies": ["pipeline_parallel_degree"],
        "description": "Partition for modules not explicitly assigned when "
        "auto_partition is disabled.",
    },
    "prescaled_batch": {
        "type": bool,
        "default": False,
        "requires": {"optimize": "speed"},
        "dependencies": ["optimize"],
        "description": "DistributedTransformerLMHead expects the same batch on "
        "every tp_rank (batch defined per TP group).",
    },
    "memory_weight": {
        "type": float,
        "default": 0.8,
        "lower_bound": 0.0,
        "upper_bound": 1.0,
        "description": "Relative weight of memory (vs compute time) in the "
        "auto-partitioner cost model.",
    },
    "active_microbatches": {
        "type": int,
        "default": "(pipeline_parallel_degree) + 2",
        "lower_bound": 1,
        "upper_bound": "(microbatches)",
        "dependencies": ["microbatches", "pipeline_parallel_degree"],
        "description": "Max microbatches simultaneously in flight; bounds "
        "activation memory of the pipeline schedule.",
    },
    "fast_mode": {
        "advisory": "no MPMD message passing to shortcut",
        "type": bool,
        "default": False,
        "internal": True,
        "description": "Reference-compat. The compiled TPU pipeline always does "
        "direct stage-to-stage transfers; accepted and ignored.",
    },
    "static_mode": {
        "advisory": "the compiled step IS static",
        "type": bool,
        "default": False,
        "internal": True,
        "description": "Reference-compat. The TPU schedule is always static "
        "(baked into the compiled program); accepted and ignored.",
    },
    "fp16": {
        "type": bool,
        "default": False,
        "description": "Train in float16 with dynamic loss scaling.",
    },
    "bf16": {
        "type": bool,
        "default": False,
        "requires": {"fp16": False, "fp16_params": False},
        "dependencies": ["fp16", "fp16_params"],
        "description": "Train in bfloat16 (the native TPU half precision).",
    },
    "fp16_params": {
        "type": bool,
        "default": False,
        "deprecated": True,
        "replacement": "fp16",
        "description": "Deprecated; use fp16.",
    },
    "tensor_parallel_seed": {
        "type": int,
        "default": 0,
        "lower_bound": 0,
        "description": "Seed for random ops inside tensor-parallel distributed modules.",
    },
    "offload_activations": {
        "type": bool,
        "default": False,
        "description": "Offload checkpointed activations to host memory during "
        "forward, reload during backward. Only functional with activation "
        "checkpointing.",
    },
    "_shard_offloaded_activations": {
        "advisory": "XLA manages offload buffers",
        "type": bool,
        "default": True,
        "internal": True,
        "description": "Shard offloaded activations across the TP group instead "
        "of offloading replicas from every tp_rank.",
    },
    "shard_optimizer_state": {
        "type": bool,
        "default": False,
        "description": "Shard optimizer state across (reduced-)data-parallel ranks "
        "(reference: virtual-parameter contiguous buffer; TPU: opt-state "
        "PartitionSpecs over the rdp axis).",
    },
    "delayed_parameter_initialization": {
        "type": bool,
        "default": False,
        "description": "Initialize parameters lazily/abstractly and materialize "
        "them directly sharded on device (TPU: jax.eval_shape + sharded init).",
    },
    "skip_tracing": {
        "type": bool,
        "default": False,
        "description": "Skip the cost-tracing pass; the auto-partitioner falls "
        "back to parameter-count costs from jax.eval_shape.",
    },
    "activation_loading_horizon": {
        "type": int,
        "default": 4,
        "lower_bound": 0,
        "description": "How many offloaded layer activations may simultaneously "
        "be resident on device awaiting consumption.",
    },
    "task_level_activation_loading_horizon": {
        "advisory": "XLA schedules host offload",
        "type": int,
        "default": 4,
        "lower_bound": 1,
        "internal": True,
        "description": "Reference-compat scheduling knob; advisory on TPU.",
    },
    "herring": {
        "advisory": "SPMD collectives replace herring",
        "type": bool,
        "default": False,
        "requires": {"ddp": False, "horovod": False},
        "dependencies": ["ddp", "horovod"],
        "internal": True,
        "description": "Reference-compat; not functional.",
    },
    "_match_weights": {
        "type": bool,
        "default": False,
        "internal": True,
        "description": "Debug: verify distributed weights match the source "
                       "module at distribution time (here: the HF "
                       "translation round-trips against the source state "
                       "dict, logged per key).",
    },
    "_fp32_grad_accumulation": {
        "type": bool,
        "default": False,
        "internal": True,
        "requires_either": {"fp16": True, "fp16_params": True},
        "dependencies": ["fp16", "fp16_params"],
        "description": "Accumulate microbatch gradients in float32.",
    },
    "checkpoint_attentions": {
        "advisory": "use activation-checkpointing configs (smp.set_activation_checkpointing) — remat granularity is the layer",
        "type": bool,
        "default": False,
        "internal": True,
        "description": "Activation-checkpoint the attention score computation in "
        "DistributedTransformer.",
    },
    "load_partition": {
        "type": bool,
        "default": False,
        "internal": True,
        "description": "Load a saved partition assignment instead of repartitioning.",
    },
    "partition_file": {
        "type": (str, type(None)),
        "default": None,
        "internal": True,
        "description": "Path for saving/loading partition assignments.",
    },
    # ------------------------------------------------------------------
    # TPU-native extensions (no reference counterpart; SURVEY.md §5.7, §7-M6)
    # ------------------------------------------------------------------
    "context_parallel_degree": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "description": "TPU extension: context (sequence) parallelism degree for "
        "long sequences; shards the sequence dimension across a 'cp' mesh axis.",
    },
    "context_parallel_impl": {
        "type": str,
        "default": "ring",
        "options": ["ring", "ulysses", "allgather"],
        "description": "TPU extension: ring attention (ppermute KV rotation), "
        "Ulysses (all_to_all head/sequence exchange), or allgather-KV.",
    },
    "expert_parallel_degree": {
        "type": int,
        "default": 1,
        "lower_bound": 1,
        "description": "TPU extension: expert parallelism degree for MoE layers.",
    },
    "moe_aux_loss_weight": {
        "type": float,
        "default": 1.0,
        "lower_bound": 0.0,
        "description": "TPU extension: global multiplier on the MoE router "
        "load-balancing auxiliary loss folded into the differentiated step "
        "loss (each DistributedMoE layer's own aux_loss_coef still applies). "
        "0 disables the aux term.",
    },
    "use_pallas_kernels": {
        "type": bool,
        "default": True,
        "description": "Dispatch attention to the hand-written kernels "
        "(Pallas on a TPU in the JAX package, CUDA on an H100 in this port); "
        "plain tensor code elsewhere or when shapes are outside the kernel's "
        "range.",
    },
    "fused_optimizer_step": {
        "type": bool,
        "default": True,
        "description": "TPU extension: compile the optimizer update into the "
        "step program (one device launch per training iteration). The update "
        "is installed only when optimizer.step() is called; disabled "
        "automatically under fp16 loss scaling. Memory note: because the "
        "step may legally run without a following optimizer.step(), the "
        "fused program cannot donate params/opt_state by default, so peak "
        "memory holds one extra params+opt_state copy vs the donated "
        "standalone update; enable fused_step_donation (steady-state "
        "training) or set False to restore the donated memory profile on "
        "tight-HBM configs.",
    },
    "fused_step_donation": {
        "type": bool,
        "default": False,
        "requires": {"fused_optimizer_step": True},
        "dependencies": ["fused_optimizer_step"],
        "description": "TPU extension: donate the params and optimizer-state "
        "buffers through the fused step program, removing the extra "
        "params+opt_state copy from peak HBM. The update is installed at "
        "step return (the input buffers are gone), so every training step "
        "behaves as if followed by optimizer.step() — calling step() is "
        "still fine and becomes a no-op confirmation. Do not enable if the "
        "training loop reads PRE-update parameters after a step or "
        "intentionally skips optimizer.step().",
    },
    "fused_ce": {
        "type": (bool, str),
        "default": "auto",
        "options": [True, False, "auto"],
        "description": "TPU extension: LM-head cross-entropy path for "
        "model(ids, targets=...) loss mode. True: stream vocab through "
        "the blockwise Pallas kernel (logits never materialize; the "
        "backward recomputes logit blocks, ~5/3 the head matmul flops) — "
        "falls back WITH A WARNING where the kernel cannot run (off-TPU, "
        "tp-sharded vocab, no block configuration fits VMEM). False: "
        "always materialize logits (fastest when they fit). 'auto' "
        "(default): use the kernel only when the per-microbatch logits "
        "(at the activation dtype) would exceed fused_ce_auto_threshold_mb "
        "— at that size the HBM capacity win outweighs the recompute; "
        "below it the logits path is faster on every measured shape.",
    },
    "pallas_attn_block_q": {
        "type": (int, type(None)),
        "default": None,
        "lower_bound": 128,
        "multiple_of": 128,
        "description": "TPU extension: flash-attention q-tile rows "
        "(default 256; Mosaic lane alignment requires multiples of 128). "
        "Tune per TPU generation with the bench's breakdown mode. In the "
        "PyTorch port it names the reference tiling that fixes which kv "
        "range a fully-masked row averages over; the CUDA kernel's own "
        "tiles do not depend on it.",
    },
    "pallas_attn_block_k": {
        "type": (int, type(None)),
        "default": None,
        "lower_bound": 128,
        "multiple_of": 128,
        "description": "TPU extension: flash-attention kv-tile rows "
        "(default 512; 256 inside context-parallel regions). Multiples "
        "of 128 only. In the PyTorch port it names the reference tiling that "
        "fixes the dropout hash's row stride (S rounded up to it) and the kv "
        "range a fully-masked row averages over.",
    },
    "fused_ce_auto_threshold_mb": {
        "type": int,
        "default": 2048,
        "lower_bound": 1,
        "description": "TPU extension: logits-size threshold (MB, at the "
        "activation dtype — bf16 logits count 2 bytes/element, fp32 count "
        "4) above which fused_ce: auto switches to the no-materialize "
        "Pallas CE kernel.",
    },
    "tp_overlap": {
        "type": str,
        "default": "off",
        "options": ["off", "ring"],
        "description": "TPU extension: overlapped tensor parallelism "
        "(env alias SMP_TP_OVERLAP). 'off' (default): the GSPMD path — "
        "synchronous tp all-gather/reduce-scatter/all-reduce around the "
        "tp matmuls, byte-identical programs to older builds. 'ring': "
        "the column-parallel input all-gather and row-parallel output "
        "reduce-scatter of the tp attention/MLP blocks decompose into "
        "tp-many ppermute hops, each hidden under the partial matmul on "
        "the block already in hand (ops/collective_matmul.py; "
        "double-buffered, custom_vjp mirrored backward ring). Implies "
        "the sequence-parallel (optimize: memory) residual layout over "
        "tp. Inert at tensor_parallel_degree 1; does not compose with "
        "context_parallel_degree > 1 (the ring owns the sequence axis).",
    },
    "matmul_precision": {
        "type": str,
        "default": "bf16",
        "options": ["bf16", "fp8"],
        "description": "TPU extension: training matmul precision (env "
        "alias SMP_MATMUL_PRECISION). 'bf16' (default): byte-identical "
        "programs to older builds — the knob contributes nothing to "
        "step keys, exec-cache facts, or X-ray fingerprints. 'fp8': "
        "the matmul seams (tp ring chunk matmuls, fused-QKV Pallas "
        "kernel, transformer/linear einsum paths, bias+GELU epilogue "
        "input, attention score operands) quantize to fp8 — e4m3 "
        "forward operands, e5m2 gradients — with delayed scaling: "
        "per-slot amax history threaded through the step like the "
        "fp16 loss scaler (smp.quant.QuantState; checkpointed beside "
        "it as quant_states.pt). Canonicalizes back to bf16 under "
        "pipeline_parallel_degree > 1 or sharded_params: zero3 (warn "
        "once). On CPU/interpret XLA upcasts the f8 dots — CPU runs "
        "prove parity, not speed (BENCH_NOTES Round 20).",
    },
    "fused_qkv": {
        "type": bool,
        "default": False,
        "description": "TPU extension: dispatch the attention QKV "
        "projection to the Pallas fused matmul+bias kernel "
        "(ops/pallas_qkv.py) — one kernel against the concatenated, "
        "tp-sharded [in, 3*head] weight, bias folded into the epilogue. "
        "Engages at tensor_parallel_degree 1 directly, and under "
        "tp_overlap: ring inside the ring's partial matmuls; the "
        "GSPMD tp path keeps the einsum (the sharded kernel cannot "
        "enter a plain pallas_call without a gather).",
    },
    "recompute": {
        "type": str,
        "default": "full",
        "options": ["full", "stash_weight", "stash_all", "auto"],
        "description": "TPU extension: memory-budgeted recompute planner "
        "(env alias SMP_RECOMPUTE). 'full' (default): every backward pass "
        "re-runs its chunk forward (activation recomputation; the compiled "
        "program is byte-identical to older builds). 'stash_weight': the "
        "zero-bubble executor's B pass captures per-layer jax.vjp "
        "residuals so the deferred W pass consumes them instead of "
        "re-running the forward — a single forward per microbatch. "
        "'stash_all': residuals are captured at the forward pass itself, "
        "removing the B recompute too (also applies to the "
        "interleaved/1F1B executors). 'auto': the schedule's default "
        "stash (stash_weight on zero_bubble — memory-conservative, its "
        "rings cost only the existing W-queue depth; stash_all on "
        "interleaved/1F1B) budgeted against recompute_budget_mb and "
        "degraded per-(stage, chunk) by the planner "
        "(parallel/remat_plan.py). Non-pipeline paths map the knob onto "
        "jax.checkpoint policies (dots_with_no_batch_dims_saveable "
        "family).",
    },
    "recompute_budget_mb": {
        "type": (int, type(None)),
        "default": None,
        "lower_bound": 0,
        "description": "TPU extension: stash budget in MiB for "
        "recompute: auto (env alias SMP_RECOMPUTE_BUDGET_MB). Unset: the "
        "XLA memory-breakdown temp bytes of the last audited program, "
        "else the planner's own ring bound (stash everything).",
    },
    "_device_count_override": {
        "type": (int, type(None)),
        "default": None,
        "internal": True,
        "description": "TPU extension: build the mesh over this many devices "
        "instead of len(jax.devices()) (testing / dry-run).",
    },
}
