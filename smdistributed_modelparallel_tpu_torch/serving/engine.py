"""Continuous-batching serving engine (``smp.serving``).

Counterpart of ``smdistributed_modelparallel_tpu/serving/engine.py`` on one
device. ``smp.generate`` runs one static batch: no request queue, no cache
shared between requests. The engine serves a stream of ragged requests:

**Paged KV cache.** One pool of fixed-size token blocks a layer
(``SMP_KV_BLOCK_TOKENS`` tokens each; ``nn/utils.PagedKVCache``), shared by
every sequence in flight through per-sequence block tables that the host-side
allocator (``serving/kv_cache.BlockAllocator``) keeps. A finished sequence's
blocks are free the moment it completes.

**Continuous batching.** Requests queue; every engine tick admits arrivals
into free decode slots, runs ONE batched decode step over every stream in
flight and ONE prefill chunk (``SMP_PREFILL_CHUNK`` prompt tokens) of one
admitting request, round-robin, so a long prompt never stalls the streams
already flowing. Where the JAX package compiles two programs, the engine
builds two fixed-shape callables (``_program("decode")`` over all slots,
``_program("prefill")`` over one chunk) that run the half-cast paged clone of
the model under ``torch.inference_mode()``. Neither reaches the flash kernel:
the prefill mask varies along the chunk and decode has T = 1, so attention
takes the plain path, as in the JAX package. Sampled rows draw their Gumbel
noise through ``ops/dropout.categorical`` (the ``threefry_bits`` kernel on
the card), one draw a sampled token.

**Restartable requests.** Each request's prompt and sampled tokens are kept
(``mirror_log``) while it is in flight, so a request can be re-admitted
elsewhere with ``resume_tokens`` and continue its key schedule; ``drain``
hands back the requests never admitted as such records.

Sampling parity: a request served here gives token for token what
``smp.generate`` gives for the same prompt at batch 1 with
``rng=utils.random.key(seed)``: the same key schedule (``split(key,
max_new_tokens)``), the same filters (temperature, then top-k, then top-p),
the same greedy argmax; and with the same weights, the JAX engine's tokens.

**int8.** ``SMP_DECODE_WEIGHTS=int8`` keeps the resident weights as int8
with per-channel scales in the JAX layout (``quant.quantize_decode_params``,
at construction and at ``adopt_params``); each program dequantizes them to
fp32 on the way in and half-casts, as the JAX engine does.
``SMP_KV_QUANT=int8`` stores the pools int8 with per-block, per-head scales
(``nn/utils.PagedKVCache``); ``kv_block_bytes`` counts the scales too.

**Observability**, as in the JAX engine: request lifecycle counts
(``record_serve_request``), the latency histograms (queue wait, TTFT, prefill,
inter-token, decode step; ``record_serve_latency``), token counts, the
occupancy gauges, one flight-recorder span edge per request event
(``record_serve_trace``), the program count, the int8 knobs'
``record_quant_dispatch`` at construction, the profiler regions
``serve/decode_step``, ``serve/prefill_chunk`` and ``serve/compile_<kind>``,
and the metrics time series (``SMP_TIMESERIES_INTERVAL`` > 0:
``utils/timeseries.MetricsTimeSeries``, polled from every tick, with a daemon
thread for idle gaps that ``close()`` stops).

**Resilience**, as in the JAX engine: the chaos harness's serving seams
(``SMP_CHAOS``: ``chaos.on_serve_decode`` at every tick's decode boundary,
``chaos.on_weight_update`` in ``adopt_params``) and the fleet metrics plane's
inline tick (``fleet.tick()`` every tick; ``smp.init`` starts the plane
under ``SMP_FLEET_INTERVAL`` > 0).

Left out, each refused at construction: the executable cache, the
compiled-program audit and the serving control plane, and the environment
variables that arm them (each with its own slice), and more than one rank
(tp, pp or cp > 1; ``replica.py``, ``router.py`` and ``controller.py`` come
with slice 3b, ROADMAP item 5b).
"""

import collections
import dataclasses
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.model import resolve_device
from smdistributed_modelparallel_tpu_torch.nn.utils import PagedKVCache, half_cast
from smdistributed_modelparallel_tpu_torch.ops.dropout import categorical
from smdistributed_modelparallel_tpu_torch.serving.kv_cache import (
    TRASH_BLOCK,
    BlockAllocator,
    block_tokens,
    prefill_chunk_tokens,
    serve_slots,
)
from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.step import _env_on
from smdistributed_modelparallel_tpu_torch.utils import profiling, random
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.fleet import fleet
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    record_quant_dispatch,
    record_serve_latency,
    record_serve_occupancy,
    record_serve_programs,
    record_serve_request,
    record_serve_tokens,
    record_serve_trace,
    record_weight_update,
)
from smdistributed_modelparallel_tpu_torch.utils.timeseries import MetricsTimeSeries

logger = get_logger()


# (environment variable, what it arms in the JAX package's engine, whether it asks).
_LEFT_OUT_ENV = (
    ("SMP_EXEC_CACHE", "the executable cache", _env_on),
    ("SMP_HLO_AUDIT", "the compiled-program audit", _env_on),
)


@dataclasses.dataclass
class ServeRequest:
    """One generation request.

    ``seed`` fixes the sampling key schedule (``split(key(seed),
    max_new_tokens)``, the schedule ``smp.generate`` uses), so serving output
    is reproducible and restartable. ``arrival_s`` is the request's arrival
    offset from the engine's start (synthetic traces); the scheduler never
    admits a request before it arrives. ``resume_tokens`` carries tokens
    already sampled when a request is re-admitted: the engine prefills
    prompt + resume and continues the key schedule at index
    ``len(resume_tokens)``. ``trace_id`` names the request's trace (the
    request id by default) and rides along in its records.
    """

    request_id: str
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    seed: int = 0
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None
    resume_tokens: Tuple[int, ...] = ()
    trace_id: Optional[str] = None


def serve_request_from_record(rec):
    """Rebuild a restartable ``ServeRequest`` from a mirror-log record (the
    format ``_mirror`` writes): the tokens already sampled ride as
    ``resume_tokens``, so the re-admitting engine continues the key schedule
    where the record left off."""
    return ServeRequest(
        request_id=rec["rid"],
        prompt=rec["prompt"],
        max_new_tokens=rec["max_new_tokens"],
        temperature=rec.get("temperature", 0.0),
        top_k=rec.get("top_k"),
        top_p=rec.get("top_p"),
        eos_token_id=rec.get("eos_token_id"),
        seed=rec.get("seed", 0),
        deadline_s=rec.get("deadline_s"),
        resume_tokens=tuple(rec.get("tokens", ())),
        trace_id=rec.get("trace_id"),
    )


def serve_request_to_record(req):
    """Inverse of ``serve_request_from_record``: a ``ServeRequest`` as a
    mirror record (plain JSON)."""
    return {
        "rid": req.request_id,
        "prompt": list(map(int, req.prompt)),
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": req.temperature,
        "top_k": req.top_k,
        "top_p": req.top_p,
        "eos_token_id": req.eos_token_id,
        "seed": req.seed,
        "deadline_s": req.deadline_s,
        "tokens": list(map(int, req.resume_tokens)),
        "done": False,
        "trace_id": req.trace_id,
    }


class _Slot:
    __slots__ = (
        "req", "sid", "idx", "prompt_full", "resume_len", "pos",
        "new_tokens", "state", "rng_data", "t_arrival", "t_admit",
        "t_first_token", "t_last_token",
    )

    def __init__(self, req, rng_data, t_arrival, t_admit, idx):
        self.req = req
        self.sid = req.request_id
        self.idx = idx                   # decode-slot index
        self.prompt_full = list(map(int, req.prompt)) + list(
            map(int, req.resume_tokens)
        )
        self.resume_len = len(req.resume_tokens)
        self.pos = 0                     # tokens cached so far
        self.new_tokens = []             # sampled THIS incarnation
        self.state = "prefill"
        self.rng_data = rng_data         # [max_new, 2] uint32
        self.t_arrival = t_arrival
        self.t_admit = t_admit
        self.t_first_token = None
        self.t_last_token = None

    @property
    def sample_index(self):
        """Index into the request's key schedule for the NEXT sample."""
        return self.resume_len + len(self.new_tokens)

    @property
    def remaining(self):
        return self.req.max_new_tokens - self.sample_index

    @property
    def total_tokens(self):
        """Worst-case sequence length at completion."""
        return len(self.req.prompt) + self.req.max_new_tokens

    @property
    def all_tokens(self):
        return list(self.req.resume_tokens) + self.new_tokens


def _sample_rows(logits, temps, top_ks, top_ps, key_data):
    """Per-row sampler over [S, V] fp32 logits (on the device) with per-row
    sampling parameters (numpy [S]; keys numpy [S, 2] uint32): the next
    token of each row, [S] int64 on the device.

    The JAX engine's composition: temperature, then top-k, then top-p on the
    k-filtered logits, then ``categorical`` on a [1, V] row with the row's
    key, so a stream gives ``smp.generate``'s tokens at batch 1. ``top_ks <=
    0`` and ``top_ps >= 1`` disable the filters; ``temps <= 0`` is greedy
    argmax, and such rows draw nothing.
    """
    greedy = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(temps > 0.0)
    if rows.size == 0:
        return greedy
    dev = logits.device
    V = logits.shape[-1]
    lg = logits[torch.as_tensor(rows, device=dev)]
    params = torch.as_tensor(np.stack([np.maximum(temps[rows], np.float32(1e-6)), top_ps[rows]], axis=1)
                             .astype(np.float32), device=dev)
    ks = torch.as_tensor(top_ks[rows].astype(np.int64), device=dev)[:, None]
    scaled = lg / params[:, :1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, ks.clamp(1, V) - 1)
    filtered = torch.where((ks <= 0) | (scaled >= kth), scaled, -torch.inf)
    sorted_p = torch.sort(filtered, dim=-1, descending=True).values
    probs = torch.softmax(sorted_p, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < params[:, 1:]
    thresh = torch.where(keep_p, sorted_p, torch.inf).amin(dim=-1, keepdim=True)
    filtered = torch.where(filtered >= thresh, filtered, -torch.inf)
    drawn = torch.stack([categorical(key_data[r], filtered[j:j + 1], axis=-1)[0] for j, r in enumerate(rows)])
    return greedy.index_copy(0, torch.as_tensor(rows, device=dev), drawn)


class _Trunk(torch.nn.Module):
    """The serving clone's ``trunk`` as a module's forward (its parameters
    under "lm."), for ``torch.func.functional_call``."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, ids, paged):
        return self.lm.trunk(ids, paged=paged)


class ServingEngine:
    """Continuous-batching serving engine over a paged KV cache.

    Args:
      model: a ``TransformerLM`` (zoo family) module, or a
        ``DistributedModel`` wrapping one.
      params: state dict override (required for a raw module).
      max_slots: concurrent decode streams (default ``SMP_SERVE_SLOTS``).
      num_blocks: KV-pool size in blocks, INCLUDING the reserved trash
        block. The default provisions ``max_slots`` worst-case sequences;
        below that, admission waits for free blocks.
      block_tokens_override / prefill_chunk: geometry overrides (default
        ``SMP_KV_BLOCK_TOKENS`` / ``SMP_PREFILL_CHUNK``).
      device: where the engine serves; None means the device ``smp.init``
        named, else ``cuda`` (pass ``"cpu"`` to serve on the CPU).
    """

    def __init__(self, model, params=None, *, max_slots=None,
                 num_blocks=None, block_tokens_override=None,
                 prefill_chunk=None, device=None):
        self._check_supported()
        if hasattr(model, "module"):  # DistributedModel
            module = model.module
            if params is None:
                params = module.state_dict()
        else:
            module = model
        if params is None:
            raise SMPValidationError(
                "ServingEngine(module, ...) requires params=... (or pass "
                "a DistributedModel)."
            )
        if "paged_blocks" not in getattr(module, "config", {}):
            raise SMPValidationError(
                f"{type(module).__name__} does not support paged decoding;"
                " smp.serving drives the TransformerLM zoo family (other "
                "families keep smp.generate)."
            )
        self.module = module
        self.params = params  # the weights last adopted, as passed (the controller's rollback point)
        self.device = resolve_device(device)
        self.max_len = int(module.max_len)
        self.bt = int(block_tokens_override or block_tokens())
        self.chunk = int(prefill_chunk or prefill_chunk_tokens())
        self.slots_n = int(max_slots or serve_slots())
        self.max_blocks_per_seq = -(-self.max_len // self.bt)
        if num_blocks is None:
            num_blocks = 1 + self.slots_n * self.max_blocks_per_seq
        self.alloc = BlockAllocator(
            int(num_blocks), self.bt, self.max_blocks_per_seq
        )
        self.half = state.cfg.half_dtype if state.cfg is not None else None
        self.decode_mod = module.clone(
            paged_blocks=int(num_blocks), paged_block_tokens=self.bt,
            deterministic=True, decode=False, decode_cache_len=None,
        )
        self.decode_mod.eval()
        self._trunk = _Trunk(self.decode_mod)
        # SMP_KV_QUANT is read by each layer's PagedKVCache (_init_cache).
        if quant.kv_quant_mode() == "int8":
            record_quant_dispatch("kv_cache", "int8")
        # SMP_DECODE_WEIGHTS=int8: weight-only int8, quantized once here (and
        # at adopt_params): the resident tree is int8 plus per-channel scales
        # in the JAX layout, which every program dequantizes on the way in.
        self.qparams = None
        if quant.decode_weights_mode() == "int8":
            self.qparams = self._quantize(params)
            record_quant_dispatch("decode_weights", "int8")
            self._param_avals = self._avals(self._flat(self.qparams))
            self.act_dtype = self.half or torch.float32
        else:
            # The serving clone owns its (half-cast) tensors, so adopt_params
            # copies into them without touching the caller's model.
            self._param_avals = self._avals(params)
            self.decode_mod.load_state_dict(
                {k: v.detach().to(self.device, copy=True) for k, v in half_cast(params, self.half).items()},
                assign=True,
            )
            self.act_dtype = self.decode_mod.wte.weight.dtype
        self._slots = [None] * self.slots_n
        self._queue = collections.deque()
        self._prefill_rr = 0
        self._occupancy_snap = None
        self.results = {}
        self.finished = set()
        self._admit_order = []   # rids in admission order (chaos seam)
        self._arrival_s = {}     # rid -> effective arrival (engine clock)
        self.last_tick_worked = True
        self.mirror_log = {}     # rid -> restartable record
        self._dirty = set()      # rids with unmirrored progress
        self._programs = {}
        self._admitting = True   # drain protocol: False = quiesced
        self.weights_version = 0  # bumped by adopt_params
        self.stats = collections.Counter()
        self._t0 = None
        self._init_cache()
        nb = self.alloc.num_blocks
        # The pools' bytes a block, the int8 scales included.
        self.kv_block_bytes = sum(
            t.numel() * t.element_size() for pools in self.kv_pools() for t in pools
        ) // nb
        # Metrics time-series snapshotter (the autoscaler feed):
        # SMP_TIMESERIES_INTERVAL=0 (the default) constructs NOTHING — no
        # ring, no thread. When armed, the engine also polls it from the
        # tick path so window edges stay sharp while the loop is busy; the
        # thread only covers idle gaps. One device: one chip.
        self.timeseries = MetricsTimeSeries.from_env(chips=1)
        if self.timeseries is not None:
            self.timeseries.start()

    @staticmethod
    def _check_supported():
        for env, what, asks in _LEFT_OUT_ENV:
            if asks(env):
                raise NotImplementedError(
                    f"smp.serving: {what} ({env}={os.environ.get(env)!r}) is not ported to PyTorch yet "
                    "(the operations slice)."
                )
        cfg = state.cfg
        if cfg is not None and cfg.pipeline_parallel_degree > 1:
            raise NotImplementedError(
                f"smp.serving: pipeline_parallel_degree = {cfg.pipeline_parallel_degree} is not ported to PyTorch "
                "yet (ROADMAP item 8); the engine serves one device."
            )
        if cfg is not None:
            degrees = {
                "tensor_parallel_degree": cfg.tensor_parallel_degree,
                "pipeline_parallel_degree": cfg.pipeline_parallel_degree,
                "context_parallel_degree": cfg.context_parallel_degree,
                "expert_parallel_degree": cfg.expert_parallel_degree,
            }
            over = [f"{k} = {v}" for k, v in degrees.items() if v > 1]
            if over:
                raise NotImplementedError(
                    f"smp.serving: {', '.join(over)} is not ported to PyTorch yet; the engine serves one device, "
                    "and a deployment of several is replicas of it (ReplicatedServingEngine, the router and the "
                    "controller; sharded serving is ROADMAP item 5b)."
                )

    @staticmethod
    def _avals(params):
        return {k: (tuple(v.shape), v.dtype) for k, v in params.items()}

    @staticmethod
    def _flat(qparams):
        return {f"{part}/{k}": v for part in ("q", "s") for k, v in qparams[part].items()}

    def _quantize(self, params):
        # Copies: a leaf that stays float must not alias the caller's tensor.
        return quant.quantize_decode_params({k: v.detach().to(self.device, copy=True) for k, v in params.items()},
                                            self.module)

    def _run(self, ids, paged, head=True):
        """The serving clone's forward (``head``: logits) or its trunk on
        ``ids``: on its half-cast weights, or under int8 weights on the
        resident tree dequantized to fp32 and then half-cast, as the JAX
        engine's ``_deq_params`` and ``_half_params`` do."""
        mod = self.decode_mod if head else self._trunk
        if self.qparams is None:
            return mod(ids, paged=paged)
        params = half_cast(quant.dequantize_decode_params(self.qparams, self.module), self.half)
        if not head:
            params = {"lm." + k: v for k, v in params.items()}
        return torch.func.functional_call(mod, params, (ids,), {"paged": paged})

    def close(self):
        """Stop the time-series snapshotter thread, if armed, and stop
        admitting. Idempotent; the engine remains usable for draining
        (sampling continues through tick polling).

        A close with work still queued or in flight does not abandon it
        silently: every unfinished request's restartable record is marked
        dirty again, so the next ``drain_dirty`` hands it on, and the
        abandonment is counted (``smp_serve_requests_total{event="abandoned"}``)."""
        self.quiesce()
        abandoned = [q.request_id for q in self._queue] + [
            s.sid for s in self._slots if s is not None
        ]
        for rid in abandoned:
            if rid in self.mirror_log:
                self._dirty.add(rid)
            record_serve_trace("abandoned", rid, detail="close")
        if abandoned:
            record_serve_request("abandoned", len(abandoned))
            logger.warning(
                "[serving] close() with %d unfinished request(s); their "
                "restartable records are mirror-logged for re-admission "
                "elsewhere.", len(abandoned),
            )
        if self.timeseries is not None:
            self.timeseries.stop()

    # -- drain protocol (scale-down / weight adoption / clean close) ----

    @property
    def in_flight(self):
        """Admitted, unfinished streams (excludes the queue)."""
        return sum(1 for s in self._slots if s is not None)

    def quiesce(self):
        """Stop admission: queued requests stay queued, in-flight streams
        keep decoding. ``submit`` refuses new work while quiesced.
        Idempotent."""
        if self._admitting:
            self._admitting = False
            record_serve_trace("quiesce", "-", detail="admission stopped")

    def resume_admission(self):
        """Reopen admission after a quiesce or drain."""
        if not self._admitting:
            self._admitting = True
            record_serve_trace("resume_admission", "-")

    def drain(self, timeout_s=120.0):
        """Stop admitting, finish every IN-FLIGHT stream, and hand back the
        queued requests never admitted as restartable straggler records
        (possibly none) for re-admission elsewhere. The engine stays usable:
        ``resume_admission()`` reopens intake."""
        self.quiesce()
        stragglers = []
        while self._queue:
            req = self._queue.popleft()
            self._arrival_s.pop(req.request_id, None)
            rec = self.mirror_log[req.request_id]  # submit mirrors every queued request
            stragglers.append(dict(rec, tokens=list(rec["tokens"])))
            self._dirty.add(req.request_id)
            record_serve_trace("drained_straggler", req.request_id, trace=req.trace_id)
        if stragglers:
            record_serve_request("drained_straggler", len(stragglers))
        deadline = time.monotonic() + timeout_s
        while self.in_flight:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain exceeded {timeout_s:g}s with "
                    f"{self.in_flight} stream(s) still in flight."
                )
            self.step()
            if not self.last_tick_worked:
                time.sleep(0.001)
        record_serve_trace("drained", "-", detail=f"stragglers={len(stragglers)}")
        return stragglers

    def adopt_params(self, params, *, version=None):
        """Live weight update between ticks: copy ``params`` (a state dict of
        the module's names) into the serving clone's tensors in place, cast
        as at construction, and bump ``weights_version``. Nothing is rebuilt.

        Streams must not be in flight (their KV holds the old weights'
        activations): quiesce and drain to idle first; queued requests
        prefill under the new weights. A state dict whose names, shapes or
        dtypes differ from the resident one's is refused. Returns the
        seconds it took."""
        if self.in_flight:
            raise SMPValidationError(
                f"adopt_params with {self.in_flight} stream(s) in flight "
                "would mix weights mid-stream; quiesce() and drain to "
                "idle first."
            )
        t0 = time.perf_counter()
        new_version = int(version) if version is not None else self.weights_version + 1
        params = adopted = chaos.on_weight_update(new_version, params)
        if self.qparams is not None:
            # Quantized before the comparison, as in the JAX engine: the
            # resident tree is the int8 layout.
            params = self._flat(self._quantize(params))
            target = self._flat(self.qparams)
        else:
            target = self.decode_mod.state_dict()
        if self._avals(params) != self._param_avals:
            raise SMPValidationError(
                "adopt_params: the new checkpoint's tree does not match "
                "the serving programs' parameter avals (structure/shape/"
                "dtype); load the checkpoint for this model instead."
            )
        with torch.no_grad():
            for name, value in params.items():
                target[name].copy_(value)
        self.weights_version = new_version
        self.params = adopted
        seconds = time.perf_counter() - t0
        # No program is rebuilt: no fresh compile, ever (the zero-recompile
        # contract the JAX engine counts).
        record_weight_update(seconds, self.weights_version, fresh=0)
        logger.info("[serving] adopted weights version %s in %.3fs", self.weights_version, seconds)
        return seconds

    # -- device state ---------------------------------------------------

    def _init_cache(self):
        """One ``PagedKVCache`` a layer, in the clone's activation dtype on
        the serving device (int8 pools under ``SMP_KV_QUANT=int8``)."""
        for layer in self.decode_mod.layers:
            attn = layer.attn
            attn.cache = PagedKVCache(
                self.alloc.num_blocks, self.bt, attn.n_heads, attn.d_model // attn.n_heads, self.act_dtype,
                self.device,
            )

    def kv_pools(self):
        """The pools, one tuple a layer: ``(key, value)``, each [num_blocks,
        block_tokens, H, hd], and under int8 also ``scale_key`` and
        ``scale_value`` [num_blocks, H] (``convert.kv_pools_to_jax`` gives the
        JAX engine's cache tree)."""
        return [layer.attn.cache.pools() for layer in self.decode_mod.layers]

    # -- the two programs -----------------------------------------------

    def _program(self, kind):
        """The two fixed-shape programs: ``decode`` ([slots] single tokens,
        [slots, max_blocks] tables) and ``prefill`` ([1, chunk] tokens, [1,
        max_blocks] table). Each takes numpy inputs and returns the sampled
        tokens as numpy; ``prefill`` samples (and runs the head) only on a
        prompt's last chunk, whose token is the stream's first."""
        prog = self._programs.get(kind)
        if prog is not None:
            return prog
        with profiling.region(f"serve/compile_{kind}"):
            prog = self._build_program(kind)
        self._programs[kind] = prog
        record_serve_programs(len(self._programs))
        logger.info(
            "[serving] %s program ready: slots=%d chunk=%d block_tokens=%d pool_blocks=%d",
            kind, self.slots_n, self.chunk, self.bt, self.alloc.num_blocks,
        )
        return prog

    def _build_program(self, kind):
        S, MB, C = self.slots_n, self.max_blocks_per_seq, self.chunk
        dev = self.device

        if kind == "decode":
            def prog(toks, positions, tables, temps, top_ks, top_ps, key_data):
                # One host-to-device copy for the integer inputs.
                ints = torch.as_tensor(np.concatenate([toks[:, None], positions[:, None], tables], axis=1),
                                       device=dev).long()
                with torch.inference_mode():
                    paged = {"block_tables": ints[:, 2:], "positions": ints[:, 1]}
                    logits = self._run(ints[:, :1], paged)
                    nxt = _sample_rows(logits[:, -1].float(), temps, top_ks, top_ps, key_data)
                return nxt.cpu().numpy()
        elif kind == "prefill":
            def prog(toks, table, start, valid, temps, top_ks, top_ps, key_data, sample=True):
                ints = torch.as_tensor(np.concatenate([toks, table, start[:, None], valid[:, None]], axis=1),
                                       device=dev).long()
                with torch.inference_mode():
                    paged = {"block_tables": ints[:, C:C + MB], "positions": ints[:, -2], "valid": ints[:, -1]}
                    ids = ints[:, :C]
                    if not sample:
                        self._run(ids, paged, head=False)  # fills the cache; no head, no sample
                        return None
                    logits = self._run(ids, paged)
                    last = logits[torch.arange(ids.shape[0], device=dev), ints[:, -1] - 1].float()
                    tok = _sample_rows(last, temps, top_ks, top_ps, key_data)
                return tok.cpu().numpy()
        else:  # pragma: no cover - internal misuse
            raise ValueError(kind)
        return prog

    # -- request intake -------------------------------------------------

    def submit(self, req):
        """Queue a request. Idempotent by request id: a rid that already
        finished (or is queued or in flight) is skipped, so re-admitting a
        request does not serve it twice."""
        if req.request_id in self.finished:
            return False
        if not self._admitting:
            return False
        if any(s is not None and s.sid == req.request_id
               for s in self._slots):
            return False
        if any(q.request_id == req.request_id for q in self._queue):
            return False
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_len:
            raise SMPValidationError(
                f"request {req.request_id!r}: prompt + max_new_tokens "
                f"({total}) exceeds the model's position limit "
                f"({self.max_len})."
            )
        if total > self.max_blocks_per_seq * self.bt:
            raise SMPValidationError(
                f"request {req.request_id!r}: {total} tokens exceed the "
                f"per-sequence table capacity "
                f"({self.max_blocks_per_seq * self.bt})."
            )
        req.trace_id = req.trace_id or req.request_id
        if len(req.resume_tokens) >= req.max_new_tokens:
            # Nothing left to generate: complete it here.
            self.results[req.request_id] = list(req.resume_tokens)
            self.finished.add(req.request_id)
            self._mirror(req, list(req.resume_tokens), done=True)
            record_serve_request("finished")
            record_serve_trace("queued", req.request_id, trace=req.trace_id)
            record_serve_trace(
                "finished", req.request_id, trace=req.trace_id,
                pos=len(req.resume_tokens), detail="fully_resumed",
            )
            return True
        self._queue.append(req)
        # A live submission arrives NOW; a synthetic trace may place the
        # arrival later.
        self._arrival_s[req.request_id] = max(
            self._now(), float(req.arrival_s)
        )
        # Mirrored from submit time, so queued requests are restartable too.
        self._mirror(req, list(req.resume_tokens), done=False)
        record_serve_trace("queued", req.request_id, trace=req.trace_id)
        return True

    @staticmethod
    def _rng_schedule(req):
        """The request's key schedule, ``split(key(seed), max_new_tokens)``:
        uint32 [max_new_tokens, 2], the words ``jax.random.key_data`` gives."""
        return random.split(random.key(req.seed), req.max_new_tokens)

    def _mirror(self, req, tokens, done):
        rid = req.request_id
        self.mirror_log[rid] = {
            "rid": rid,
            "prompt": list(map(int, req.prompt)),
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "top_k": req.top_k,
            "top_p": req.top_p,
            "eos_token_id": req.eos_token_id,
            "seed": int(req.seed),
            "deadline_s": req.deadline_s,
            "tokens": list(map(int, tokens)),
            "done": bool(done),
            "trace_id": req.trace_id or rid,
        }
        self._dirty.add(rid)

    def drain_dirty(self):
        """(rid, record) pairs with unmirrored progress; clears the dirty
        set."""
        out = [(rid, self.mirror_log[rid]) for rid in sorted(self._dirty)]
        self._dirty.clear()
        return out

    # -- scheduling -----------------------------------------------------

    @property
    def busy(self):
        return bool(self._queue) or any(
            s is not None for s in self._slots
        )

    def _now(self):
        if self._t0 is None:
            self._t0 = time.monotonic()
        return time.monotonic() - self._t0

    def _admit(self, now):
        if not self._admitting:
            return 0  # quiesced: the queue holds for drain
        admitted = 0
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                break
            # Arrival-ordered admission; a request that has not arrived yet
            # holds everything behind it.
            req = self._queue[0]
            arrival = self._arrival_s.get(
                req.request_id, max(req.arrival_s, 0.0)
            )
            if arrival > now:
                break
            need = len(req.prompt) + req.max_new_tokens
            if not self.alloc.can_reserve(need):
                break
            self._queue.popleft()
            self._arrival_s.pop(req.request_id, None)
            self.alloc.reserve(req.request_id, need)
            idx = free[0]
            slot = _Slot(
                req, self._rng_schedule(req),
                t_arrival=arrival, t_admit=now, idx=idx,
            )
            self._slots[idx] = slot
            self._admit_order.append(req.request_id)
            self._mirror(req, slot.all_tokens, done=False)
            record_serve_request("admitted")
            record_serve_latency("queue_wait", max(now - arrival, 0.0))
            record_serve_trace(
                "readmitted" if slot.resume_len else "admitted",
                req.request_id, trace=req.trace_id, slot=idx,
                pos=slot.resume_len,
            )
            self.stats["admitted"] += 1
            admitted += 1
        return admitted

    @staticmethod
    def _sampling_row(slot):
        req = slot.req
        return (
            float(req.temperature),
            int(req.top_k or 0),
            float(req.top_p if req.top_p is not None else 1.0),
        )

    def _finish(self, idx, now):
        slot = self._slots[idx]
        rid = slot.sid
        self.results[rid] = slot.all_tokens
        self.finished.add(rid)
        self._slots[idx] = None
        self.alloc.release(rid)
        self._mirror(slot.req, slot.all_tokens, done=True)
        record_serve_request("finished")
        if slot.req.deadline_s is not None and now - slot.t_arrival > slot.req.deadline_s:
            record_serve_request("deadline_miss")
        self.stats["finished"] += 1
        record_serve_trace(
            "finished", rid, trace=slot.req.trace_id, slot=slot.idx,
            pos=len(slot.all_tokens),
        )

    def _on_token(self, slot, tok, now):
        if slot.t_first_token is None:
            slot.t_first_token = now
            record_serve_latency("ttft", now - slot.t_arrival)
            record_serve_latency("prefill", now - slot.t_admit)
            record_serve_trace(
                "first_token", slot.sid, trace=slot.req.trace_id,
                slot=slot.idx, pos=slot.sample_index,
            )
        else:
            record_serve_latency("itl", now - slot.t_last_token)
        slot.t_last_token = now
        slot.new_tokens.append(int(tok))
        record_serve_tokens("generated", 1)
        self._mirror(slot.req, slot.all_tokens, done=False)
        req = slot.req
        return (
            (req.eos_token_id is not None and int(tok) == req.eos_token_id)
            or slot.remaining <= 0
        )

    def _decode_step(self):
        active = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None and s.state == "decode"
        ]
        if not active:
            return False
        S, MB = self.slots_n, self.max_blocks_per_seq
        toks = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        tables = np.full((S, MB), TRASH_BLOCK, np.int32)
        temps = np.zeros((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        top_ps = np.ones((S,), np.float32)
        kd = np.zeros((S, 2), np.uint32)
        for i, slot in active:
            # The decode input is the latest sampled token; its K/V are
            # written at `pos`, so the allocator must cover pos+1 tokens.
            self.alloc.ensure(slot.sid, slot.pos + 1)
            toks[i] = slot.all_tokens[-1]
            positions[i] = slot.pos
            tables[i] = self.alloc.table(slot.sid)
            temps[i], top_ks[i], top_ps[i] = self._sampling_row(slot)
            kd[i] = slot.rng_data[slot.sample_index]
        program = self._program("decode")
        t_dispatch = self._now()
        with profiling.region("serve/decode_step"):
            sampled = program(toks, positions, tables, temps, top_ks, top_ps, kd)
        self.stats["decode_steps"] += 1
        # Token times are read after the device call returns (the copy of
        # the sampled tokens to the host is the step's sync point; no other
        # synchronize is issued on this path).
        now = self._now()
        record_serve_latency("decode_step", max(now - t_dispatch, 0.0))
        for i, slot in active:
            slot.pos += 1
            if self._on_token(slot, sampled[i], now):
                self._finish(i, now)
        return True

    def _prefill_tick(self):
        prefilling = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None and s.state == "prefill"
        ]
        if not prefilling:
            return False
        # Round-robin across admitting requests so two long prompts make
        # progress together.
        self._prefill_rr += 1
        i, slot = prefilling[self._prefill_rr % len(prefilling)]
        P = len(slot.prompt_full)
        C = self.chunk
        valid = min(C, P - slot.pos)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :valid] = slot.prompt_full[slot.pos:slot.pos + valid]
        self.alloc.ensure(slot.sid, slot.pos + valid)
        table = np.asarray([self.alloc.table(slot.sid)], np.int32)
        temps, top_ks, top_ps = self._sampling_row(slot)
        kd = slot.rng_data[slot.sample_index][None, :]
        last = slot.pos + valid >= P
        program = self._program("prefill")
        with profiling.region("serve/prefill_chunk"):
            tok = program(
                chunk, table, np.asarray([slot.pos], np.int32), np.asarray([valid], np.int32),
                np.asarray([temps], np.float32), np.asarray([top_ks], np.int32), np.asarray([top_ps], np.float32),
                kd.astype(np.uint32), sample=last,
            )
        slot.pos += valid
        self.stats["prefill_chunks"] += 1
        record_serve_tokens("prompt", valid)
        record_serve_trace(
            "prefill_chunk", slot.sid, trace=slot.req.trace_id,
            slot=slot.idx, pos=slot.pos, detail=f"valid={valid}",
        )
        if last:
            # Prompt fully cached: the sample from its last position is the
            # stream's first token.
            slot.state = "decode"
            now = self._now()
            if self._on_token(slot, int(tok[0]), now):
                self._finish(i, now)
        return True

    def _publish_occupancy(self):
        snap = (
            len(self._queue),
            sum(1 for s in self._slots if s is not None),
            self.alloc.used_blocks,
            self.alloc.reserved_unallocated,
        )
        if snap == self._occupancy_snap:
            return  # idle ticks must not spam the gauge registry
        self._occupancy_snap = snap
        record_serve_occupancy(
            queue_depth=snap[0],
            active_slots=snap[1],
            total_slots=self.slots_n,
            kv_used=snap[2],
            kv_free=self.alloc.free_blocks,
            kv_reserved=snap[3],
            kv_total=self.alloc.num_blocks,
            block_bytes=self.kv_block_bytes,
        )

    def _progress_of_admitted(self, n):
        """Chaos probe: (tokens emitted, finished?) of the n-th admitted
        request (1-based), or None when fewer than n were admitted."""
        if n < 1 or n > len(self._admit_order):
            return None
        rid = self._admit_order[n - 1]
        if rid in self.finished:
            return (len(self.results[rid]), True)
        for s in self._slots:
            if s is not None and s.sid == rid:
                return (len(s.all_tokens), False)
        return (0, False)

    def step(self):
        """One engine tick: admit arrivals into free slots, run one batched
        decode step, run one prefill chunk. Returns True while work remains;
        ``last_tick_worked`` says whether this tick did anything (False:
        waiting on arrivals or KV blocks, so callers should back off)."""
        now = self._now()
        worked = bool(self._admit(now))
        worked = self._decode_step() or worked
        chaos.on_serve_decode(self._progress_of_admitted)
        worked = self._prefill_tick() or worked
        self._publish_occupancy()
        if self.timeseries is not None:
            self.timeseries.maybe_sample()
        # The fleet publisher/aggregator ticks inline too, so a busy decode
        # loop keeps the fleet feed fresh (a no-op while SMP_FLEET_INTERVAL
        # is off).
        fleet.tick()
        self.last_tick_worked = worked
        return self.busy

    def run(self, requests=(), timeout_s=300.0):
        """Submit ``requests`` and tick until every queued or in-flight
        request completes (or ``timeout_s`` elapses). Returns
        ``{request_id: generated token list}``."""
        for req in requests:
            self.submit(req)
        deadline = time.monotonic() + timeout_s
        while self.busy:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"serving run exceeded {timeout_s:g}s with "
                    f"{len(self._queue)} queued and "
                    f"{sum(1 for s in self._slots if s)} in flight."
                )
            self.step()
            if not self.last_tick_worked:
                # Waiting on an arrival or on KV blocks.
                time.sleep(0.001)
        return dict(self.results)
