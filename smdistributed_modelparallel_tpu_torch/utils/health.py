"""Training-health monitor of the PyTorch port: the numerics sentinel, fault
bisection, and the OOM post-mortem.

Counterpart of ``smdistributed_modelparallel_tpu/utils/health.py``, with the
same env vars, tags, metric names, dump format and attribution strings.

- **Sentinel** (``SMP_HEALTH_CHECK=off|cheap|full``, default ``off``). While
  an ``@smp.step`` runs, a ``HealthCollector`` holds the tensors the JAX step
  program tags: ``loss`` and ``outputs`` per microbatch (stacked entries:
  they record the first bad microbatch), ``grads`` after the division, and
  under ``full`` the ``params`` at the step's start; ``smp.health.tag(name,
  x)`` adds one more. ``pack()`` reduces all of them in ONE launch of the
  ``csrc/health_reduce.cu`` kernel (``ops/health_reduce.py``) into the
  ``[K, 3]`` fp32 health word. ``off`` collects nothing and launches
  nothing; ``tag`` is identity.
- **Asynchronous fetch.** ``HealthMonitor.submit`` copies the word into
  pinned host memory with ``non_blocking=True`` and records a CUDA event;
  step N's word is decoded when step N+1 submits its own, after that event,
  so the host never waits on the step it just launched. ``full`` decodes at
  once. ``flush()`` runs at ``smp.shutdown``.
- **Bisection.** On a trip, ``bisect_step`` re-runs the faulting step's
  microbatches eagerly with the keys the step drew and the parameters it was
  dispatched with: the inputs (``input:``), a forward with module hooks
  whose outputs are folded into the JAX package's ``capture_intermediates``
  view (a layer stack's per-layer outputs into the scanned module's stacked
  entries, paths from the modules' flax scopes), the gradients (``grad:``)
  and the parameters (``param:``), keys mapped to the JAX package's
  through ``convert.jax_layout``. The attribution lands in telemetry
  (``smp_health_fault_total``), the flight recorder and the JSON dump at
  ``SMP_HEALTH_PATH``.
- **OOM post-mortem.** The step engine routes a ``torch.OutOfMemoryError``
  through ``maybe_oom_postmortem``: the dump holds the live tensors grouped
  by dtype and shape, the device's allocator statistics and the memory
  configuration; ``memory_analysis`` is None (there is no compiled
  executable). The error is re-raised by the caller.

Import-hygiene contract: importing this module builds nothing and touches no
device.
"""

import gc
import math
import os
import time
import warnings
from contextlib import contextmanager

import torch

from smdistributed_modelparallel_tpu_torch.utils import flight_recorder as _fr
from smdistributed_modelparallel_tpu_torch.utils import telemetry as _tel
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger
from smdistributed_modelparallel_tpu_torch.utils.telemetry import (
    _atomic_json_dump,
    telemetry,
)

logger = get_logger()

HEALTH_CHECK_ENV = "SMP_HEALTH_CHECK"
HEALTH_PATH_ENV = "SMP_HEALTH_PATH"
DEFAULT_HEALTH_PATH = "smp_health_dump.json"

_warned_mode = set()

# Cheap mode samples the optimizer-update norm gauges every Nth
# optimizer.step; full mode records every step. The first step always
# records so short runs/tests see the gauges.
UPDATE_STATS_EVERY = 16
_update_stats_calls = [0]


def mode():
    """Configured sentinel mode, read from the environment at call time."""
    raw = os.environ.get(HEALTH_CHECK_ENV, "").strip().lower()
    if raw in ("", "0", "false", "off", "no", "none"):
        return "off"
    if raw in ("1", "on", "true", "cheap"):
        return "cheap"
    if raw == "full":
        return "full"
    if raw not in _warned_mode:
        _warned_mode.add(raw)
        logger.warning(
            "invalid %s=%r (want off|cheap|full); health checks disabled.",
            HEALTH_CHECK_ENV, raw,
        )
    return "off"


def enabled():
    return mode() != "off"


def _health_path():
    path = os.environ.get(HEALTH_PATH_ENV) or DEFAULT_HEALTH_PATH
    return telemetry._rank_path(path)


# ----------------------------------------------------------------------
# The collector (active only while an @smp.step runs)
# ----------------------------------------------------------------------


class HealthCollector:
    """The entries of one step: ``(name, leaves, num_mb)``, reduced by
    ``pack()`` into the ``[K, 3]`` health word in one kernel launch. The
    entries hold references to the step's tensors; a collector never
    outlives its step."""

    def __init__(self, mode):
        self.mode = mode
        self.entries = []

    def add_tree(self, name, tree):
        """One entry for a whole tree (no microbatch axis). A ``Leaf``
        inside ``tree`` counts as one leaf."""
        leaves = _leaves_of(tree)
        if leaves:
            self.entries.append((str(name), leaves, None))

    def add_stacked(self, name, tree, num_mb=None):
        """One entry for a tree whose leaves lead with a microbatch axis;
        also records the first microbatch index with a non-finite value."""
        leaves = _leaves_of(tree)
        if not leaves:
            return
        first = leaves[0]
        n = (len(first) if isinstance(first, list) else int(first.shape[0])) if num_mb is None else int(num_mb)
        self.entries.append((str(name), leaves, n))

    def pack(self):
        """(word [K, 3] fp32, [name, ...]) or (None, None) when empty."""
        if not self.entries:
            return None, None
        from smdistributed_modelparallel_tpu_torch.ops.health_reduce import health_reduce

        return health_reduce(self.entries), [name for name, _, _ in self.entries]


class Leaf(list):
    """Tensors that count as ONE leaf of an entry: the pieces of one JAX
    leaf (a tree entry), or one leaf's per-microbatch rows (a stacked
    entry)."""


def _leaves_of(tree):
    """The floating-point tensors of a nest of dicts, lists and tuples, in
    the JAX package's tree order (dict keys sorted); a ``Leaf`` gives its
    pieces as one list."""
    if isinstance(tree, Leaf):
        pieces = [p for p in tree if isinstance(p, torch.Tensor) and p.is_floating_point()]
        return [pieces] if pieces else []
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves_of(v)]
    return []


_collector = None


def active():
    """The collector of the step in progress, or None (mode off / not inside
    a step)."""
    return _collector


@contextmanager
def collecting(health_mode):
    """Activate a fresh collector for one step."""
    global _collector
    prev = _collector
    _collector = HealthCollector(health_mode) if health_mode != "off" else None
    try:
        yield _collector
    finally:
        _collector = prev


def tag(name, x):
    """Tag a tensor for the sentinel inside an ``@smp.step`` function:
    ``loss = smp.health.tag("loss", loss)``. Identity always; with the
    sentinel off (or outside a step) it does nothing else."""
    hc = _collector
    if hc is not None:
        hc.add_tree(name, x)
    return x


# ----------------------------------------------------------------------
# Host-side monitor (async fetch + trip handling)
# ----------------------------------------------------------------------


def _fetch_async(word):
    """Start copying ``word`` to the host: ``(host tensor, CUDA event or
    None)``. A CPU word is its own host copy."""
    if word.device.type != "cuda":
        return word, None
    host = torch.empty(word.shape, dtype=word.dtype, pin_memory=True)
    host.copy_(word, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(word.device))
    return host, event


def _host_values(host, event):
    """The fetched values as nested Python floats, after ``event``."""
    if event is not None:
        event.synchronize()  # the copy of an earlier step: no wait on this one
    return host.double().tolist()


class HealthMonitor:
    """Holds the pending (still-on-device) health word and decodes the
    previous step's word on each submit: the device-to-host copy of step N
    overlaps step N+1, so cheap mode adds no per-step sync."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._pending = None
        self.last_check = None       # {"step", "tags": {name: {...}}}
        self.checked_steps = []      # decode order (test hook)
        self.trips = []              # bounded trip records
        self.max_bisections = 4
        self._bisections = 0

    @property
    def pending_step(self):
        return self._pending["step"] if self._pending else None

    def submit(self, step, word, schema, health_mode, bisect_fn=None):
        host, event = _fetch_async(word)
        prev, self._pending = self._pending, {
            "step": step, "host": host, "event": event, "schema": list(schema),
            "bisect": bisect_fn,
        }
        if prev is not None:
            self._check(prev)
        if health_mode == "full":
            self.flush()

    def flush(self):
        """Decode the pending word now (waits until its step finishes), and
        publish update stats still in flight. Called at smp.shutdown so the
        final step is never left unchecked."""
        _publish_update_stats()
        pending, self._pending = self._pending, None
        if pending is not None:
            self._check(pending)

    def _check(self, pending):
        try:
            w = _host_values(pending["host"], pending["event"])
        except RuntimeError as e:  # the step itself failed; nothing to decode
            logger.debug("health word fetch failed: %r", e)
            return
        step = pending["step"]
        self.checked_steps.append(step)
        tags = {}
        for i, name in enumerate(pending["schema"]):
            tags[name] = {
                "bad": float(w[i][0]),
                "absmax": float(w[i][1]),
                "microbatch": int(w[i][2]),
            }
        self.last_check = {"step": step, "tags": tags}
        _tel.record_health_check(step, tags)
        bad_tags = {
            n: d for n, d in tags.items()
            if d["bad"] > 0 or not math.isfinite(d["absmax"])
        }
        if bad_tags:
            self._trip(pending, bad_tags)

    def _trip(self, pending, bad_tags):
        step = pending["step"]
        for name, d in bad_tags.items():
            _tel.record_health_trip(
                name, step, d["bad"], d["absmax"], d["microbatch"]
            )
        logger.error(
            "HEALTH SENTINEL TRIPPED at step %d: non-finite values in %s",
            step, sorted(bad_tags),
        )
        attribution = None
        bisect_fn = pending.get("bisect")
        if bisect_fn is not None and self._bisections < self.max_bisections:
            self._bisections += 1
            logger.warning(
                "health: bisecting step %d (re-running with per-module "
                "checkpoints) ...", step,
            )
            try:
                attribution = bisect_fn(bad_tags)
            except Exception as e:  # diagnostics must not kill training
                logger.error("health bisection failed: %r", e)
                attribution = {"error": repr(e)}
        if attribution and attribution.get("layer"):
            _tel.record_health_fault(
                attribution["layer"], attribution.get("microbatch", -1),
                ",".join(sorted(bad_tags)), step,
            )
            logger.error(
                "health: first non-finite value attributed to layer=%s "
                "microbatch=%s rank=%s",
                attribution["layer"], attribution.get("microbatch"),
                attribution.get("rank"),
            )
        self.trips.append({
            "kind": "health_trip",
            "step": step,
            "time": time.time(),
            "rank": telemetry.process_index or 0,
            "tags": bad_tags,
            "attribution": attribution,
        })
        del self.trips[:-16]
        self.dump()

    def report(self):
        return {
            "mode": mode(),
            "pending_step": self.pending_step,
            "checked_steps": list(self.checked_steps[-64:]),
            "last_check": self.last_check,
            "trips": list(self.trips),
        }

    def dump(self, path=None):
        """Write the monitor report (trips + last word) as JSON, atomically,
        rank-qualified: the same conventions as the telemetry dump."""
        path = path or _health_path()
        payload = {"kind": "health", **self.report()}
        return _atomic_json_dump(payload, path, "health dump")


monitor = HealthMonitor()


def reset():
    """smp.reset hook: drop pending words, stats and trip history."""
    monitor.reset()
    _update_stats_calls[0] = 0
    _pending_stats[:] = []


def report():
    """``smp.health.report()``: monitor state as a plain dict."""
    return monitor.report()


# ----------------------------------------------------------------------
# Bisection: attribute the first non-finite value to layer + microbatch
# ----------------------------------------------------------------------


class _Stacked:
    """One captured intermediate of a layer stack: the per-layer outputs
    that flax's ``nn.scan`` stacks into one array."""

    def __init__(self):
        self.parts = []


def _bad(t):
    return bool((~torch.isfinite(t)).any())


def _first_bad_path(tree, prefix=""):
    """'/'-joined path of the first leaf holding a non-finite value, walking
    mappings in insertion order, or None. Non-float leaves are skipped."""
    if isinstance(tree, _Stacked):
        leaves = [t for part in tree.parts for t in _leaves_of(part)]
        return (prefix or "<root>") if any(_bad(t) for t in leaves) else None
    if hasattr(tree, "items"):
        for k, v in tree.items():
            got = _first_bad_path(v, f"{prefix}/{k}" if prefix else str(k))
            if got is not None:
                return got
        return None
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            got = _first_bad_path(v, f"{prefix}/{i}" if prefix else str(i))
            if got is not None:
                return got
        return None
    if not (isinstance(tree, torch.Tensor) and tree.is_floating_point()):
        return None
    if _bad(tree):
        return prefix or "<root>"
    return None


def _jax_named(model, tensors):
    """``tensors`` ({torch parameter name: tensor}) under the JAX package's
    flat keys, in sorted key order (the layer stack's per-layer tensors
    stacked into one leaf); torch names for a module the JAX package has no
    layout for."""
    from smdistributed_modelparallel_tpu_torch import convert

    layout = convert.jax_layout(model.module, host=False)
    if layout is not None:
        try:
            flat = layout[0](tensors)
            return {k: flat[k] for k in sorted(flat)}
        except KeyError:
            pass
    return {k.replace(".", "/"): tensors[k] for k in sorted(tensors)}


def jax_leaf_groups(model, names):
    """``(groups, names)``: the parameter names ``names`` grouped by the JAX
    package's leaf they belong to (a layer stack's per-layer tensors of one
    flax parameter form one leaf), the groups in sorted key order. Keys come
    from ``convert.jax_layout`` applied to meta tensors, with each name's
    layer index set to 0; a module without a layout keeps one group a
    name."""
    import re

    from smdistributed_modelparallel_tpu_torch import convert

    layout = convert.jax_layout(model.module, host=False)
    shapes = dict(model.module.named_parameters())
    keys = {}
    for n in names:
        key = n.replace(".", "/")
        if layout is not None:
            probe = re.sub(r"\.\d+\.", ".0.", n, count=1)
            try:
                (key,) = layout[0]({probe: torch.empty(shapes[n].shape, device="meta")})
            except (KeyError, ValueError, RuntimeError):
                pass
        keys.setdefault(key, []).append(n)
    return [keys[k] for k in sorted(keys)], set(names)


def _stack_roots(model):
    """Scope paths of the entries of the module's layer stacks (a
    ``ModuleList`` of a module that names its flax scan body)."""
    roots = set()
    scopes = model._rng_scopes
    for mod in scopes:
        body = getattr(mod, "_flax_scan_body", None)
        if body is None:
            continue
        for child in mod.children():
            if isinstance(child, torch.nn.ModuleList):
                roots.update(scopes[sub][0] for sub in child)
    return roots


def _node(tree, path):
    for k in path:
        tree = tree.setdefault(k, {})
    return tree


def _sorted_tree(tree):
    """Dicts with sorted keys, as JAX's tree flattening gives a scanned
    module's intermediates back."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _intermediates(records, roots):
    """The JAX package's ``capture_intermediates`` tree of one forward from
    the hooked ``(scope path, layer, output)`` records in completion order:
    each module's ``__call__`` outputs under its flax path; inside a layer
    stack, each path's per-layer outputs stacked, the stacked layer outputs
    also as the scanned module's carry (``<stack>/__call__/0/0/0``), and the
    scan body's entries in sorted key order."""
    tree = {}
    stacks = {}
    for path, layer, out in records:
        if layer is None:
            _node(tree, path).setdefault("__call__", []).append(out)
            continue
        root = max((r for r in roots if path[:len(r)] == r), key=len)
        stack_path, body = root[:-1], root[-1]
        if stack_path not in stacks:
            carry = _Stacked()
            node = _node(tree, stack_path)
            node["__call__"] = (((carry, None, None), None),)  # one call: ((x, cross, mask), ys)
            stacks[stack_path] = (carry, node.setdefault(body, {}), body)
        carry, body_node, _ = stacks[stack_path]
        if path == root:
            carry.parts.append(out[0] if isinstance(out, tuple) else out)
        entry = _node(body_node, path[len(root):]).setdefault("__call__", (_Stacked(),))
        entry[0].parts.append(out)
    for stack_path, (_carry, body_node, body) in stacks.items():
        _node(tree, stack_path)[body] = _sorted_tree(body_node)
    return tree


def _bisect_forward(model, fn, params, args, kwargs, rngs):
    """One microbatch's forward with module hooks; ``{"layer": <path>}`` for
    the first captured output holding a non-finite value (JAX order), or
    None if the forward is clean."""
    scopes = model._rng_scopes
    roots = _stack_roots(model)
    records = []
    hooks = []
    for mod, (path, layer) in scopes.items():
        # The JAX package's smp.nn layers hold their projections as plain
        # parameters, not modules: the port's Linear children of a stacked
        # layer have no intermediate there.
        if layer is not None and type(mod) is torch.nn.Linear:
            continue
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, _p=path, _l=layer: records.append((_p, _l, o))))
    try:
        model._begin_microbatch(params, rngs)
        try:
            with torch.no_grad():
                fn(*args, **kwargs)
        finally:
            model._end_microbatch()
    finally:
        for h in hooks:
            h.remove()
    bad = _first_bad_path(_intermediates(records, roots))
    if bad is not None:
        return {"layer": bad}
    return None


def _bisect_grads(model, fn, params, args, kwargs, rngs):
    """Per-microbatch gradient re-run for backward-only faults: the first
    parameter path whose gradient is non-finite."""
    leaves = {n: t.detach().requires_grad_() for n, t in params.items() if t.is_floating_point()}
    model._begin_microbatch({**params, **leaves}, rngs)
    try:
        with torch.enable_grad():
            fn(*args, **kwargs)
    finally:
        loss = model._end_microbatch()[0]
    if loss is None:
        return None
    try:
        grads = torch.autograd.grad(loss.float(), list(leaves.values()), allow_unused=True)
    except RuntimeError as e:
        logger.debug("health grad bisection failed: %r", e)
        return None
    named = {n: g if g is not None else torch.zeros_like(t) for (n, t), g in zip(leaves.items(), grads)}
    bad = _first_bad_path(_jax_named(model, named))
    if bad is not None:
        return {"layer": "grad:" + bad}
    return None


def bisect_step(model, fn, mb_args_fn, num_mb, rng, has_backward, bad_tags,
                step_params=None):
    """Attribute a tripped step: first non-finite value -> (layer name,
    microbatch, rank). ``mb_args_fn(mb)`` rebuilds one microbatch's user-fn
    arguments from the retained step inputs; ``step_params`` is the
    ``{name: tensor}`` the faulting step was dispatched with. Without it the
    re-run would use post-update parameters, and a NaN an update spread over
    the whole tree would be attributed to the first layer."""
    from smdistributed_modelparallel_tpu_torch.utils import random

    rank = telemetry.process_index or 0
    params = step_params
    params_source = "dispatch"
    if params is None:
        params = {n: p.detach() for n, p in model.module.named_parameters()}
        params_source = "current"
    result = {"rank": rank, "microbatch": -1, "layer": None,
              "params_source": params_source}
    bad_param = _first_bad_path(_jax_named(model, {n: t.detach() for n, t in params.items()}))
    if bad_param is not None:
        result["param"] = bad_param
    grads_suspect = any(t == "grads" or t.startswith("grad") for t in bad_tags)
    # The step derives keys as split(rng) -> use_rng, then split(use_rng,
    # num_mb) a microbatch, each folded with the stream index (step.py).
    use_rng = random.split(rng)[0]
    mb_keys = random.split(use_rng, num_mb)
    for mb in range(num_mb):
        args, kwargs = mb_args_fn(mb)
        bad_input = _first_bad_path((args, kwargs))
        if bad_input is not None:
            return {**result, "layer": "input:" + bad_input,
                    "microbatch": mb}
        rngs = {s: random.fold_in(mb_keys[mb], h) for h, s in enumerate(model.rng_streams)}
        att = _bisect_forward(model, fn, params, args, kwargs, rngs)
        if att is None and has_backward and grads_suspect:
            att = _bisect_grads(model, fn, params, args, kwargs, rngs)
        if att is not None:
            return {**result, **att, "microbatch": mb}
    if bad_param is not None:
        # Nothing re-triggered (e.g. a poisoned but unused parameter):
        # the parameter itself is still the attribution.
        result["layer"] = "param:" + bad_param
    else:
        result["note"] = "re-run found no non-finite value (transient?)"
    return result


def make_bisector(model, fn, mb_args_fn, num_mb, rng, has_backward,
                  step_params=None):
    def bisect(bad_tags):
        return bisect_step(
            model, fn, mb_args_fn, num_mb, rng, has_backward, bad_tags,
            step_params=step_params,
        )

    return bisect


# ----------------------------------------------------------------------
# Gradient / update-ratio gauges (optimizer.step wiring)
# ----------------------------------------------------------------------

# (host values, event) of update stats whose readback is still in flight.
_pending_stats = []


def _norm(tensors):
    """The global L2 norm of ``tensors`` in fp32, on their device."""
    tensors = [t for t in tensors if t.is_floating_point()]
    if not tensors:
        return None
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).norm()


def _publish_update_stats():
    """Record the update stats whose readback has landed (all of them: the
    event waited on is an earlier optimizer step's)."""
    while _pending_stats:
        host, event, has_grad, has_update = _pending_stats.pop(0)
        vals = _host_values(host, event)
        _tel.record_update_stats(vals[0] if has_grad else None, vals[1], vals[2] if has_update else None)


def update_stats_due():
    """Whether the next ``record_update_stats`` call records (the cadence):
    the optimizer snapshots the parameters before an update only then."""
    return mode() == "full" or _update_stats_calls[0] % UPDATE_STATS_EVERY == 0


def record_update_stats(model, old_params, new_params, grads=None):
    """Grad-norm / param-norm / update-ratio gauges around one optimizer
    step (``old_params``/``new_params``: the parameter tensors before and
    after it, in one order; ``old_params`` None skips the update ratio).
    Rate-limited in cheap mode, where the readback is asynchronous (recorded
    at the next call or at the monitor's flush, so no sync is added); full
    mode records at once. Never raises."""
    try:
        _publish_update_stats()
    except RuntimeError as e:
        logger.debug("health update stats failed: %r", e)
    n = _update_stats_calls[0]
    _update_stats_calls[0] = n + 1
    hmode = mode()
    if hmode != "full" and n % UPDATE_STATS_EVERY != 0:
        return
    try:
        with torch.no_grad():
            new_params = [t for t in new_params if t.is_floating_point()]
            param_norm = _norm(new_params)
            if param_norm is None:
                return
            grad_norm = _norm(list(grads)) if grads else None
            update_norm = None
            if old_params is not None:
                old_params = [t for t in old_params if t.is_floating_point()]
                update_norm = _norm([a.float() - b.float() for a, b in zip(new_params, old_params)])
            zero = torch.zeros_like(param_norm)
            vals = torch.stack([grad_norm if grad_norm is not None else zero, param_norm,
                                update_norm if update_norm is not None else zero])
        host, event = _fetch_async(vals)
        _pending_stats.append((host, event, grad_norm is not None, update_norm is not None))
        if hmode == "full" or event is None:
            _publish_update_stats()
    except RuntimeError as e:  # diagnostics must not break the update path
        logger.debug("health update stats failed: %r", e)


# ----------------------------------------------------------------------
# OOM post-mortem
# ----------------------------------------------------------------------


def is_resource_exhausted(err):
    if isinstance(err, torch.OutOfMemoryError):
        return True
    msg = str(err)
    return (
        "RESOURCE_EXHAUSTED" in msg
        or "Out of memory" in msg
        or "out of memory" in msg
    )


def _live_buffer_summary(top=20):
    """The live tensors, grouped by (dtype, shape) and ranked by bytes: the
    counterpart of ``jax.live_arrays()``."""
    groups = {}
    total = 0
    count = 0
    with warnings.catch_warnings():  # isinstance on lazy module attributes can warn
        warnings.simplefilter("ignore")
        objs = [obj for obj in gc.get_objects() if isinstance(obj, torch.Tensor)]
    for obj in objs:
        try:
            if obj.is_meta:
                continue
            nbytes = int(obj.numel() * obj.element_size())
            key = (str(obj.dtype).removeprefix("torch."), tuple(int(d) for d in obj.shape))
        except (RuntimeError, ReferenceError):
            continue
        count += 1
        total += nbytes
        cnt, byt = groups.get(key, (0, 0))
        groups[key] = (cnt + 1, byt + nbytes)
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "count": count,
        "total_bytes": total,
        "top_by_bytes": [
            {"dtype": dt, "shape": list(shape), "count": cnt, "bytes": byt}
            for (dt, shape), (cnt, byt) in ranked
        ],
    }


def _memory_config_summary():
    from smdistributed_modelparallel_tpu_torch.backend.state import state
    from smdistributed_modelparallel_tpu_torch.parallel.memory import offload_supported

    cfg = state.cfg
    out = {}
    if cfg is not None:
        for k in ("microbatches", "active_microbatches", "offload_activations",
                  "fused_optimizer_step", "fused_step_donation",
                  "pipeline_parallel_degree", "tensor_parallel_degree"):
            out[k] = getattr(cfg, k, None)
    out["offload_supported"] = bool(offload_supported())
    mm = state.module_manager
    if mm is not None:
        out["checkpoint_configs"] = sorted(mm.checkpoint_configs)
    return out


def oom_postmortem(name, compiled, err, path=None):
    """Dump an OOM breakdown next to the flight-recorder ring and record the
    event in telemetry and the ring. Returns the dump path (or None).

    ``compiled`` is the JAX package's failing executable, whose XLA
    ``memory_analysis`` it dumps; the port runs eagerly and passes None, so
    ``memory_analysis`` is None. ``device_memory_stats`` holds the caching
    allocator's statistics under the JAX keys (``utils/metrics.py``'s map:
    ``largest_alloc_size`` has no CUDA counterpart and is left out)."""
    from smdistributed_modelparallel_tpu_torch.utils.metrics import (
        _device_memory_stats,
        _local_devices,
    )

    payload = {
        "kind": "oom_postmortem",
        "name": name,
        "time": time.time(),
        "rank": telemetry.process_index or 0,
        "error": str(err)[:4000],
    }
    payload["memory_analysis"] = None
    payload["live_buffers"] = _live_buffer_summary()
    devices = {}
    for d in _local_devices():
        ms = _device_memory_stats(d)
        if ms:
            devices[str(d)] = {
                k: ms[k]
                for k in ("bytes_in_use", "peak_bytes_in_use",
                          "largest_alloc_size", "bytes_limit")
                if k in ms
            }
    payload["device_memory_stats"] = devices or None
    try:
        payload["memory_config"] = _memory_config_summary()
    except (AttributeError, RuntimeError) as e:
        payload["memory_config"] = {"error": repr(e)}
    _tel.record_oom(name)
    out_path = _atomic_json_dump(payload, path or _health_path(),
                                 "OOM post-mortem")
    logger.error(
        "out of memory in %s: post-mortem (live tensors, allocator "
        "statistics, memory config) written to %s", name, out_path,
    )
    # Put the ring on disk too (no-op without SMP_FLIGHT_RECORDER_PATH):
    # the events before the OOM are the context the breakdown lacks.
    _fr.flight_recorder.dump()
    return out_path


def maybe_oom_postmortem(name, compiled, err):
    """Post-mortem iff ``err`` is an out-of-memory error; the caller
    re-raises either way."""
    if is_resource_exhausted(err):
        try:
            oom_postmortem(name, compiled, err)
        except Exception as e:  # diagnostics must not mask the OOM
            logger.error("OOM post-mortem itself failed: %r", e)
