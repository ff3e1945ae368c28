"""The port's flight recorder, timeline, exit hook, memory metrics and the
step's observability seams against the JAX package's.

- The flight recorder and the timeline: the same events under a fixed
  clock give the same JSONL and Chrome-trace JSON, byte for byte with the
  clock anchors masked (the JAX timeline through its pure-Python backend:
  ``backend.native.load`` patched to return None).
- ``ExitHook``: the same exit codes and exceptions give the same status.
- The memory metrics: on the CPU neither package records a gauge; on a
  (faked) CUDA device the port's gauges carry the allocator's numbers under
  the JAX package's names and label key.
- End to end: a tiny ``smp.nn`` LM (2 layers, 32 wide; fused QKV and
  bias-GELU, the JAX kernels in interpret mode, the port's plain versions
  through the ``_is_cuda`` seams) trains 3 steps of 2 microbatches in both
  packages from the same weights (losses to 2e-5, as
  ``tests/test_torch_nn_transformer.py`` holds them) with
  ``SMP_TELEMETRY_PATH``, ``SMP_FLIGHT_RECORDER_PATH`` and
  ``SMP_TIMELINE_PATH`` set, then calls the model once outside a step,
  generates twice from one prompt shape (one program) and calls
  ``smp.shutdown()``. The dumps have the
  same metric families, less the ones only XLA has (``XLA_ONLY``, each
  with its reason), the same label keys, and equal values for the
  counters that count events (the fused-kernel dispatches of the step, the
  eager call and the generate program among them). The flight recorders hold the same step
  edges; the scripts (``telemetry_report.py``, ``trace_fuse.py``,
  ``perf_ledger.py``) read the port's dumps and exit 0, and
  ``telemetry_report.py`` prints the same with and without the JAX
  package importable.
- The step's variables that stay refused keep their messages.
"""

import difflib
import importlib
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.backend import native as jax_native
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.ops import pallas_gelu, pallas_qkv
from smdistributed_modelparallel_tpu.utils import exit_hook as jax_exit_hook
from smdistributed_modelparallel_tpu.utils import flight_recorder as jax_fr
from smdistributed_modelparallel_tpu.utils import timeline as jax_timeline
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.backend.state import state as port_state
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg
from smdistributed_modelparallel_tpu_torch.ops import matmul_bias as mb
from smdistributed_modelparallel_tpu_torch.utils import exit_hook as port_exit_hook
from smdistributed_modelparallel_tpu_torch.utils import flight_recorder as port_fr
from smdistributed_modelparallel_tpu_torch.utils import metrics as port_metrics
from smdistributed_modelparallel_tpu_torch.utils import timeline as port_timeline

port_step_mod = importlib.import_module("smdistributed_modelparallel_tpu_torch.step")  # smp.step is the decorator
ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8,
    hidden_size=32, intermediate_size=64, vocab_size=96, num_positions=32,
    causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0,
    hidden_dropout_prob=0.0, embedding_dropout_prob=0.0, fused_bias_gelu=True,
)
CFG = {"microbatches": 2, "fused_qkv": True}
STEPS = 3

# Families the JAX package's dump has and the port's cannot: each is read
# from XLA's compile of the step program, which the port does not have.
XLA_ONLY = {
    "smp_step_compile_cache_total": "lookups of the compiled-step cache (the port compiles no step program)",
    "smp_step_trace_seconds": "the jaxpr trace of the step program",
    "smp_step_lower_seconds": "XLA lowering of the step program",
    "smp_step_compile_seconds": "the XLA compile of the step program",
    "smp_compiled_step_flops": "XLA cost_analysis of the compiled step",
    "smp_compiled_step_bytes_accessed": "XLA cost_analysis of the compiled step",
    "smp_compiled_step_temp_bytes": "XLA memory_analysis of the compiled step",
    "smp_compiled_step_argument_bytes": "XLA memory_analysis of the compiled step",
    "smp_compiled_step_output_bytes": "XLA memory_analysis of the compiled step",
    "smp_hlo_audit_seconds_total": "the compiled-program audit of the HLO",
    "smp_hlo_audits_total": "the compiled-program audit of the HLO",
    "smp_hlo_memory_bytes": "the compiled-program audit of the HLO",
    "smp_hlo_remat_fraction": "the compiled-program audit of the HLO",
    "smp_hlo_replicated_bytes": "the compiled-program audit of the HLO",
    "smp_hlo_replicated_findings": "the compiled-program audit of the HLO",
    "smp_roofline_bytes": "the program's bytes come from XLA cost_analysis; the port counts FLOPs only",
    "smp_roofline_achieved_bytes_per_s": "needs the program's bytes (cost_analysis)",
    "smp_roofline_arithmetic_intensity": "needs the program's bytes (cost_analysis)",
}
# Counters that count events, and must agree.
EVENT_COUNTERS = ("smp_step_total", "smp_step_tokens_total", "smp_fused_kernel_dispatch_total")


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()
    jax_smp.reset()


# ----------------------------------------------------------------------
# The flight recorder and the timeline under a fixed clock
# ----------------------------------------------------------------------


class _Clock:
    """``time.perf_counter`` and ``time.time`` that advance 1 ms a call."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _frozen(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(time, "time", clock)
    return clock


def _ring_events(fr):
    fr.record_step("begin", 0)
    fr.record_compile("nvcc", "flash_fwd", 1.25)
    fr.record_compile("lower", "step", 0.5, fingerprint="abc")
    fr.record_phase("step_0")
    fr.record_collective("barrier", "WORLD", 0, 4)
    fr.record_collective("send", "WORLD", 128, 2, sequenced=False)
    fr.record_sync("barrier", "WORLD", 0)
    fr.record_wait("recv", 1, 3, "ok", 0.002)
    fr.record_serve("admitted", "r1", slot=2, pos=0)
    fr.record_serve("first_token", "r1", trace="t1", slot=2, pos=5, detail="x")
    fr.record_goodput("step", "startup", 1.5)
    fr.record_perf("regression", "step_time", detail="p50")
    fr.record_health("loss_scale", "overflow", value=1024.0)
    fr.record_schedule("1f1b", [(0, 0, "fwd", 0), (1, 0, "bwd", 0)])
    fr.record_watchdog("stall")
    fr.record_step("end", 0)


@pytest.mark.parametrize("size", [1024, 5])
def test_flight_recorder_dump_matches_jax(monkeypatch, tmp_path, size):
    dumps = []
    for mod in (jax_fr, port_fr):
        # The rank a smp.init of either package may have left on its registry.
        monkeypatch.setattr(mod.telemetry, "process_index", 0)
        monkeypatch.setattr(mod.telemetry, "process_count", 1)
        _frozen(monkeypatch)
        fr = mod.FlightRecorder(size=size)
        _ring_events(fr)
        path = tmp_path / f"{mod.__name__}.jsonl"
        assert fr.dump(str(path)) == str(path)
        lines = path.read_text().splitlines()
        meta = json.loads(lines[0])
        meta.pop("pid")
        dumps.append((meta, lines[1:], fr.snapshot(last=3), fr.last_seq("WORLD")))
    assert dumps[1] == dumps[0]
    assert len(dumps[1][1]) == min(size, 17)


@pytest.mark.parametrize("size_env, want", [("", 1024), ("0", 0), ("7", 7), ("x", 1024)])
def test_flight_recorder_size_env_matches_jax(monkeypatch, size_env, want):
    monkeypatch.setenv("SMP_FLIGHT_RECORDER_SIZE", size_env)
    port, ref = port_fr.FlightRecorder(), jax_fr.FlightRecorder()
    assert (port.size, port.enabled) == (ref.size, ref.enabled) == (want, want > 0)
    port.record_step("begin", 1)
    assert len(port) == (1 if want else 0)


def _timeline_events(tl):
    tl.start_step(0)
    tl.record_event("fwd", 10.0, 25.0, microbatch=1)
    tl.record_instant("marker", track="host")
    tl.sync_mark("barrier", "WORLD", 3)
    with tl.span("smp_phase/step/dispatch", track="phase"):
        pass
    tl.end_step(0)
    tl.flush()


def test_timeline_matches_jax_pure_python_backend(monkeypatch, tmp_path):
    from smdistributed_modelparallel_tpu_torch.backend import native as port_native

    monkeypatch.setattr(jax_native, "load", lambda *a, **k: None)
    monkeypatch.setattr(port_native, "load", lambda *a, **k: None)
    texts = []
    for mod in (jax_timeline, port_timeline):
        _frozen(monkeypatch)
        path = tmp_path / f"{mod.__name__}.json"
        tl = mod.Timeline(str(path))
        _timeline_events(tl)
        texts.append(re.sub(r"smp_clock_anchor/\d+/", "smp_clock_anchor/<us>/", path.read_text()))
    assert texts[1] == texts[0]
    events = json.loads(texts[1])["traceEvents"]
    assert events[0]["name"] == "smp_clock_anchor/<us>/0" and events[0]["ts"] == 0.0


def test_timeline_disabled_and_rank_qualified(monkeypatch, tmp_path):
    monkeypatch.delenv("SMP_TIMELINE_PATH", raising=False)
    tl = port_timeline.Timeline()
    assert not tl.enabled
    _timeline_events(tl)  # records and writes nothing
    monkeypatch.setattr(port_fr.telemetry, "process_index", 3)
    monkeypatch.setattr(port_fr.telemetry, "process_count", 4)
    monkeypatch.setenv("SMP_TIMELINE_PATH", str(tmp_path / "tl.json"))
    tl = port_timeline.Timeline()
    _timeline_events(tl)
    assert tl.path == f"{tmp_path / 'tl.json'}.rank3"
    assert json.loads(pathlib.Path(tl.path).read_text())["traceEvents"][0]["name"].endswith("/3")


# ----------------------------------------------------------------------
# ExitHook
# ----------------------------------------------------------------------


@pytest.mark.parametrize("code, exc, want", [(None, None, True), (0, None, True), (3, None, False),
                                             ("bye", None, False), (None, ValueError("x"), False)])
def test_exit_hook_matches_jax(monkeypatch, code, exc, want):
    before = sys.exit  # a smp.init may have hooked it already; unhook restores what was there
    statuses = []
    for mod in (jax_exit_hook, port_exit_hook):
        monkeypatch.setattr(sys, "excepthook", lambda *a: None)
        hook = mod.ExitHook()
        hook.hook()
        hook.hook()  # idempotent
        try:
            if code is not None:
                with pytest.raises(SystemExit):
                    sys.exit(code)
            if exc is not None:
                sys.excepthook(type(exc), exc, None)
        finally:
            hook.unhook()
        statuses.append((hook.exit_code, hook.exception, hook.success))
    assert statuses[1] == statuses[0] and statuses[1][2] is want
    assert sys.exit is before


# ----------------------------------------------------------------------
# Memory metrics
# ----------------------------------------------------------------------


def test_memory_metrics_record_nothing_on_the_cpu(monkeypatch, tmp_path):
    smp_torch.init({}, device="cpu")
    port_metrics.record_device_memory_telemetry()
    assert not [n for n in smp_torch.telemetry.report()["metrics"] if n.startswith("smp_device_")]
    monkeypatch.setenv("SMP_WRITE_STEP_MEMORY_METRICS", "1")
    path = tmp_path / "mem.jsonl"
    monkeypatch.setenv("SMP_STEP_MEMORY_METRICS_PATH", str(path))
    port_metrics.StepMemoryMetricsCollector().record_step(4)
    assert json.loads(path.read_text()) == {"step": 4, "devices": {"cpu": {}}}


def test_memory_metrics_read_the_cuda_allocator(monkeypatch, tmp_path):
    """The gauges and the per-step file, from ``torch.cuda.memory_stats`` (faked
    here), under the JAX package's gauge names, keys and label key."""
    stats = {"allocated_bytes.all.current": 1000, "allocated_bytes.all.peak": 5000}

    class Props:
        total_memory = 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(port_state, "device", "cuda")  # the index comes from the current device
    port_metrics.record_device_memory_telemetry()
    rep = smp_torch.telemetry.report()["metrics"]
    got = {n: (f["series"][0]["labels"], f["series"][0]["value"]) for n, f in rep.items()}
    assert got == {"smp_device_peak_hbm_bytes": ({"device": "cuda:0"}, 5000.0),
                   "smp_device_hbm_bytes_in_use": ({"device": "cuda:0"}, 1000.0),
                   "smp_device_hbm_bytes_limit": ({"device": "cuda:0"}, float(80 * 2 ** 30))}
    monkeypatch.setenv("SMP_WRITE_STEP_MEMORY_METRICS", "1")
    monkeypatch.setenv("SMP_STEP_MEMORY_METRICS_PATH", str(tmp_path / "m.jsonl"))
    port_metrics.StepMemoryMetricsCollector().record_step(0)
    assert json.loads((tmp_path / "m.jsonl").read_text())["devices"] == {
        "cuda:0": {"bytes_in_use": 1000, "peak_bytes_in_use": 5000, "bytes_limit": 80 * 2 ** 30}}


# ----------------------------------------------------------------------
# End to end: 3 steps of the tiny LM in both packages
# ----------------------------------------------------------------------


def _obs_env(mp, root, tag):
    out = root / tag
    out.mkdir()
    paths = {"SMP_TELEMETRY_PATH": out / "telemetry.json", "SMP_FLIGHT_RECORDER_PATH": out / "ring.jsonl",
             "SMP_TIMELINE_PATH": out / "timeline.json"}
    for k, v in paths.items():
        mp.setenv(k, str(v))
    mp.setenv("SMP_GOODPUT", "1")
    mp.setenv("SMP_WRITE_STEP_MEMORY_METRICS", "1")
    mp.setenv("SMP_STEP_MEMORY_METRICS_PATH", str(out / "mem.jsonl"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_qkv, "FORCE_INTERPRET", True)
        mp.setattr(pallas_gelu, "FORCE_INTERPRET", True)
        out_jax = _obs_env(mp, root, "jax")
        jax_smp.reset()
        jax_smp.init(dict(CFG))
        jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**TINY))
        jopt = jax_smp.DistributedOptimizer(optax.sgd(0.1), jmodel)

        @jax_smp.step
        def jax_step(model, batch):
            loss = jnp.mean(jax_vpce(model(batch)[:, :-1], batch[:, 1:]))
            model.backward(loss)
            return loss

        jax_losses, init = [], None
        for _ in range(STEPS):
            jax_losses.append(float(jax_step(jmodel, jnp.asarray(ids)).reduce_mean()))
            if init is None:  # still the initial weights: the update comes at jopt.step()
                init = lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jmodel.params)))
            jopt.step()
        jmodel(jnp.asarray(ids))  # an eager call: traced anew
        for _ in range(2):  # one generate program, traced once
            jax_smp.generate(jmodel, jnp.asarray(ids[:1, :8]), 4)
        jax_smp.shutdown()
        jax_smp.reset()

        mp.setattr(mb, "_is_cuda", lambda t: True)
        mp.setattr(bg, "_is_cuda", lambda t: True)
        out_port = _obs_env(mp, root, "port")
        smp_torch.reset()
        smp_torch.init(dict(CFG), device="cpu")
        module = port_tr.DistributedTransformerLMHead(**TINY)
        module.load_state_dict(init, strict=True)
        model = smp_torch.DistributedModel(module)
        opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

        @smp_torch.step
        def port_step(model, batch):
            loss = vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]).mean()
            model.backward(loss)
            return loss

        port_losses = []
        for _ in range(STEPS):
            port_losses.append(float(port_step(model, torch.from_numpy(ids).long()).reduce_mean()))
            opt.step()
        live = smp_torch.telemetry.report()
        model(torch.from_numpy(ids).long())
        for _ in range(2):
            smp_torch.generate(model, torch.from_numpy(ids[:1, :8]).long(), 4)
        smp_torch.shutdown()
    return {"jax": out_jax, "port": out_port, "live": live, "losses": (jax_losses, port_losses)}


def _dump(out):
    return json.loads((out / "telemetry.json").read_text())


def _series(doc, name):
    return {tuple(sorted(s["labels"].items())): s.get("value", s.get("count"))
            for s in doc["metrics"].get(name, {}).get("series", [])}


def test_e2e_same_families_and_label_keys(runs):
    jax_doc, port_doc = _dump(runs["jax"]), _dump(runs["port"])
    assert set(port_doc["metrics"]) == set(jax_doc["metrics"]) - set(XLA_ONLY)
    for name, fam in port_doc["metrics"].items():
        assert fam["kind"] == jax_doc["metrics"][name]["kind"], name
        keys = {tuple(sorted(s["labels"])) for s in fam["series"]}
        assert keys == {tuple(sorted(s["labels"])) for s in jax_doc["metrics"][name]["series"]}, name
    assert port_doc["meta"].keys() == jax_doc["meta"].keys()
    assert port_doc["meta"]["phase"] == jax_doc["meta"]["phase"] == "shutdown"


@pytest.mark.parametrize("name", EVENT_COUNTERS)
def test_e2e_event_counters_match_jax(runs, name):
    want = _series(_dump(runs["jax"]), name)
    assert want and _series(_dump(runs["port"]), name) == want
    np.testing.assert_allclose(runs["losses"][1], runs["losses"][0], rtol=0, atol=2e-5)


def test_e2e_histogram_counts_and_goodput(runs):
    jax_doc, port_doc = _dump(runs["jax"]), _dump(runs["port"])
    for name in ("smp_step_dispatch_seconds", "smp_step_time_seconds"):
        assert _series(port_doc, name) == _series(jax_doc, name) == {(): STEPS}
    secs = {k[0][1]: v for k, v in _series(port_doc, "smp_badput_seconds_total").items()}
    good = _series(port_doc, "smp_goodput_seconds_total")[()]
    assert good > 0 and set(secs) <= {"startup", "idle", "compile_fresh", "compile_cache"}
    assert 0 < _series(port_doc, "smp_goodput_fraction")[()] <= 1
    # The live report, before the shutdown dump, already carries the step families.
    assert runs["live"]["metrics"]["smp_step_total"]["series"][0]["value"] == STEPS


def test_e2e_flight_recorder_and_timeline(runs):
    def ring(out):
        lines = [json.loads(x) for x in (out / "ring.jsonl").read_text().splitlines()]
        return lines[0], [(e["kind"], e.get("event"), e.get("step")) for e in lines[1:] if e["kind"] == "step"]

    (jmeta, jsteps), (pmeta, psteps) = ring(runs["jax"]), ring(runs["port"])
    assert psteps == jsteps == [("step", ev, s) for s in range(STEPS) for ev in ("begin", "end")]
    assert pmeta.keys() == jmeta.keys()
    names = [e["name"] for e in json.loads((runs["port"] / "timeline.json").read_text())["traceEvents"]]
    assert names[0].startswith("smp_clock_anchor/")
    for n in range(STEPS):
        assert {f"step_{n}_begin", f"step_{n}_end", f"step_{n}"} <= set(names)
    assert "smp_phase/step/dispatch" in names and "smp_phase/optimizer/step" in names
    mem = [json.loads(x) for x in (runs["port"] / "mem.jsonl").read_text().splitlines()]
    assert [m["step"] for m in mem] == list(range(STEPS))


def _script(name, *args, with_jax=True, cwd=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if with_jax:
        env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, str(ROOT / "scripts" / name), *map(str, args)], cwd=cwd or ROOT,
                          env=env, capture_output=True, text=True, timeout=120)


def test_scripts_read_the_port_dumps(runs, tmp_path):
    out = runs["port"]
    with_pkg = _script("telemetry_report.py", out / "telemetry.json")
    without = _script("telemetry_report.py", out / "telemetry.json", with_jax=False, cwd=tmp_path)
    assert with_pkg.returncode == 0 and without.returncode == 0, with_pkg.stderr + without.stderr
    assert with_pkg.stdout == without.stdout, "\n".join(difflib.unified_diff(
        with_pkg.stdout.splitlines(), without.stdout.splitlines(), lineterm=""))
    assert "steps: 3" in with_pkg.stdout
    fused = _script("trace_fuse.py", "-o", tmp_path / "fused.json", out / "timeline.json", out / "ring.jsonl",
                    out / "telemetry.json")
    assert fused.returncode == 0, fused.stderr
    assert json.loads((tmp_path / "fused.json").read_text())["traceEvents"]
    ledger = _script("perf_ledger.py", "--repo", out)
    assert ledger.returncode == 0, ledger.stderr


# ----------------------------------------------------------------------
# What stays refused
# ----------------------------------------------------------------------


@pytest.mark.parametrize("env, value, what", [
    ("SMP_HEALTH_CHECK", "cheap", "the health sentinel"),
    ("SMP_CHAOS", "sigterm@step=3", "the chaos harness"),
    ("SMP_PREEMPTION_FILE", "/tmp/preempt", "preemption handling"),
    ("SMP_SUPERVISOR", "on", "the failure-recovery supervisor"),
    ("SMP_EXEC_CACHE", "on", "the executable cache"),
    ("SMP_HLO_AUDIT", "on", "the compiled-program audit"),
    ("SMP_SHAPE_BUCKETS", "seq:8", "shape buckets"),
])
def test_step_still_refuses_the_resilience_variables(monkeypatch, env, value, what):
    """The resilience variables of slice 9b (the first four) are honoured
    now; the rest still refuse with their messages."""
    smp_torch.init({}, device="cpu")
    monkeypatch.setenv(env, value)
    if env in ("SMP_HEALTH_CHECK", "SMP_CHAOS", "SMP_PREEMPTION_FILE", "SMP_SUPERVISOR"):
        port_step_mod._check_supported(port_state.cfg)
        return
    with pytest.raises(NotImplementedError, match=re.escape(f"@smp.step: {what} ({env}) is not ported")):
        port_step_mod._check_supported(port_state.cfg)


def test_step_honours_the_telemetry_path(monkeypatch, tmp_path):
    smp_torch.init({}, device="cpu")
    monkeypatch.setenv("SMP_TELEMETRY_PATH", str(tmp_path / "t.json"))
    port_step_mod._check_supported(port_state.cfg)
    assert "SMP_TELEMETRY_PATH" not in [e for e, _, _ in port_step_mod._LEFT_OUT_ENV]
