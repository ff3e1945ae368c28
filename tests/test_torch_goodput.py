"""The port's goodput ledger (``utils/goodput.py``) against the JAX package's,
and the port's goodput seams.

Under the JAX tests' ``FakeClock`` (``tests/test_goodput.py``), with fresh
registries: the same seeded walk of phases, scopes, stalls and compile notes
gives the same seconds, transitions, fractions, snapshots and published
metrics; ``classify_phase`` and ``goodput_enabled`` agree; the regression
sentinel fires and clears on the same windows; the forensics engine
captures and suppresses the same triggers. Then the port's own seams: a
kernel build (``ops/_build.load``) runs under the phase ``compile/<name>``
and lands in ``compile_fresh`` or, for a library already on disk,
``compile_cache``; a blocking checkpoint save and a resume land in
``ckpt_save`` / ``ckpt_restore``; a loader that runs dry lands in
``data_wait``; ``smp.init`` arms the ledger from ``SMP_GOODPUT`` and
``smp.shutdown`` publishes it.
"""

import json
import threading

import numpy as np
import pytest
import torch

from test_goodput import FakeClock
from smdistributed_modelparallel_tpu.utils import goodput as jax_gp
from smdistributed_modelparallel_tpu.utils import profiling as jax_prof
from smdistributed_modelparallel_tpu.utils import telemetry as jax_tel
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.ops import _build
from smdistributed_modelparallel_tpu_torch.utils import data as port_data
from smdistributed_modelparallel_tpu_torch.utils import goodput as port_gp
from smdistributed_modelparallel_tpu_torch.utils import profiling as port_prof
from smdistributed_modelparallel_tpu_torch.utils import telemetry as port_tel
from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder

ENVS = (port_gp.GOODPUT_ENV, port_gp.GOODPUT_MIN_ENV, port_gp.REGRESSION_RATIO_ENV, port_gp.FORENSICS_PATH_ENV)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for v in ENVS:
        monkeypatch.delenv(v, raising=False)
    yield
    smp_torch.reset()


def _ledgers(**kw):
    out = []
    for mod, tel in ((jax_gp, jax_tel), (port_gp, port_tel)):
        clk = FakeClock()
        kw2 = dict(kw)
        kw2.setdefault("min_goodput", 0)
        kw2.setdefault("regression_ratio", 0)
        out.append((mod.GoodputLedger(registry=tel.TelemetryRegistry(), clock=clk, wall=clk, **kw2), clk))
    return out


PHASES = ["step_1/trace", "step_1", "compile/flash_fwd", "barrier/x", "init/topology", "run/step",
          "initialized", "recv_from/3", "shutdown", "step_2", "something/else", ""]


def _walk(led, clk, seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        clk.t += float(rng.integers(1, 50)) / 10
        op = int(rng.integers(5))
        if op == 0:
            led.observe_phase(PHASES[rng.integers(len(PHASES))])
        elif op == 1:
            with led.scope(["ckpt_save", "ckpt_restore", "data_wait"][rng.integers(3)]):
                clk.t += float(rng.integers(1, 20)) / 10
                led.observe_phase(PHASES[rng.integers(len(PHASES))])
                clk.t += 0.5
        elif op == 2:
            led.note_compile(["disk_cache", "fresh"][rng.integers(2)], float(rng.integers(0, 30)) / 10)
        elif op == 3:
            led.mark_stalled("test")
        else:
            led.enter(["idle", "step"][rng.integers(2)])
    return {
        "seconds": led.seconds(), "wall": led.wall_seconds(), "fraction": led.goodput_fraction(),
        "transitions": led.transitions(), "state": led.state, "snapshot": led.snapshot(),
        "window": led.window_block(), "bench": led.bench_block(), "published": led.publish(),
        "metrics": led.registry.report()["metrics"],
    }


@pytest.mark.parametrize("seed", range(4))
def test_ledger_walk_matches_jax(seed):
    (jled, jclk), (pled, pclk) = _ledgers()
    want, got = _walk(jled, jclk, seed), _walk(pled, pclk, seed)
    assert got == want
    assert sum(got["seconds"].values()) == pytest.approx(got["wall"])
    assert set(got["seconds"]) <= set(port_gp.STATES)


@pytest.mark.parametrize("phase", PHASES + ["step_3/trace", "compile/serving_decode", "init/distributed", "startup"])
def test_classify_phase_matches_jax(phase):
    assert port_gp.classify_phase(phase) == jax_gp.classify_phase(phase)


def test_states_and_constants_match_jax():
    assert port_gp.STATES == jax_gp.STATES and port_gp.PRODUCTIVE == jax_gp.PRODUCTIVE
    assert (port_gp.DEFAULT_TICK_SECONDS, port_gp.DEFAULT_FORENSICS_COOLDOWN, port_gp.DEFAULT_FORENSICS_MAX,
            port_gp.DEFAULT_MIN_ELAPSED) == (jax_gp.DEFAULT_TICK_SECONDS, jax_gp.DEFAULT_FORENSICS_COOLDOWN,
                                             jax_gp.DEFAULT_FORENSICS_MAX, jax_gp.DEFAULT_MIN_ELAPSED)


@pytest.mark.parametrize("env", [{}, {"SMP_GOODPUT": "1"}, {"SMP_GOODPUT": "off"}, {"SMP_GOODPUT_MIN": "0.5"},
                                 {"SMP_REGRESSION_RATIO": "1.5"}, {"SMP_FORENSICS_PATH": "/x"}])
def test_goodput_enabled_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_gp.goodput_enabled() == jax_gp.goodput_enabled()
    assert (port_gp.GoodputLedger.from_env() is None) == (jax_gp.GoodputLedger.from_env() is None)


def _sentinel_run(mod, tel, seed):
    rng = np.random.default_rng(seed)
    reg = tel.TelemetryRegistry()
    sent = mod.RegressionSentinel(registry=reg, ratio=1.5, min_count=4)
    fired = []
    for w in range(10):
        slow = 3.0 if 5 <= w <= 6 else 1.0
        for _ in range(8):
            reg.histogram("smp_step_time_seconds", buckets=tel.LATENCY_BUCKETS).observe(
                slow * float(rng.uniform(0.09, 0.11)))
        fired.append([(v["source"], v.get("ratio")) for v in sent.check(wall=float(w))])
    return fired, {k: list(v) for k, v in sent.windows.items()}, sorted(sent.regressed), reg.report()["metrics"]


@pytest.mark.parametrize("seed", range(2))
def test_regression_sentinel_matches_jax(seed):
    want = _sentinel_run(jax_gp, jax_tel, seed)
    got = _sentinel_run(port_gp, port_tel, seed)
    assert got == want
    assert any(got[0])  # the slow windows fired once


def test_forensics_engine_matches_jax(tmp_path):
    outs = []
    for mod, tel, prof in ((jax_gp, jax_tel, jax_prof), (port_gp, port_tel, port_prof)):
        clk = FakeClock()
        reg = tel.TelemetryRegistry()
        eng = mod.ForensicsEngine(path=str(tmp_path / mod.__name__), registry=reg, cooldown=10.0, max_bundles=2,
                                  clock=clk, wall=clk)
        got = []
        for dt in (0.0, 5.0, 6.0, 1.0, 20.0):
            clk.t += dt
            got.append(eng.trigger("perf_regression", detail="x") is not None)
        doc = json.loads((tmp_path / mod.__name__ / "bundle_001_perf_regression" / "forensics.json").read_text())
        outs.append((got, reg.report()["metrics"]["smp_forensics_total"], sorted(doc)))
        prof.capture.reset()  # a capture bundle arms the profiler for the next step
    assert outs[1] == outs[0]
    assert outs[1][0] == [True, False, True, False, False]


def test_controller_arms_from_the_environment_and_chains_the_phase_listener(monkeypatch):
    smp_torch.init({}, device="cpu")
    assert smp_torch.goodput.ledger is None  # nothing constructed while off
    smp_torch.reset()
    monkeypatch.setenv("SMP_GOODPUT", "1")
    smp_torch.init({}, device="cpu")
    led = smp_torch.goodput.ledger
    assert led is not None
    smp_torch.telemetry.set_phase("step_0")
    assert led.state == "step"
    smp_torch.telemetry.set_phase("compile/flash_fwd")
    assert led.state == "compile_fresh"
    # The ring gets the phase, then the ledger's transition.
    assert [(e["kind"], e.get("phase", e.get("state"))) for e in flight_recorder.snapshot(last=2)] == [
        ("phase", "compile/flash_fwd"), ("goodput", "compile_fresh")]
    smp_torch.shutdown()
    assert smp_torch.goodput.ledger is None


# ----------------------------------------------------------------------
# The port's seams
# ----------------------------------------------------------------------


@pytest.fixture
def ledger(monkeypatch):
    monkeypatch.setenv("SMP_GOODPUT", "1")
    smp_torch.init({}, device="cpu")
    return smp_torch.goodput.ledger


@pytest.mark.parametrize("on_disk", [False, True])
def test_kernel_build_is_a_compile_phase(monkeypatch, ledger, on_disk):
    """``_build.load``: the build runs under ``compile/<name>``, the phase it
    interrupted comes back, and the seconds land in ``compile_fresh`` (nvcc
    ran) or ``compile_cache`` (the library was on disk)."""
    phases = []

    def start(name):
        phases.append(smp_torch.telemetry.phase)
        return (None if on_disk else object()), "lib.so"

    monkeypatch.setattr(_build, "start_build", start)
    monkeypatch.setattr(_build, "finish_build", lambda proc, out: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: "lib")
    monkeypatch.setitem(_build._LOADED, "fake_kernel", None)
    _build._LOADED.pop("fake_kernel")
    smp_torch.telemetry.set_phase("step_4")
    assert _build.load("fake_kernel") == "lib" and _build.load("fake_kernel") == "lib"
    _build._LOADED.pop("fake_kernel")
    assert phases == ["compile/fake_kernel"] and smp_torch.telemetry.phase == "step_4"
    ev = [e for e in flight_recorder.snapshot() if e["kind"] == "compile"][-1]
    assert (ev["event"], ev["name"]) == ("load" if on_disk else "nvcc", "fake_kernel")
    secs = ledger.seconds()
    assert ("compile_cache" in secs) == on_disk and "compile_fresh" in secs
    assert ledger.state == "step"


def test_checkpoint_save_and_resume_scopes(ledger, tmp_path):
    smp_torch.reset()
    smp_torch.init({}, device="cpu")
    led = smp_torch.goodput.ledger
    model = smp_torch.DistributedModel(TransformerLM(vocab_size=11, max_len=8, d_model=8, n_layers=1, n_heads=2),
                                       device="cpu")
    seen = []
    orig = led.scope

    def spy(state):
        seen.append(state)
        return orig(state)

    led.scope = spy
    smp_torch.save_checkpoint(str(tmp_path), tag="t", model=model)
    smp_torch.save_checkpoint(str(tmp_path), tag="u", model=model, blocking=False)
    smp_torch.wait_for_checkpoints()
    smp_torch.resume_from_checkpoint(str(tmp_path), tag="t")
    assert seen == ["ckpt_save", "ckpt_restore"]
    secs = led.seconds()
    assert secs.get("ckpt_save", 0) > 0 and secs.get("ckpt_restore", 0) > 0


def test_loader_that_runs_dry_is_data_wait(ledger):
    release = threading.Event()

    def batches():
        release.wait(5)
        yield torch.zeros(2, 3)

    it = port_data.prefetch_to_device(batches())
    threading.Timer(0.2, release.set).start()
    next(it)
    assert ledger.seconds().get("data_wait", 0) >= 0.1
