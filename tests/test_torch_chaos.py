"""The port's chaos harness (``resilience/chaos.py``) against the JAX
package's: ``parse_spec`` over the JAX tests' specs (malformed and
non-numeric rules included) gives the same rules; every seam, driven by the
same calls under the same spec, fires at the same calls with the same
return values, signals (``os.kill`` patched) and ``smp_chaos_injected_total``
counts; and the step and the serving engine reach their seams (a SIGTERM
rule at step 2 lands in the preemption listener, a ``wedge`` rule stalls
the step's dispatch, ``corrupt_weights`` perturbs an ``adopt_params``)."""

import importlib
import os
import signal
import time

import numpy as np
import pytest
import torch

from smdistributed_modelparallel_tpu.utils import telemetry as jax_tel
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.resilience.preemption import preemption
from smdistributed_modelparallel_tpu_torch.utils import telemetry as port_tel

# The packages' resilience/__init__ binds ``chaos`` to the injector: the
# modules themselves by name.
jax_chaos_mod = importlib.import_module("smdistributed_modelparallel_tpu.resilience.chaos")
port_chaos_mod = importlib.import_module("smdistributed_modelparallel_tpu_torch.resilience.chaos")

SPECS = [
    "sigterm@step=3:rank=0, bus_drop@seq=5:dest=1,delay_collective@group=pp:ms=200:count=2",
    "bogus@x=1,sigterm@step,sigterm@step=2",
    "sigterm@step=three,bus_drop@seq=x,delay_collective@group=pp:ms=fast,sigterm@step=4",
    "kill@step=2:rank=7,wedge@step=1:ms=5,heartbeat_drop@rank=0:count=2,bus_error@seq=1",
    "kill_replica@request=2,kill_replica@scale=1,corrupt_weights@version=3:rank=0",
    "sigterm@step=3:rank=x", "", " , ,", "wedge@", "sigterm@step=1:=2",
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SMP_CHAOS", raising=False)
    for mod in (jax_chaos_mod, port_chaos_mod):
        mod.chaos.reset()
    yield
    for mod in (jax_chaos_mod, port_chaos_mod):
        mod.chaos.reset()
    smp_torch.reset()
    jax_tel.telemetry.reset()
    port_tel.telemetry.reset()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    want = [(r.fault, r.kv, r.fired) for r in jax_chaos_mod.parse_spec(spec)]
    got = [(r.fault, r.kv, r.fired) for r in port_chaos_mod.parse_spec(spec)]
    assert got == want


def _injected(tel):
    fam = tel.telemetry.report()["metrics"].get("smp_chaos_injected_total", {"series": []})
    return {s["labels"]["fault"]: s["value"] for s in fam["series"]}


def _drive(mod, tel, monkeypatch, spec):
    """Every seam, called in one fixed sequence under ``spec``: what each
    call returned or did, and the injection counts."""
    kills, sleeps = [], []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(int(sig)))
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(round(s, 6)))
    monkeypatch.setenv("SMP_CHAOS", spec)
    c = mod.chaos
    c.reset()
    trace = []
    progress = {1: (0, False), 2: (3, False), 3: (5, True)}
    for step in range(5):
        c.on_step_dispatch(step)
        c.on_step_edge(step)
        trace.append(("step", step, list(kills), list(sleeps)))
    for n in range(4):
        c.on_serve_decode(progress.get)
        c.on_scale_event(n)
        trace.append(("serve", n, list(kills)))
    params = {"w": np.arange(4, dtype=np.float32), "ids": np.arange(3)}
    for version in range(4):
        out = c.on_weight_update(version, params)
        trace.append(("weights", version, out is params, {k: np.asarray(v).tolist() for k, v in out.items()}))
    for dest in range(3):
        trace.append(("beat", dest, c.on_heartbeat(dest)))
    for _ in range(4):
        trace.append(("send", c.on_bus_send(1), c.on_bus_send(0)))
    for group in ("PP_GROUP", "WORLD", "pp", "TP"):
        c.on_collective("barrier", group)
        trace.append(("collective", group, list(sleeps)))
    trace.append(("rules", [(r.fault, r.fired) for r in c.rules], c.enabled))
    return trace, _injected(tel)


@pytest.mark.parametrize("spec", [
    "sigterm@step=3,kill@step=2:rank=0,wedge@step=1:ms=5,wedge@step=4:ms=0",
    "kill_replica@request=2,kill_replica@request=3,kill_replica@scale=2",
    "corrupt_weights@version=2,corrupt_weights@version=1:rank=3",
    "heartbeat_drop@count=2,bus_drop@seq=1:dest=0,bus_error@seq=3,bus_drop@seq=5:dest=1",
    "delay_collective@group=pp:ms=30:count=1,delay_collective@ms=10,delay_collective@group=tp:ms=0",
    "sigterm@step=three:rank=x,bus_drop@seq=x",
])
def test_seams_fire_as_jax(monkeypatch, spec):
    want = _drive(jax_chaos_mod, jax_tel, monkeypatch, spec)
    got = _drive(port_chaos_mod, port_tel, monkeypatch, spec)
    assert got == want


def test_disarmed_seams_are_noops(monkeypatch):
    c = port_chaos_mod.chaos
    assert not c.enabled and c.rules == []
    assert c.on_bus_send(0) is None and c.on_heartbeat(0) is False
    params = {"w": torch.ones(2)}
    assert c.on_weight_update(1, params) is params
    c.on_step_edge(3)
    c.on_step_dispatch(3)


def test_sigterm_rule_lands_in_the_preemption_listener(monkeypatch):
    """In-process, as the JAX package's test: smp.init installs the
    listener, so the injected SIGTERM flips its flag instead of killing.
    SIGTERM starts at its default disposition (another file's test may have
    left a listener's handler behind) and is given back after."""
    import smdistributed_modelparallel_tpu as jax_smp

    smp_torch.reset()
    jax_smp.reset()
    before = signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        _sigterm_rule(monkeypatch)
    finally:
        smp_torch.reset()
        signal.signal(signal.SIGTERM, before)


def _sigterm_rule(monkeypatch):
    smp_torch.init({"microbatches": 1}, device="cpu")
    assert preemption._installed
    preemption.reset()
    monkeypatch.setenv("SMP_CHAOS", "sigterm@step=2")
    port_chaos_mod.chaos.reset()
    port_chaos_mod.chaos.on_step_edge(1)
    assert preemption.check() is None
    port_chaos_mod.chaos.on_step_edge(2)
    assert preemption.check() == "sigterm"
    preemption.reset()
    port_chaos_mod.chaos.on_step_edge(2)  # one-shot
    assert preemption.check() is None
    assert signal.getsignal(signal.SIGTERM) == preemption._on_sigterm
    smp_torch.shutdown()
    assert signal.getsignal(signal.SIGTERM) != preemption._on_sigterm


def test_step_wedges_inside_its_dispatch_and_the_engine_corrupts_weights(monkeypatch, tmp_path):
    from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
    from smdistributed_modelparallel_tpu_torch.serving import ServeRequest, ServingEngine

    smp_torch.init({"microbatches": 1}, device="cpu")
    model = smp_torch.DistributedModel(torch.nn.Linear(3, 3))

    @smp_torch.step
    def train(model, x):
        loss = model(x).pow(2).mean()
        model.backward(loss)
        return loss

    monkeypatch.setenv("SMP_CHAOS", "wedge@step=1:ms=200")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        train(model, torch.ones(2, 3))
        times.append(time.perf_counter() - t0)
    assert times[1] >= 0.2 > max(times[0], times[2])
    assert _injected(port_tel) == {"wedge": 1.0}

    smp_torch.reset()
    smp_torch.init({}, device="cpu")
    lm = smp_torch.DistributedModel(TransformerLM(vocab_size=17, max_len=16, d_model=8, n_layers=1, n_heads=2))
    engine = ServingEngine(lm, max_slots=2, num_blocks=9, block_tokens_override=4, prefill_chunk=4, device="cpu")
    engine.run([ServeRequest("a", [1, 2, 3], 3)])
    sd = {k: v.clone() for k, v in lm.module.state_dict().items()}
    monkeypatch.setenv("SMP_CHAOS", "corrupt_weights@version=1")
    engine.adopt_params(sd, version=1)
    for k, v in engine.decode_mod.state_dict().items():
        want = sd[k] * 1.01 + 0.01 if sd[k].is_floating_point() else sd[k]
        torch.testing.assert_close(v, want.to(v.dtype), rtol=0, atol=0)
    assert _injected(port_tel)["corrupt_weights"] == 1.0
