"""The port's health monitor (``utils/health.py``) against the JAX package's.

One scenario runs in both packages (a module-scoped fixture: one JAX run),
on a tiny ``smp.nn`` LM (2 layers, 64 wide, 2 microbatches, SGD, fp32) from
the same weights (``convert.lm_head_params_from_jax``) and a step whose loss
weighs the tokens by a float input ``w``:

- 3 steps under ``SMP_HEALTH_CHECK=cheap``, then 3 under ``full``: equal
  ``checked_steps`` and pending steps, tags, ``bad`` and microbatch columns,
  abs-max columns within 1e-6 relative, the ``record_health_*`` series and
  the ``record_update_stats`` gauges (recorded at the first optimizer step,
  the 16-step cadence's first; 1e-5 relative: two summation orders);
- three trips under cheap, each from the clean weights: a NaN input row in
  microbatch 1 (``input:``), a poisoned final LayerNorm scale then every live
  parameter poisoned before the decode (the bisector must use the
  dispatch-time parameters: the JAX package's ``TestBisectionParams``
  case), and a NaN in layer 1's MLP kernel (the layer stack's scanned
  output): equal attribution dicts and equal dump contents (times masked,
  floats within 1e-6 relative).
Beside it: the mode parsing, the OOM post-mortem (the JAX dump's keys, the
error re-raised unchanged by the step), the refusals that stay and the
variables that no longer refuse, and the metric names the new modules emit
against README's "Metrics registry".
"""

import importlib
import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.utils import health as jax_health
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.backend.state import state as port_state
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.utils import health as port_health

port_step_mod = importlib.import_module("smdistributed_modelparallel_tpu_torch.step")  # smp.step is the decorator
ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(num_layers=2, num_attention_heads=4, attention_head_size=16, hidden_size=64, intermediate_size=128,
            vocab_size=96, num_positions=32, causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
            final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0)
STEPS = 3
REL = 1e-6
HEALTH_SERIES = ("smp_health_checks_total", "smp_health_last_checked_step", "smp_health_bad_count",
                 "smp_health_absmax", "smp_health_first_microbatch", "smp_health_trips_total",
                 "smp_health_last_trip_step", "smp_health_fault_total")
UPDATE_SERIES = ("smp_grad_norm", "smp_param_norm", "smp_update_norm", "smp_update_ratio")


def _series(report, names):
    out = {}
    for name in names:
        for s in report["metrics"].get(name, {}).get("series", []):
            out[(name, tuple(sorted(s["labels"].items())))] = s.get("value")
    return out


def _close(a, b, rel=REL, path="<root>"):
    """Equal structures; floats within ``rel`` relative (NaN equals NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, rel, f"{path}/{i}")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)), (path, a, b)
        if math.isnan(a):
            assert math.isnan(b), (path, a, b)
        else:
            assert b == pytest.approx(a, rel=rel, abs=1e-30), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _masked_dump(path):
    doc = json.loads(pathlib.Path(path).read_text())
    for trip in doc["trips"]:
        trip["time"] = None
    return doc


def _data():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32)
    w = np.ones((4, 15), np.float32)
    w_bad = w.copy()
    w_bad[2, 3] = np.nan  # rows 2-3: microbatch 1 of 2
    return ids, w, w_bad


class _Jax:
    """The scenario's moves in the JAX package."""

    def __init__(self):
        jax_smp.reset()
        jax_smp.init({"microbatches": 2})
        self.model = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**TINY))
        self.opt = jax_smp.DistributedOptimizer(optax.sgd(0.1), self.model)

        @jax_smp.step
        def train(model, batch, w):
            loss = jnp.mean(jax_vpce(model(batch)[:, :-1], batch[:, 1:]) * w)
            model.backward(loss)
            return loss

        self.train = train
        self.health, self.telemetry = jax_health, jax_smp.telemetry

    def step(self, ids, w):
        return float(self.train(self.model, jnp.asarray(ids), jnp.asarray(w)).reduce_mean())

    def params(self):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(self.model.params))

    def set_params(self, params):
        self.model.params = jax.tree_util.tree_map(jnp.asarray, params)

    def poison(self, case):
        p = self.params()
        if case == "ln_f":
            p["ln_f"]["scale"] = np.full_like(p["ln_f"]["scale"], np.nan)
        else:
            k = p["transformer"]["seq_layers"]["layer"]["output"]["fc/kernel"].copy()
            k[1, 0, 0] = np.nan
            p["transformer"]["seq_layers"]["layer"]["output"]["fc/kernel"] = k
        self.set_params(p)

    def poison_live(self):
        self.model.params = jax.tree_util.tree_map(lambda x: jnp.full_like(x, jnp.nan), self.model.params)


class _Port:
    """The same moves in the port."""

    def __init__(self, init):
        smp_torch.reset()
        smp_torch.init({"microbatches": 2}, device="cpu")
        module = port_tr.DistributedTransformerLMHead(**TINY)
        module.load_state_dict(init, strict=True)
        self.model = smp_torch.DistributedModel(module)
        self.opt = smp_torch.DistributedOptimizer(torch.optim.SGD(self.model.parameters(), lr=0.1), self.model)

        @smp_torch.step
        def train(model, batch, w):
            loss = (vocab_parallel_cross_entropy(model(batch)[:, :-1], batch[:, 1:]) * w).mean()
            model.backward(loss)
            return loss

        self.train = train
        self.health, self.telemetry = port_health, smp_torch.telemetry

    def step(self, ids, w):
        return float(self.train(self.model, torch.from_numpy(ids).long(), torch.from_numpy(w)).reduce_mean())

    def params(self):
        return {k: v.clone() for k, v in self.model.state_dict().items()}

    def set_params(self, params):
        self.model.load_state_dict({k: v.clone() for k, v in params.items()})

    def poison(self, case):
        with torch.no_grad():
            if case == "ln_f":
                self.model.module.ln_f.weight.fill_(float("nan"))
            else:
                self.model.module.transformer.seq_layers[1].output.fc.weight[0, 0] = float("nan")

    def poison_live(self):
        with torch.no_grad():
            for p in self.model.module.parameters():
                p.fill_(float("nan"))


def _scenario(pkg, mp, tmp, tag):
    ids, w, w_bad = _data()
    out = {"losses": []}
    mp.setenv("SMP_HEALTH_CHECK", "cheap")
    for n in range(STEPS):
        out["losses"].append(pkg.step(ids, w))
        if n == 0:  # still the initial weights (the JAX package initializes at the first step)
            out["init"] = pkg.params()
        pkg.opt.step()
    mon = pkg.health.monitor
    out["cheap"] = dict(checked=list(mon.checked_steps), pending=mon.pending_step, last=mon.last_check,
                        series=_series(pkg.telemetry.report(), HEALTH_SERIES + UPDATE_SERIES))
    mon.flush()
    mp.setenv("SMP_HEALTH_CHECK", "full")
    for _ in range(STEPS):
        out["losses"].append(pkg.step(ids, w))
        pkg.opt.step()
    out["full"] = dict(checked=list(mon.checked_steps), pending=mon.pending_step, last=mon.last_check,
                       series=_series(pkg.telemetry.report(), HEALTH_SERIES))
    mp.setenv("SMP_HEALTH_CHECK", "cheap")
    clean = pkg.params()
    out["trips"] = {}
    for case in ("input", "ln_f", "layer1"):
        mon.reset()
        pkg.telemetry.reset()
        pkg.set_params(clean)
        path = tmp / f"{tag}_{case}.json"
        mp.setenv("SMP_HEALTH_PATH", str(path))
        if case == "input":
            pkg.step(ids, w_bad)
        else:
            pkg.poison(case)
            pkg.step(ids, w)
        if case == "ln_f":
            pkg.poison_live()  # the update lands before the decode
        mon.flush()
        out["trips"][case] = dict(attribution=mon.trips[-1]["attribution"], dump=_masked_dump(path),
                                  series=_series(pkg.telemetry.report(), HEALTH_SERIES))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("health")
    with pytest.MonkeyPatch.context() as mp:
        jax_out = _scenario(_Jax(), mp, tmp, "jax")
        jax_smp.reset()
        port_out = _scenario(_Port(lm_head_params_from_jax(jax_out["init"])), mp, tmp, "port")
        smp_torch.reset()
    return jax_out, port_out


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp_torch.reset()


def test_losses_match(runs):
    np.testing.assert_allclose(runs[1]["losses"], runs[0]["losses"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", ["cheap", "full"])
def test_sentinel_words_match_jax(runs, mode):
    want, got = runs[0][mode], runs[1][mode]
    assert got["checked"] == want["checked"]
    assert got["pending"] == want["pending"]
    if mode == "cheap":
        assert got["checked"] == list(range(STEPS - 1)) and got["pending"] == STEPS - 1
    else:
        assert got["checked"][-STEPS:] == list(range(STEPS, 2 * STEPS)) and got["pending"] is None
    _close(want["last"], got["last"])
    tags = set(got["last"]["tags"])
    assert tags == ({"loss", "outputs", "grads", "params"} if mode == "full" else {"loss", "outputs", "grads"})
    assert all(d["bad"] == 0 and d["microbatch"] == -1 for d in got["last"]["tags"].values())
    health = {k: v for k, v in want["series"].items() if k[0] in HEALTH_SERIES}
    _close(health, {k: v for k, v in got["series"].items() if k[0] in HEALTH_SERIES})


def test_update_stats_match_jax(runs):
    want = {k: v for k, v in runs[0]["cheap"]["series"].items() if k[0] in UPDATE_SERIES}
    got = {k: v for k, v in runs[1]["cheap"]["series"].items() if k[0] in UPDATE_SERIES}
    assert {k[0] for k in want} == set(UPDATE_SERIES)
    _close(want, got, rel=1e-5)


@pytest.mark.parametrize("case", ["input", "ln_f", "layer1"])
def test_trip_attribution_and_dump_match_jax(runs, case):
    want, got = runs[0]["trips"][case], runs[1]["trips"][case]
    assert got["attribution"] == want["attribution"]
    expected = {"input": ("input:0/2", 1), "ln_f": ("ln_f/__call__/0", 0),
                "layer1": ("transformer/seq_layers/__call__/0/0/0", 0)}[case]
    assert (got["attribution"]["layer"], got["attribution"]["microbatch"]) == expected
    assert got["attribution"]["params_source"] == "dispatch"
    _close(want["dump"], got["dump"])
    _close(want["series"], got["series"])


def test_mode_parsing_matches_jax(monkeypatch):
    for raw in ("", "off", "0", "cheap", "1", "on", "full", "bogus", " FULL "):
        monkeypatch.setenv("SMP_HEALTH_CHECK", raw)
        assert port_health.mode() == jax_health.mode(), raw
    assert port_health.tag("x", 3) == 3 and port_health.active() is None


def test_oom_postmortem_has_the_jax_keys_and_the_step_reraises(monkeypatch, tmp_path):
    jax_smp.reset()
    jax_smp.init({"microbatches": 2})
    monkeypatch.setenv("SMP_HEALTH_PATH", str(tmp_path / "jax.json"))
    jax_health.oom_postmortem("step", None, RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    want = json.loads((tmp_path / "jax.json").read_text())
    jax_smp.reset()

    smp_torch.init({"microbatches": 2}, device="cpu")
    model = smp_torch.DistributedModel(torch.nn.Linear(4, 4))
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    @smp_torch.step
    def boom(model, x):
        raise err

    monkeypatch.setenv("SMP_HEALTH_PATH", str(tmp_path / "port.json"))
    with pytest.raises(torch.OutOfMemoryError) as caught:
        boom(model, torch.zeros(2, 4))
    assert caught.value is err
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want) and got["kind"] == "oom_postmortem" and got["name"] == "step"
    assert got["memory_analysis"] is None and set(got["live_buffers"]) == set(want["live_buffers"])
    # checkpoint_configs: written where a module manager exists (the port's
    # DistributedModel makes one; this JAX session built no model).
    assert set(got["memory_config"]) - {"checkpoint_configs"} == set(want["memory_config"])
    assert got["memory_config"]["checkpoint_configs"] == []
    assert got["memory_config"]["microbatches"] == 2
    assert port_health.is_resource_exhausted(err) and not port_health.is_resource_exhausted(ValueError("shape"))
    oom = _series(smp_torch.telemetry.report(), ("smp_oom_total",))
    assert oom == {("smp_oom_total", (("step", "step"),)): 1.0}


@pytest.mark.parametrize("env, value", [("SMP_HEALTH_CHECK", "cheap"), ("SMP_CHAOS", "sigterm@step=3"),
                                        ("SMP_PREEMPTION_FILE", "/nonexistent/preempt"), ("SMP_SUPERVISOR", "on")])
def test_lifted_variables_no_longer_refuse(monkeypatch, env, value):
    smp_torch.init({}, device="cpu")
    monkeypatch.setenv(env, value)
    port_step_mod._check_supported(port_state.cfg)
    assert env not in [e for e, _, _ in port_step_mod._LEFT_OUT_ENV]


@pytest.mark.parametrize("env, value, what", [("SMP_SHAPE_BUCKETS", "seq:8", "shape buckets"),
                                              ("SMP_EXEC_CACHE", "on", "the executable cache"),
                                              ("SMP_HLO_AUDIT", "on", "the compiled-program audit")])
def test_remaining_variables_refuse_with_their_messages(monkeypatch, env, value, what):
    smp_torch.init({}, device="cpu")
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match=re.escape(f"@smp.step: {what} ({env}) is not ported to PyTorch")):
        port_step_mod._check_supported(port_state.cfg)


def test_metric_names_are_in_the_readme_registry():
    readme = (ROOT / "README.md").read_text()
    registry = readme[readme.index("### Metrics registry"):]
    names = set()
    for rel in ("utils/health.py", "utils/fleet.py", "resilience/chaos.py", "resilience/preemption.py",
                "resilience/supervisor.py", "utils/telemetry.py"):
        src = (ROOT / "smdistributed_modelparallel_tpu_torch" / rel).read_text()
        names |= set(re.findall(r"\.(?:counter|gauge|histogram)\(\s*\"(smp_[a-z0-9_]+)\"", src))
    new = {n for n in names if re.match(r"smp_(health|oom|chaos|preemption|failures|recover|grad_norm|param_norm"
                                        r"|update_|fleet)", n)}
    assert len(new) >= 20
    missing = sorted(n for n in new if f"`{n}`" not in registry)
    assert not missing, missing
