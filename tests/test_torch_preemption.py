"""The port's preemption listener (``resilience/preemption.py``) against the
JAX package's.

Each behaviour runs in both packages and must come out the same (modeled on
``tests/test_resilience.py``'s ``TestPreemption``): the sentinel file
triggers; a SIGTERM under the listener ``smp.init`` installed is deferred,
not fatal; an emergency save commits (``.committed``, ``newest``), records
``requested``/``rendezvous``/``saved`` in the ring and
``smp_preemption_total``, and is one-shot; a skewed rendezvous defers to
the agreed edge; a second SIGTERM terminates (a child process each);
``smp.shutdown`` uninstalls the handler; the commit wait is bounded by the
remaining ``SMP_PREEMPTION_GRACE_SECONDS``.

End to end (one JAX run, in a module-scoped fixture): the tiny ``smp.nn`` LM
(AdamW, fp32) trains with ``SMP_CHAOS=sigterm@step=3`` in both packages from
the same weights; each writes a partial emergency checkpoint at step edge 3
(the third call's update not applied yet). A fresh port session resumes its
own checkpoint to the uninterrupted run's losses of calls 3-5, bit for bit;
a port session resumes the JAX package's checkpoint, and the JAX session
resumes the port's, each to the same losses within 2e-5 (two frameworks'
fp32 arithmetic, as ``tests/test_torch_nn_transformer.py`` holds them).
"""

import importlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import lm_head_params_from_jax
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": "smdistributed_modelparallel_tpu", "port": "smdistributed_modelparallel_tpu_torch"}
TINY = dict(num_layers=2, num_attention_heads=2, attention_head_size=8, hidden_size=16, intermediate_size=32,
            vocab_size=64, num_positions=32, causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
            final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0)
LR = 1e-3
CALLS = 5  # the uninterrupted run; the preempted run saves at its third call's edge


def _mods(pkg):
    return (importlib.import_module(PKGS[pkg]),
            importlib.import_module(PKGS[pkg] + ".resilience.preemption").preemption,
            importlib.import_module(PKGS[pkg] + ".backend.state").state)


def _init(pkg):
    smp, listener, st = _mods(pkg)
    smp.shutdown()
    smp.reset()
    smp.init({"microbatches": 1}, **({"device": "cpu"} if pkg == "port" else {}))
    listener.reset()
    return smp, listener, st


def _default_sigterm():
    """Both packages' listeners uninstalled and SIGTERM at its default
    disposition; returns the handler that was there. (Other test files
    leave a listener's handler behind when they reset the two packages in
    the order they initialized them: a stale handler this file's in-process
    SIGTERMs must not reach.)"""
    for pkg in PKGS:
        smp, listener, _ = _mods(pkg)
        smp.shutdown()
        smp.reset()
        listener.reset()
    return signal.signal(signal.SIGTERM, signal.SIG_DFL)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("SMP_CHAOS", "SMP_PREEMPTION_FILE", "SMP_EMERGENCY_CKPT_PATH", "SMP_PREEMPTION_GRACE_SECONDS"):
        monkeypatch.delenv(var, raising=False)
    before = _default_sigterm()
    yield
    _default_sigterm()
    signal.signal(signal.SIGTERM, before)


def _metric(smp, name, **labels):
    for s in smp.telemetry.report()["metrics"].get(name, {}).get("series", []):
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s["value"]
    return 0.0


def _both(fn):
    out = {}
    for pkg in PKGS:
        out[pkg] = fn(pkg)
        _mods(pkg)[0].shutdown()
    assert out["port"] == out["jax"], out
    return out["port"]


def test_sentinel_file_triggers(tmp_path, monkeypatch):
    def run(pkg):
        _, listener, _ = _init(pkg)
        sentinel = tmp_path / f"preempt_{pkg}"
        monkeypatch.setenv("SMP_PREEMPTION_FILE", str(sentinel))
        before = listener.check()
        sentinel.touch()
        return before, listener.check(), listener.requested

    assert _both(run) == (None, "sentinel_file", True)


def test_sigterm_is_deferred_not_fatal():
    def run(pkg):
        _, listener, _ = _init(pkg)
        installed = listener._installed and signal.getsignal(signal.SIGTERM) == listener._on_sigterm
        os.kill(os.getpid(), signal.SIGTERM)  # survived: the flag flipped instead
        return installed, listener.check()

    assert _both(run) == (True, "sigterm")


def test_emergency_save_commits_and_records(tmp_path, monkeypatch):
    def run(pkg):
        smp, listener, st = _init(pkg)
        listener.exit_after_save = False
        root = tmp_path / pkg
        monkeypatch.setenv("SMP_EMERGENCY_CKPT_PATH", str(root))
        st.step_count = 7
        listener.trigger("test")
        path, tag = listener.maybe_emergency_save()
        events = [e["event"] for e in smp.flight_recorder.snapshot() if e["kind"] == "preempt"]
        return (os.path.relpath(path, tmp_path).replace(pkg, "<pkg>"), tag,
                (root / f"{tag}_partial" / ".committed").exists(), (root / "newest").read_text(),
                events[-3:], _metric(smp, "smp_preemption_total", event="saved"),
                listener.maybe_emergency_save())

    got = _both(run)
    assert got == ("<pkg>", "preempt_step_7", True, "preempt_step_7", ["requested", "rendezvous", "saved"], 1.0,
                   None)


def test_rendezvous_skew_defers_to_max_step(tmp_path, monkeypatch):
    def run(pkg):
        smp, listener, st = _init(pkg)
        listener.exit_after_save = False
        monkeypatch.setenv("SMP_EMERGENCY_CKPT_PATH", str(tmp_path / pkg))
        monkeypatch.setattr(listener, "_world_size", lambda: 2)
        monkeypatch.setattr(listener, "_bus_rendezvous", lambda deadline: [st.step_count, st.step_count + 1])
        st.step_count = 3
        listener.trigger("test")
        out = [listener.maybe_emergency_save(), listener._save_at_step,
               [e["event"] for e in smp.flight_recorder.snapshot() if e["kind"] == "preempt"][-1],
               listener.maybe_emergency_save(), listener.emergency_saved]
        st.step_count = 4
        saved = listener.maybe_emergency_save()
        out += [saved[1], (tmp_path / pkg / f"{saved[1]}_partial" / ".committed").exists(),
                listener.maybe_emergency_save()]
        monkeypatch.undo()
        return out

    assert _both(run) == [None, 4, "deferred", None, None, "preempt_step_4", True, None]


def test_install_never_chains_to_itself():
    """A listener whose own handler is still installed (another handler's
    uninstall restored it) does not chain to it: one SIGTERM is deferred,
    not re-raised forever, and the uninstall gives back the default."""
    _, listener, _ = _mods("port")
    signal.signal(signal.SIGTERM, listener._on_sigterm)
    assert listener.install() and listener._prev_sigterm is None
    os.kill(os.getpid(), signal.SIGTERM)
    assert listener.check() == "sigterm"
    listener.uninstall()
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_second_sigterm_terminates(pkg):
    code = (
        "import os, signal, time\n"
        f"from {PKGS[pkg]}.resilience.preemption import preemption\n"
        "preemption.install()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "assert preemption.check() == 'sigterm'\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(5)\n"
        "raise SystemExit(99)  # unreachable: the second TERM killed the process\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == -signal.SIGTERM, (r.returncode, r.stderr.decode(errors="replace")[-800:])


def test_shutdown_uninstalls_sigterm_handler():
    def run(pkg):
        smp, listener, _ = _init(pkg)
        on = (listener._installed, signal.getsignal(signal.SIGTERM) == listener._on_sigterm)
        smp.shutdown()
        return on, (listener._installed, signal.getsignal(signal.SIGTERM) == listener._on_sigterm)

    assert _both(run) == ((True, True), (False, False))


def test_grace_seconds_bounds_commit_timeout(tmp_path, monkeypatch):
    def run(pkg):
        _, listener, _ = _init(pkg)
        listener.exit_after_save = False
        monkeypatch.setenv("SMP_PREEMPTION_GRACE_SECONDS", "7")
        ckpt = importlib.import_module(PKGS[pkg] + ".checkpoint")
        seen = {}
        orig = ckpt.save_checkpoint

        def spy(*a, **k):
            seen["timeout"] = os.environ.get("SMP_CKPT_COMMIT_TIMEOUT")
            return orig(*a, **k)

        monkeypatch.setattr(ckpt, "save_checkpoint", spy)
        listener.trigger("test")
        listener.emergency_save(path=str(tmp_path / pkg), reason="test")
        monkeypatch.undo()
        return 5.0 <= float(seen["timeout"]) <= 7.0, os.environ.get("SMP_CKPT_COMMIT_TIMEOUT")

    assert _both(run) == (True, None)


# ----------------------------------------------------------------------
# End to end: the tiny LM preempted at step 3 in both packages
# ----------------------------------------------------------------------


def _ids():
    return np.random.default_rng(0).integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32)


def _port_session(init=None):
    smp_torch.shutdown()
    smp_torch.reset()
    smp_torch.init({"microbatches": 1}, device="cpu")
    module = port_tr.DistributedTransformerLMHead(**TINY)
    if init is not None:
        module.load_state_dict(init, strict=True)
    model = smp_torch.DistributedModel(module)
    opt = smp_torch.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8), model)

    @smp_torch.step
    def train(model, ids):
        loss = vocab_parallel_cross_entropy(model(ids)[:, :-1], ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    ids = torch.from_numpy(_ids()).long()

    def call():
        loss = float(train(model, ids).reduce_mean())
        opt.step()
        return loss

    return call


def _preempted(call, listener, monkeypatch, root):
    """Calls under ``sigterm@step=3`` until the emergency save: the losses
    of the calls that returned before it and the checkpoint's tag."""
    monkeypatch.setenv("SMP_CHAOS", "sigterm@step=3")
    monkeypatch.setenv("SMP_EMERGENCY_CKPT_PATH", str(root))
    listener.reset()
    listener.exit_after_save = False
    losses = []
    while listener.emergency_saved is None:
        losses.append(call())
    monkeypatch.delenv("SMP_CHAOS")
    return losses, listener.emergency_saved[1]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preempt")
    before = _default_sigterm()
    port_listener = _mods("port")[1]
    jax_listener = _mods("jax")[1]
    with pytest.MonkeyPatch.context() as mp:
        # The JAX run: init (at its first call), preempted at step edge 3.
        jax_smp.shutdown()
        jax_smp.reset()
        jax_smp.init({"microbatches": 1})
        jax_listener.reset()
        jmodel = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**TINY))
        jopt = jax_smp.DistributedOptimizer(optax.adamw(LR), jmodel)

        @jax_smp.step
        def jtrain(model, ids):
            loss = jnp.mean(jax_vpce(model(ids)[:, :-1], ids[:, 1:]))
            model.backward(loss)
            return loss

        init = {}

        def jcall():
            loss = float(jtrain(jmodel, jnp.asarray(_ids())).reduce_mean())
            if not init:
                init.update(lm_head_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                           jax.device_get(jmodel.params))))
            jopt.step()
            return loss

        jax_losses, jax_tag = _preempted(jcall, jax_listener, mp, tmp / "jax")
        # Its handler would see the port's SIGTERM as a second one (the
        # port's listener chains to the handler it replaced): hand TERM back.
        jax_listener.reset()
        jax_listener.uninstall()

        # The port: uninterrupted, preempted, and resumed from each checkpoint.
        call = _port_session(init)
        uninterrupted = [call() for _ in range(CALLS)]
        port_losses, port_tag = _preempted(_port_session(init), port_listener, mp, tmp / "port")
        resumed = {}
        for src in ("port", "jax"):
            call = _port_session()
            user = smp_torch.resume_from_checkpoint(str(tmp / src))
            resumed[src] = (user, smp_torch.state.step_count, [call() for _ in range(CALLS - 2)])

        # The JAX session resumes the port's checkpoint in place.
        jax_smp.resume_from_checkpoint(str(tmp / "port"))
        jax_resumed = [jcall() for _ in range(CALLS - 2)]
        jax_smp.shutdown()
        jax_smp.reset()
        smp_torch.shutdown()
        smp_torch.reset()
    signal.signal(signal.SIGTERM, before)
    return dict(tmp=tmp, jax_losses=jax_losses, jax_tag=jax_tag, uninterrupted=uninterrupted,
                port_losses=port_losses, port_tag=port_tag, resumed=resumed, jax_resumed=jax_resumed)


def test_e2e_both_packages_write_the_emergency_checkpoint(e2e):
    assert e2e["port_tag"] == e2e["jax_tag"] == "preempt_step_3"
    for src in ("port", "jax"):
        root = e2e["tmp"] / src
        assert (root / "newest").read_text() == "preempt_step_3"
        assert (root / "preempt_step_3_partial" / ".committed").exists()
        probe = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "resilience_probe.py"), str(root)],
                               capture_output=True, text=True, timeout=120)
        assert probe.returncode == 0, probe.stdout
    # The save ran at the third call's edge (exit_after_save False here, so
    # the call returned), before its update: three losses, then the save.
    assert e2e["port_losses"] == e2e["uninterrupted"][:3]
    np.testing.assert_allclose(e2e["jax_losses"], e2e["uninterrupted"][:3], rtol=0, atol=2e-5)


def test_e2e_port_resumes_its_own_checkpoint_bit_for_bit(e2e):
    user, step_count, losses = e2e["resumed"]["port"]
    assert user == {"preemption_reason": "sigterm", "step_count": 3} and step_count == 3
    assert losses == e2e["uninterrupted"][2:]


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_e2e_checkpoints_cross_packages(e2e, direction):
    if direction == "port_reads_jax":
        user, step_count, losses = e2e["resumed"]["jax"]
        assert user == {"preemption_reason": "sigterm", "step_count": 3} and step_count == 3
    else:
        losses = e2e["jax_resumed"]
    np.testing.assert_allclose(losses, e2e["uninterrupted"][2:], rtol=0, atol=2e-5)
