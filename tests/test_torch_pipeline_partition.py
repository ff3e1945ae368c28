"""The port's pipeline partitioner against the JAX package's.

``parallel/pipeline.partition_for_pipeline`` (with ``_choose_boundaries``
and the copied ``parallel/module_partition.py``) gives the JAX package's
boundaries and stage assignment for the same model and config: uniform
layers, fixed uneven costs (at two memory weights), five layers over two
stages, six over four, manual pins, ``auto_partition: False`` with
``default_partition``, a heterogeneous ``smp.nn`` stack timed through the
``_LAYER_TIMER`` hook, and a ``load_partition`` round trip through a file
either package wrote. Each ``PartitionError`` case raises in both packages.
The JAX side partitions the flax module's real parameters (its init on the
CPU); the port's runs on the torch module, at one rank with the pp config
installed past ``smp.init``'s device check.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import smdistributed_modelparallel_tpu as jax_smp
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu.models import transformer_lm as jax_lm
from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
from smdistributed_modelparallel_tpu.parallel import module_partition as jax_mp
from smdistributed_modelparallel_tpu.parallel import pipeline as jax_pl
from smdistributed_modelparallel_tpu.parallel import partition as jax_part
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.models import transformer_lm as port_lm
from smdistributed_modelparallel_tpu_torch.module_manager import ModuleManager
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.parallel import module_partition as port_mp
from smdistributed_modelparallel_tpu_torch.parallel import partition as port_part
from smdistributed_modelparallel_tpu_torch.parallel import pipeline as port_pl

TYPES = ("local", "local", "local", "global")


def _lm_kw(layers):
    return dict(vocab_size=32, max_len=12, d_model=16, n_layers=layers, n_heads=2)


def _head_kw(types):
    return dict(num_layers=len(types), num_attention_heads=2, attention_head_size=8, hidden_size=16,
                intermediate_size=32, vocab_size=64, num_positions=16, causal_mask_size=16, window_size=4,
                attention_layers_type=types, pre_layernorm=True, post_layernorm=False, final_layernorm=True,
                attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0)


class PortUneven(port_lm.TransformerLM):
    def pipeline_spec(self):
        spec = super().pipeline_spec()
        spec.layer_costs = [5.0] + [1.0] * (spec.num_layers - 1)
        return spec


def _jax_module(kind, arg):
    if kind == "head":
        return jax_tr.DistributedTransformerLMHead(**_head_kw(arg))
    module = jax_lm.TransformerLM(**_lm_kw(arg))
    if kind == "uneven":
        from tests.test_partition_wiring import UnevenLM

        module = UnevenLM(**_lm_kw(arg))
    return module


def _port_module(kind, arg):
    if kind == "head":
        return port_tr.DistributedTransformerLMHead(**_head_kw(arg))
    return (PortUneven if kind == "uneven" else port_lm.TransformerLM)(**_lm_kw(arg))


def _timer(sig, fn, args):
    """Local layers measure 5x cheaper than global ones."""
    return 0.2 if True in sig or 1 in sig else 1.0


def jax_partition(kind, arg, cfg, pins=None, load=False):
    """(boundaries, assignment) of the JAX package, or the error's class name."""
    try:
        jax_smp.reset()
        jax_smp.init({"microbatches": 4, "ddp": True, "_device_count_override": cfg["pipeline_parallel_degree"],
                      **cfg})
        module = _jax_module(kind, arg)
        model = jax_smp.DistributedModel(module)
        for prefix, stage in (pins or {}).items():
            jax_smp.set_partition(prefix, stage)
        T = 16 if kind == "head" else 12
        model._params = module.init({"params": jax.random.key(0)}, jnp.zeros((2, T), jnp.int32))["params"]
        old, jax_pl._LAYER_TIMER = jax_pl._LAYER_TIMER, _timer
        try:
            assignment = jax_part._maybe_load_partition(model) if load else None
            if assignment is None:
                assignment = jax_pl.partition_for_pipeline(model)
                jax_part._maybe_save_partition(assignment)
        finally:
            jax_pl._LAYER_TIMER = old
        return [tuple(b) for b in model._pipeline_spec.boundaries], assignment
    except Exception as e:  # the class is compared
        return type(e).__name__
    finally:
        jax_smp.reset()
        jax_smp.init({})


def port_partition(monkeypatch, kind, arg, cfg, pins=None):
    """(boundaries, assignment) of the port, or the error's class name."""
    smp.init({}, device="cpu")
    monkeypatch.setattr(state, "cfg", smp.ModelParallelConfig({"microbatches": 4, "ddp": True, **cfg}))
    manager = ModuleManager()
    for prefix, stage in (pins or {}).items():
        manager.set_partition(prefix, stage)
    model = SimpleNamespace(module=_port_module(kind, arg), module_manager=manager, _pipeline_spec=None)
    monkeypatch.setattr(port_pl, "_LAYER_TIMER", _timer)
    try:
        assignment = port_part.maybe_auto_partition(model)
    except Exception as e:  # the class is compared
        return type(e).__name__
    assert manager.stage_of(next(iter(assignment))) == assignment[next(iter(assignment))]
    return [tuple(b) for b in model._pipeline_spec.boundaries], assignment


PP2 = {"pipeline_parallel_degree": 2}
CASES = {
    "uniform": ("lm", 4, PP2, None),
    "uneven_costs": ("uneven", 4, PP2, None),
    "uneven_costs_mw0": ("uneven", 4, dict(PP2, memory_weight=0.0), None),
    "five_layers": ("lm", 5, PP2, None),
    "six_over_four": ("lm", 6, {"pipeline_parallel_degree": 4}, None),
    "pins": ("lm", 4, PP2, {"layers/block#1": 1}),
    "pins_pp4": ("lm", 6, {"pipeline_parallel_degree": 4}, {"layers/block#0": 0, "layers/block#2": 2}),
    "manual": ("lm", 4, dict(PP2, auto_partition=False, default_partition=0),
               {"layers/block#2": 1, "layers/block#3": 1}),
    "measured": ("head", TYPES, dict(PP2, memory_weight=0.0), None),
    "measured_skipped": ("head", TYPES, dict(PP2, memory_weight=0.0, skip_tracing=True), None),
    # PartitionError in both packages:
    "too_few_layers": ("lm", 2, {"pipeline_parallel_degree": 4}, None),
    "malformed_pin": ("lm", 4, PP2, {"layers/block#x": 1}),
    "pin_out_of_range": ("lm", 4, PP2, {"layers/block#9": 1}),
    "empty_stage": ("lm", 4, dict(PP2, auto_partition=False, default_partition=0), None),
    "non_contiguous": ("lm", 4, dict(PP2, auto_partition=False, default_partition=1), {"layers/block#3": 0}),
}
ERRORS = {"too_few_layers", "malformed_pin", "pin_out_of_range", "empty_stage", "non_contiguous"}


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_partition(*args) for name, args in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_partition_matches_jax(jax_results, monkeypatch, name):
    want = jax_results[name]
    got = port_partition(monkeypatch, *CASES[name])
    if name in ERRORS:
        assert want == got == "PartitionError"
    else:
        assert got == want


def test_measured_boundaries(jax_results):
    """The heterogeneous stack: three local layers (timed 0.2) on stage 0,
    the global one (1.0) alone on stage 1; skipped timing stays even."""
    assert jax_results["measured"][0] == [(0, 3), (3, 4)]
    assert jax_results["measured_skipped"][0] == [(0, 2), (2, 4)]


def test_load_partition_round_trip(monkeypatch, tmp_path):
    """The port writes ``partition_file``; the port and the JAX package load
    it back (``load_partition``) to the same assignment; a file for another
    degree or layer count raises in both."""
    path = str(tmp_path / "partition.json")
    pins = {"layers/block#0": 0, "layers/block#1": 1}
    saved = port_partition(monkeypatch, "lm", 4, dict(PP2, partition_file=path), pins)
    assert saved[0] == [(0, 1), (1, 4)]
    cfg = dict(PP2, partition_file=path, load_partition=True)
    assert port_partition(monkeypatch, "lm", 4, cfg) == saved
    assert jax_partition("lm", 4, cfg, load=True) == saved
    for kind, layers, bad in (("lm", 5, cfg), ("lm", 6, dict(cfg, pipeline_parallel_degree=4))):
        assert port_partition(monkeypatch, kind, layers, bad) == "PartitionError"
        assert jax_partition(kind, layers, bad, load=True) == "PartitionError"
    missing = dict(cfg, partition_file=str(tmp_path / "absent.json"))
    assert port_partition(monkeypatch, "lm", 4, missing) == jax_partition("lm", 4, missing, load=True) \
        == "PartitionError"


@pytest.mark.parametrize("costs,k,pins", [
    ([1.0, 1.0, 1.0, 1.0], 2, {1: 1}),
    ([5.0, 1.0, 1.0, 1.0, 2.0, 3.0], 3, {0: 0, 5: 2}),
    ([0.1, 0.4, 0.2, 0.3], 4, {2: 2}),
    ([1.0, 2.0, 3.0], 2, {0: 1, 2: 0}),
])
def test_min_max_segments_pinned_matches_jax(costs, k, pins):
    def run(mod):
        try:
            return mod.min_max_segments_pinned(costs, k, pins)
        except Exception as e:  # the class is compared
            return type(e).__name__

    assert run(port_mp) == run(jax_mp)


def test_module_partition_is_the_ports_own():
    """The copy imports nothing of the JAX package."""
    import inspect

    src = inspect.getsource(port_mp)
    assert "smdistributed_modelparallel_tpu." not in src and "jax" not in src.replace("JAX package", "")
    np.testing.assert_array_equal(port_mp.uniform_layer_boundaries([1.0] * 6, 3),
                                  jax_mp.uniform_layer_boundaries([1.0] * 6, 3))


def test_real_measurement_runs_without_hook(monkeypatch):
    """No hook: each distinct layer variant is timed on the module's device
    (the wall clock here; CUDA events on a card)."""
    smp.init({}, device="cpu")
    monkeypatch.setattr(state, "cfg", smp.ModelParallelConfig({"microbatches": 4, "ddp": True, **PP2}))
    module = _port_module("head", TYPES)
    times = port_pl._measured_layer_times(SimpleNamespace(module=module), module.pipeline_spec())
    assert len(times) == 4 and all(t > 0 for t in times) and times[0] == times[1] == times[2]
