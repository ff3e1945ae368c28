"""The port's profiling (``utils/profiling.py``) against the JAX package's, and
its ``torch.profiler`` capture and FLOP count.

- ``roofline()``: the same explicit FLOPs, bytes, peaks, bubble and step
  time give the same ``RooflineReport.as_dict()`` and the same published
  gauges; ``should_sample_step`` and the ``SMP_PROFILE`` window parser
  agree.
- ``device_peaks``: the H100 SXM row by the lower-cased device name, None
  for a variant the row does not match and for the CPU, the env overrides.
- ``lm_step_flops`` against ``torch.utils.flop_counter.FlopCounterMode`` over
  a real ``@smp.step`` of the tiny ``smp.nn`` LM and of the zoo LM on the
  CPU (every product of the forward and the backward): within 2%.
- The capture: ``SMP_PROFILE=steps=1:2`` runs ``torch.profiler`` around
  exactly steps 1-2 of a CPU run and writes a Chrome trace that holds the
  ``smp_phase/*`` regions of those two steps and no others; ``SIGUSR2``'s
  in-process twin arms a one-step window; the capture counters are the
  JAX package's.
- ``StepBreakdown`` writes the bench schema, as the JAX package's does.
"""

import io
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from smdistributed_modelparallel_tpu.utils import profiling as jax_prof
from smdistributed_modelparallel_tpu.utils import telemetry as jax_tel
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn import transformer as port_tr
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.utils import profiling as port_prof
from smdistributed_modelparallel_tpu_torch.utils import telemetry as port_tel

TINY = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8,
    hidden_size=32, intermediate_size=64, vocab_size=96, num_positions=32,
    causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0,
    hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for v in ("SMP_PROFILE", "SMP_PROFILE_PATH", "SMP_PEAK_TFLOPS", "SMP_PEAK_GBPS"):
        monkeypatch.delenv(v, raising=False)
    jax_tel.telemetry.reset()
    port_tel.telemetry.reset()
    yield
    smp_torch.reset()
    jax_tel.telemetry.reset()
    jax_prof.capture.reset()


ROOFLINE_CASES = {
    "compute_bound": dict(step_time_s=0.5, flops=4e14, bytes_accessed=1e11, peak_flops=989e12, peak_bytes_per_s=3.35e12),
    "memory_bound": dict(step_time_s=0.02, flops=1e12, bytes_accessed=5e10, peak_flops=989e12,
                         peak_bytes_per_s=3.35e12, bubble_fraction=0.25),
    "no_bytes": dict(step_time_s=0.3, flops=2e14, peak_flops=989e12, peak_bytes_per_s=3.35e12),
    "no_peaks": dict(step_time_s=0.3, flops=2e14, bytes_accessed=1e9, peak_flops=None, peak_bytes_per_s=None),
    "no_flops": dict(step_time_s=0.3, bytes_accessed=1e9, peak_flops=1e12, peak_bytes_per_s=1e9),
    "zero_time": dict(step_time_s=0.0, flops=1e12, peak_flops=1e12, peak_bytes_per_s=1e9),
}


@pytest.mark.parametrize("case", sorted(ROOFLINE_CASES))
def test_roofline_matches_jax(case, monkeypatch):
    kw = ROOFLINE_CASES[case]
    if kw["peak_flops"] is None:
        # An unknown device: both packages' spec tables give None.
        monkeypatch.setattr(jax_prof, "_device_kind", lambda d: "")
        monkeypatch.setattr(port_prof, "_device_kind", lambda d: "")
    want = jax_prof.roofline("step", **kw)
    got = port_prof.roofline("step", **kw)
    assert got.as_dict() == want.as_dict()
    assert port_tel.telemetry.report()["metrics"] == jax_tel.telemetry.report()["metrics"]


def test_record_step_roofline_skips_a_missing_count():
    assert port_prof.record_step_roofline("step", 0.1, None) is None
    assert port_prof.record_step_roofline("step", 0.0, 1e9) is None
    rep = port_prof.record_step_roofline("step", 0.5, 1e12)
    assert rep.flops == 1e12 and rep.bytes_accessed is None and rep.step_time_s == 0.5


def test_should_sample_step_matches_jax():
    assert [port_prof.should_sample_step(s) for s in range(50)] == [jax_prof.should_sample_step(s) for s in range(50)]
    assert [s for s in range(40) if port_prof.should_sample_step(s)] == [1, 17, 33]


@pytest.mark.parametrize("spec", ["steps=3:5", "steps=4", "2:9", " steps=0:0 ", "steps=5:3", "steps=", "a:b",
                                  "1:2:3", "-1:2"])
def test_profile_spec_parser_matches_jax(spec):
    try:
        want = jax_prof._parse_profile_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20].replace("(", r"\(")):
            port_prof._parse_profile_spec(spec)
    else:
        assert port_prof._parse_profile_spec(spec) == want


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3350e9)),
    ("NVIDIA H100 PCIe", (None, None)),
    ("NVIDIA H100 NVL", (None, None)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
])
def test_device_peaks_by_device_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert port_prof.device_peaks() == want
    assert port_prof.device_peaks("cuda:0") == want
    assert port_prof.device_peaks("cpu") == (None, None)


def test_device_peaks_overrides_match_jax(monkeypatch):
    assert port_prof.device_peaks() == (None, None)  # this CPU host: unknown, never a guess
    monkeypatch.setenv("SMP_PEAK_TFLOPS", "100")
    monkeypatch.setenv("SMP_PEAK_GBPS", "2000")
    assert port_prof.device_peaks() == jax_prof.device_peaks() == (100e12, 2000e9)
    monkeypatch.setenv("SMP_PEAK_GBPS", "fast")
    assert port_prof.device_peaks()[1] is None


# ----------------------------------------------------------------------
# The FLOP count against torch's own counter
# ----------------------------------------------------------------------


def _counted_step(module, ids):
    smp_torch.init({"microbatches": 1}, device="cpu")
    model = smp_torch.DistributedModel(module, device="cpu")

    @smp_torch.step
    def train(model, ids):
        logits = model(ids)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    with FlopCounterMode(display=False) as counter:
        train(model, ids)
    return counter.get_total_flops()


@pytest.mark.parametrize("B, T", [(2, 16), (1, 32)])
def test_lm_step_flops_against_the_flop_counter(B, T):
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (B, T)))
    module = port_tr.DistributedTransformerLMHead(**TINY)
    counted = _counted_step(module, ids)
    want = port_prof.lm_step_flops(module, B, T)
    assert want == pytest.approx(counted, rel=0.02)
    assert port_prof.lm_step_flops(module, B, T, backward=False) == want / 3
    smp_torch.reset()
    zoo = TransformerLM(vocab_size=96, max_len=32, d_model=32, n_layers=2, n_heads=4)
    assert port_prof.lm_step_flops(zoo, B, T) == pytest.approx(_counted_step(zoo, ids), rel=0.02)


def test_lm_step_flops_is_none_where_it_does_not_apply():
    assert port_prof.lm_step_flops(torch.nn.Linear(3, 3), 2, 4) is None
    moe = port_tr.DistributedTransformerLMHead(**dict(TINY, num_experts=2), device="meta")
    assert port_prof.lm_step_flops(moe, 2, 4) is None


# ----------------------------------------------------------------------
# The capture
# ----------------------------------------------------------------------


def _train(steps, **env):
    smp_torch.init({"microbatches": 2}, device="cpu")
    module = TransformerLM(vocab_size=64, max_len=16, d_model=16, n_layers=1, n_heads=2)
    model = smp_torch.DistributedModel(module, device="cpu")
    opt = smp_torch.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1), model)

    @smp_torch.step
    def train(model, ids):
        loss = model(ids, targets=ids).mean()
        model.backward(loss)
        return loss

    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 16)))
    for _ in range(steps):
        train(model, ids)
        opt.step()


def _regions(path):
    events = json.loads(open(path).read())["traceEvents"]
    return [e["name"] for e in events if e.get("name", "").startswith("smp_phase/")]


def test_profile_window_captures_exactly_those_steps(monkeypatch, tmp_path):
    monkeypatch.setenv("SMP_PROFILE", "steps=1:2")
    monkeypatch.setenv("SMP_PROFILE_PATH", str(tmp_path))
    _train(4)
    cap = port_prof.capture
    assert cap.last_window == (1, 2) and not cap.active
    assert cap.last_trace == str(tmp_path / "rank0" / "steps_1_2.pt.trace.json")
    names = _regions(cap.last_trace)
    # Steps 1 and 2, and the optimizer step between them (the window closes
    # at step 2's end, before its optimizer step).
    assert names.count("smp_phase/step/dispatch") == 2 and names.count("smp_phase/optimizer/step") == 1
    assert names.count("smp_phase/step/fetch") == 1  # step 1 is a sampled step
    m = smp_torch.telemetry.report()["metrics"]
    assert m["smp_profile_captures_total"]["series"][0]["value"] == 1
    assert m["smp_profile_last_first_step"]["series"][0]["value"] == 1
    assert m["smp_profile_last_last_step"]["series"][0]["value"] == 2
    assert m["smp_profile_active"]["series"][0]["value"] == 0
    assert m["smp_profile_overhead_seconds_total"]["series"][0]["value"] > 0


def test_request_capture_arms_one_step(monkeypatch, tmp_path):
    monkeypatch.setenv("SMP_PROFILE_PATH", str(tmp_path / "base"))
    port_prof.capture.reset()
    port_prof.capture.request_capture(path=str(tmp_path / "forensic"))
    _train(2)
    assert port_prof.capture.last_window == (0, 0)
    assert _regions(tmp_path / "forensic" / "rank0" / "steps_0_0.pt.trace.json").count(
        "smp_phase/step/dispatch") == 1


def test_disarmed_capture_and_regions_cost_nothing(monkeypatch):
    _train(2)
    assert port_prof.capture.last_window is None and port_prof.capture.last_trace is None
    assert "smp_profile_captures_total" not in smp_torch.telemetry.report()["metrics"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port_prof.region("serve/decode_step"), port_prof.named_region("smp/optimizer/update"):
            torch.ones(2) + 1
    names = {e.key for e in prof.key_averages()}
    assert {"smp_phase/serve/decode_step", "smp/optimizer/update"} <= names


def test_step_breakdown_matches_jax():
    streams = []
    for mod in (jax_prof, port_prof):
        bd = mod.StepBreakdown(context={"cell": "x"})
        bd.record("fwd", 0.0125, iters=3)
        bd.record("bwd", 0.03)
        buf = io.StringIO()
        bd.emit(buf)
        streams.append((buf.getvalue(), bd.rows))
    assert streams[1] == streams[0]
    out, dt = port_prof.StepBreakdown().time("add", lambda a: a + 1, torch.ones(3), iters=2)
    assert dt > 0 and out.tolist() == [2.0, 2.0, 2.0]
    assert port_tel.telemetry.report()["metrics"]["smp_breakdown_ms"]["series"][-1]["labels"] == {"component": "add"}
