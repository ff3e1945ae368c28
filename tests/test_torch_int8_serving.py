"""int8 serving in the port (``SMP_DECODE_WEIGHTS=int8``, ``SMP_KV_QUANT=int8``)
against the JAX package's.

- ``quant.quantize_decode_params`` gives the JAX package's int8 leaves and
  scales bit for bit, leaf for leaf, on the ``smp.nn`` head and the zoo (the
  JAX layers are stacked on a layer axis, so their biases and LayerNorm
  vectors quantize too, one scale a channel over every layer);
  ``fake_quant_decode_params`` gives the JAX generate program's values;
- ``smp.generate`` under int8 weights gives the JAX package's tokens;
- ``kv_quantize_append`` and ``kv_dequantize_gather`` equal the JAX
  functions compiled as the JAX engine compiles them, bit for bit;
- the serving engine under both knobs gives the JAX engine's tokens,
  ``stats`` and ``kv_block_bytes``, and pools and scales within 1e-5 of
  their largest value (fp32; the packages sum the K/V products in other
  orders); its greedy streams equal ``smp.generate`` under int8 weights, as
  the JAX package's ``TestDecodeWeightsInt8`` holds; ``adopt_params``
  quantizes the new weights into the resident int8 tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smdistributed_modelparallel_tpu as smp_jax
from smdistributed_modelparallel_tpu import quant as jax_quant
from smdistributed_modelparallel_tpu.serving import ServeRequest as JaxServeRequest
from smdistributed_modelparallel_tpu.serving import ServingEngine as JaxServingEngine
import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch import quant
from smdistributed_modelparallel_tpu_torch.convert import kv_pools_from_jax, kv_pools_to_jax
from smdistributed_modelparallel_tpu_torch.serving import ServeRequest, ServingEngine

from test_torch_generate_beams import zoo_pair
from test_torch_generate_nn import HEAD, head_pair, jax_generate, port_generate, prompts

TIGHT = dict(max_slots=3, num_blocks=13, block_tokens_override=4, prefill_chunk=4)
REQUESTS = [("q0", 40, 7, 6, {}), ("q1", 41, 11, 4, {}), ("q2", 42, 3, 8, {}),
            ("s0", 43, 6, 7, dict(temperature=0.9, top_k=20, seed=3))]


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _flat(tree, prefix=""):
    if not hasattr(tree, "items"):
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def models():
    return {"nn": head_pair(HEAD, seed=8), "zoo": zoo_pair(seed=9)}


@pytest.mark.parametrize("name", ["nn", "zoo"])
def test_quantize_decode_params_equal_jax(models, name):
    jmod, params, tmod = models[name]
    want = {part: _flat(tree) for part, tree in jax_quant.quantize_decode_params(params).items()}
    got = quant.quantize_decode_params(tmod.state_dict(), tmod)
    for part in ("q", "s"):
        assert set(got[part]) == set(want[part])
        for key, w in want[part].items():
            g = got[part][key].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=f"{part}/{key}")
    # The stacked layer biases and LayerNorm vectors are int8 too, as in JAX.
    ln = [k for k in got["q"] if k.startswith(("transformer/seq_layers/layer/", "layers/block/"))
          and k.endswith(("/bias", "/scale"))]
    assert ln and all(got["q"][k].dtype == torch.int8 for k in ln)
    # Dequantize: the JAX package's values, back in the port's names.
    deq = quant.dequantize_decode_params(got, tmod)
    assert deq.keys() == tmod.state_dict().keys()
    want_deq = _flat(jax_quant.dequantize_decode_params(jax_quant.quantize_decode_params(params)))
    deq_jax = quant._jax_layout(tmod)[0](deq)
    for key, w in want_deq.items():
        np.testing.assert_array_equal(deq_jax[key].numpy(), w, err_msg=key)
    # fake-quant as the JAX generate program computes it (jitted).
    fq = quant.fake_quant_decode_params(tmod.state_dict(), tmod)
    want_fq = _flat(jax.jit(jax_quant.fake_quant_decode_params)(params))
    fq_jax = quant._jax_layout(tmod)[0](fq)
    for key, w in want_fq.items():
        np.testing.assert_array_equal(fq_jax[key].numpy(), w, err_msg=key)


@pytest.mark.parametrize("name", ["nn", "zoo"])
def test_generate_int8_weights_equal_jax(models, name, monkeypatch):
    jmod, params, tmod = models[name]
    ids = prompts(length=7, seed=12)
    monkeypatch.setenv("SMP_DECODE_WEIGHTS", "int8")
    want = jax_generate(jmod, params, ids, 6)
    got = port_generate(tmod, ids, 6)
    np.testing.assert_array_equal(got, want)
    # The decode copy ran on the int8 grid, not on the weights themselves.
    fq = smp_torch.generation._decode_params(tmod, None)
    assert any(not torch.equal(fq[k], v) for k, v in tmod.state_dict().items())


@pytest.mark.parametrize("case", ["fresh", "grown", "duplicates"])
def test_kv_quantize_append_and_gather_equal_jax(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    nb, bt, H, hd, N = 6, 4, 3, 8, 5
    pool = rng.integers(-127, 128, (nb, bt, H, hd)).astype(np.int8)
    scale = np.zeros((nb, H), np.float32) if case == "fresh" else (rng.random((nb, H)) * 0.05).astype(np.float32)
    k = (rng.standard_normal((N, H, hd)) * (3.0 if case == "grown" else 1.0)).astype(np.float32)
    blk = rng.integers(0, nb, N).astype(np.int32)
    if case == "duplicates":
        blk[:] = [2, 2, 2, 0, 0]
    want = jax.jit(jax_quant.kv_quantize_append)(pool, scale, k, blk)
    got = quant.kv_quantize_append(torch.from_numpy(pool), torch.from_numpy(scale), torch.from_numpy(k),
                                   torch.from_numpy(blk))
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 or g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slots = rng.integers(0, nb * bt, (2, 7)).astype(np.int32)
    vals = pool.reshape(nb * bt, H, hd)[slots]
    want = jax.jit(jax_quant.kv_dequantize_gather, static_argnums=3)(vals, np.asarray(want[1]), slots // bt,
                                                                     jnp.float32)
    got = quant.kv_dequantize_gather(torch.from_numpy(vals), got[1], torch.from_numpy(slots // bt), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knobs_validate_like_jax(monkeypatch):
    for v in ("", "0", "none", "off", "bf16", "int8", "fp4"):
        for env, fn, jfn in (("SMP_KV_QUANT", quant.kv_quant_mode, jax_quant.kv_quant_mode),
                             ("SMP_DECODE_WEIGHTS", quant.decode_weights_mode, jax_quant.decode_weights_mode)):
            monkeypatch.setenv(env, v)
            if v == "fp4":
                with pytest.raises(ValueError):
                    jfn()
                with pytest.raises(ValueError, match=env):
                    fn()
            else:
                assert fn() == jfn()
    monkeypatch.setenv("SMP_KV_QUANT", "int8")
    monkeypatch.setenv("SMP_DECODE_WEIGHTS", "int8")
    assert quant.serving_key_suffix() == jax_quant.serving_key_suffix()


def _requests(make):
    return [make(rid, [int(t) for t in np.random.default_rng(seed).integers(0, 97, n)], m, **kw)
            for rid, seed, n, m, kw in REQUESTS]


@pytest.fixture(scope="module")
def int8_engines(models):
    """Both engines under both knobs, from the same zoo weights."""
    jmod, params, tmod = models["zoo"]
    mp = pytest.MonkeyPatch()
    mp.setenv("SMP_DECODE_WEIGHTS", "int8")
    mp.setenv("SMP_KV_QUANT", "int8")
    try:
        smp_torch.init({}, device="cpu")
        port = ServingEngine(tmod, params=tmod.state_dict(), device="cpu", **TIGHT)
        port.run(_requests(ServeRequest), timeout_s=300)
        gen = {rid: list(port_generate(tmod, np.asarray([port.mirror_log[rid]["prompt"]]), m)[0, n:])
               for rid, _, n, m, kw in REQUESTS if not kw}
        smp_torch.reset()
        smp_jax.init({})
        ref = JaxServingEngine(jmod, params=params, **TIGHT)
        ref.run(_requests(JaxServeRequest), timeout_s=300)
        smp_jax.reset()
    finally:
        mp.undo()
    return dict(port=port, gen=gen, jax_results=dict(ref.results), jax_stats=dict(ref.stats),
                jax_cache=jax.tree_util.tree_map(np.asarray, ref._cache), jax_block_bytes=ref.kv_block_bytes)


def test_engine_tokens_and_stats_equal_jax(int8_engines):
    port = int8_engines["port"]
    assert set(port.results) == set(int8_engines["jax_results"])
    for rid, want in int8_engines["jax_results"].items():
        assert port.results[rid] == [int(t) for t in want], rid
    assert dict(port.stats) == int8_engines["jax_stats"]
    # Greedy streams equal smp.generate under int8 weights (the int8 KV
    # rounding moves no token here), as the JAX package holds.
    for rid, want in int8_engines["gen"].items():
        assert port.results[rid] == [int(t) for t in want], rid


def test_engine_pools_and_scales_match_jax(int8_engines):
    port = int8_engines["port"]
    # int8 K and V (1 byte each) and their fp32 scales a head, 2 layers.
    assert port.kv_block_bytes == int8_engines["jax_block_bytes"] == 2 * 2 * (4 * 4 * 8 + 4 * 4)
    want = int8_engines["jax_cache"]["layers"]["block"]["attn"]
    got = kv_pools_to_jax(port.kv_pools())["layers"]["block"]["attn"]
    assert set(got) == set(want) == {"pool_key", "pool_value", "scale_key", "scale_value"}
    for kind in ("key", "value"):
        w8, g8 = want[f"pool_{kind}"], got[f"pool_{kind}"]
        ws, gs = want[f"scale_{kind}"], got[f"scale_{kind}"]
        assert g8.dtype == w8.dtype == np.int8 and g8.shape == w8.shape == (2, 13, 4, 4, 8)
        assert gs.dtype == ws.dtype == np.float32 and gs.shape == ws.shape == (2, 13, 4)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5 * ws.max())
        wd, gd = w8 * ws[:, :, None, :, None], g8 * gs[:, :, None, :, None]
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5 * np.abs(wd).max())
    # The conversion carries the scales both ways, bit for bit.
    back = kv_pools_to_jax(kv_pools_from_jax(int8_engines["jax_cache"]))["layers"]["block"]["attn"]
    for leaf, w in want.items():
        np.testing.assert_array_equal(back[leaf], w)


def test_adopt_params_under_int8(models, monkeypatch):
    monkeypatch.setenv("SMP_DECODE_WEIGHTS", "int8")
    _, _, tmod = models["zoo"]
    _, _, other = zoo_pair(seed=10)
    smp_torch.init({}, device="cpu")
    engine = ServingEngine(tmod, params=tmod.state_dict(), device="cpu", **TIGHT)
    req = [ServeRequest("x", [5, 6, 7, 8, 9], 5)]
    before = engine.run(req)["x"]
    model_before = {k: v.clone() for k, v in tmod.state_dict().items()}
    ptrs = [t.data_ptr() for t in engine._flat(engine.qparams).values()]
    engine.adopt_params(other.state_dict())
    assert [t.data_ptr() for t in engine._flat(engine.qparams).values()] == ptrs
    assert engine.qparams["q"]["wte/embedding"].dtype == torch.int8
    after = engine.run([ServeRequest("y", [5, 6, 7, 8, 9], 5)])["y"]
    fresh = ServingEngine(other, params=other.state_dict(), device="cpu", **TIGHT)
    assert after == fresh.run([ServeRequest("y", [5, 6, 7, 8, 9], 5)])["y"] and after != before
    # The caller's model is untouched: the resident tree owns its tensors.
    assert all(torch.equal(v, model_before[k]) for k, v in tmod.state_dict().items())
    bad = dict(other.state_dict(), **{"wte.weight": other.state_dict()["wte.weight"][:, :16]})
    with pytest.raises(Exception, match="avals"):
        engine.adopt_params(bad)
