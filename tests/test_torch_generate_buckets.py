"""Decode-length buckets (``SMP_SHAPE_BUCKETS`` "seq" sizes) in the port's
``smp.generate`` against the JAX package's.

The four cases of the JAX package's ``TestDecodeLengthBuckets``
(``tests/test_generate.py``), each greedy and sampled under a key, through
both packages on the same weights (JAX init, converted) and numpy prompts,
fp32 on the CPU, held token for token: ragged prompts of the ``smp.nn`` head
(prompt and decode length bucketed; the prompt left-padded), the zoo family
(decode length only: it takes no mask), EOS-frozen rows with a decode
length past every bucket, and buckets that would pass the position limit.
Greedy output is the unbucketed output; sampling draws from the bucketed
key schedule (``split(rng, bucketed max_new_tokens)``) in both packages.
"""

import numpy as np
import pytest

import jax

import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.convert import key_from_jax
from smdistributed_modelparallel_tpu_torch.utils import exec_cache

from test_torch_generate_beams import zoo_pair
from test_torch_generate_nn import HEAD, head_pair, jax_generate, port_generate, prompts

JKEY = jax.random.key(7)
SAMPLE = dict(temperature=0.8, top_k=30)


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _head():
    return head_pair(HEAD, seed=5)


# name -> (model factory, [(prompt seed, (B, T), max_new_tokens, options)], bucket spec)
CASES = {
    "ragged_prompts": (_head, [(60, (2, 5), 3, {}), (61, (2, 7), 5, {})], "seq:8,16"),
    "zoo_decode_length_only": (lambda: zoo_pair(seed=6, pos_type="rotary"), [(62, (2, 5), 3, {})], "seq:8,16"),
    "eos_rows_and_overflow": (_head, [(63, (2, 6), 4, {"eos": True}), (63, (2, 6), 12, {})], "seq:8"),
    "position_limit": (lambda: zoo_pair(seed=6, pos_type="rotary", max_len=16), [(64, (1, 6), 9, {})], "seq:8,16"),
}


@pytest.fixture(scope="module")
def bucket_runs():
    """Per case and mode: the JAX package's output with and without the
    buckets, and the port's model."""
    mp = pytest.MonkeyPatch()
    out = {}
    for case, (factory, calls, spec) in CASES.items():
        jmod, params, tmod = factory()
        runs = []
        for seed, (B, T), new, extra in calls:
            ids = prompts(B=B, length=T, seed=seed)
            kw = {}
            if extra.get("eos"):
                probe = jax_generate(jmod, params, ids, new)
                kw = dict(eos_token_id=int(probe[0, T]), pad_token_id=0)
            for mode, skw in (("greedy", {}), ("sampled", dict(SAMPLE, rng=JKEY))):
                mp.delenv(exec_cache.BUCKETS_ENV, raising=False)
                exact = jax_generate(jmod, params, ids, new, **kw, **skw)
                mp.setenv(exec_cache.BUCKETS_ENV, spec)
                bucketed = jax_generate(jmod, params, ids, new, **kw, **skw)
                runs.append(dict(ids=ids, new=new, kw=kw, mode=mode, exact=exact, bucketed=bucketed))
        mp.undo()
        out[case] = (tmod, runs)
    return out


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("case", list(CASES))
def test_buckets_equal_jax(bucket_runs, case, mode, monkeypatch):
    tmod, runs = bucket_runs[case]
    spec = CASES[case][2]
    for run in (r for r in runs if r["mode"] == mode):
        skw = dict(SAMPLE, rng=key_from_jax(jax.random.key_data(JKEY))) if mode == "sampled" else {}
        monkeypatch.delenv(exec_cache.BUCKETS_ENV, raising=False)
        exact = port_generate(tmod, run["ids"], run["new"], **run["kw"], **skw)
        monkeypatch.setenv(exec_cache.BUCKETS_ENV, spec)
        got = port_generate(tmod, run["ids"], run["new"], **run["kw"], **skw)
        assert got.shape == (run["ids"].shape[0], run["ids"].shape[1] + run["new"])
        np.testing.assert_array_equal(exact, run["exact"])
        np.testing.assert_array_equal(got, run["bucketed"])
        if mode == "greedy":
            np.testing.assert_array_equal(got, exact)  # greedy output does not move with the buckets


def test_policy_parsing(monkeypatch):
    monkeypatch.setenv(exec_cache.BUCKETS_ENV, "seq:16,8,8; batch:4;seq_pad=2")
    assert exec_cache.bucket_policy() == {"seq_pad": 2, "seq": [8, 16], "batch": [4]}
    assert exec_cache.bucket_for(9, [8, 16]) == 16 and exec_cache.bucket_for(17, [8, 16]) is None
    monkeypatch.setenv(exec_cache.BUCKETS_ENV, "seq:8,x")
    assert exec_cache.bucket_policy() is None  # malformed: bucketing off, a warning
    monkeypatch.setenv(exec_cache.BUCKETS_ENV, "batch:4")
    tmod = zoo_pair(seed=6)[2]
    ids = prompts(B=1, length=5)
    assert port_generate(tmod, ids, 3).shape == (1, 8)  # no "seq" sizes: nothing buckets
