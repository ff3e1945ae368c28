"""Multi-rank checkpoints at rdp = 2 on the CPU.

The round trip of ``tests/test_multiprocess.py::_ckpt_body`` at rdp = 2, in
two gloo ranks: train, save one partial checkpoint (each rank's shard files,
its ``.done_p{rank}`` marker, one ``newest`` after both committed; rank 1's
shard files are empty, since a replicated leaf is stored once, by replica
0), train on, resume, and the resumed steps repeat the original losses bit
for bit. Then the elastic resumes both ways: a one-process run at rdp = 1
resumes the rdp = 2 checkpoint, and the two ranks resume an rdp = 1
checkpoint, each to bit-equal parameters and AdamW moments. Last, the JAX
package, in this one CPU process, resumes the port's rdp = 2 checkpoint and
trains on to the port's losses.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM

ZOO = dict(vocab_size=64, max_len=16, d_model=32, n_layers=2, n_heads=4)
CFG = {"microbatches": 2, "ddp": True}
LR, N, K = 1e-2, 2, 2  # N steps before the save, K after it


def _batch():
    return np.random.default_rng(3).integers(0, 64, (8, 16))


def _build(seed=0):
    torch.manual_seed(seed)
    model = smp.DistributedModel(TransformerLM(**ZOO), device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids):
        loss = model(ids[:, :-1], targets=ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    return model, opt, train_step


def _train(model, opt, train_step, ids, steps):
    losses = []
    for _ in range(steps):
        losses.append(float(train_step(model, ids).reduce_mean()))
        opt.step()
    return losses


def _snapshot(model, opt):
    """Parameters and AdamW state in the JAX layout (numpy)."""
    return model.reference_state_dict(), {k: np.asarray(v) for k, v in opt.reference_state_dict().items()}


def _rank(rank, world, root):
    ids = torch.from_numpy(_batch()[rank * 4:(rank + 1) * 4])  # this rank's rows
    out = {}
    # The elastic resume of the one-process checkpoint "w1" at rdp = 2.
    smp.init(CFG, device="cpu")
    smp.resume_from_checkpoint(root, tag="w1")
    model, opt, train_step = _build(seed=rank + 7)
    out["w1"] = _snapshot(model, opt)
    smp.reset()

    smp.init(CFG, device="cpu")
    model, opt, train_step = _build()
    out["before"] = _train(model, opt, train_step, ids, N)
    smp.save_checkpoint(root, tag="t1", user_content={"run": "rdp2"})
    smp.barrier()
    out["saved"] = _snapshot(model, opt)
    out["files"] = sorted(os.listdir(os.path.join(root, "t1_partial")))
    out["after"] = _train(model, opt, train_step, ids, K)
    # Resume into the live model and optimizer: the saved values come back.
    out["user"] = smp.resume_from_checkpoint(root, tag="t1")
    out["restored"] = _snapshot(model, opt)
    out["resumed"] = _train(model, opt, train_step, ids, K)
    smp.shutdown()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_ckpt"))
    # A one-process run (rdp = 1) on the global batch writes "w1".
    smp.reset()
    smp.init(CFG, device="cpu")
    model, opt, train_step = _build(seed=3)
    _train(model, opt, train_step, torch.from_numpy(_batch()), N)
    smp.save_checkpoint(root, tag="w1")
    w1 = _snapshot(model, opt)
    smp.reset()
    return root, w1, run_ranks(2, _rank, root, timeout=300)


def _assert_equal(got, want):
    (gp, go), (wp, wo) = got, want
    assert set(gp) == set(wp) and set(go) == set(wo)
    for k in wp:
        np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
    for k in wo:
        np.testing.assert_array_equal(go[k], wo[k], err_msg=k)


def test_rdp2_files_and_single_commit(runs):
    root, _, per_rank = runs
    d = os.path.join(root, "t1_partial")
    files = set(per_rank[0]["files"])
    for p in range(2):
        assert {f"model_shards_p{p}.npz", f"optimizer_shards_p{p}.npz", f".done_p{p}"} <= files
    assert ".committed" in files and "smp_config.pt" in files
    assert np.load(os.path.join(d, "model_shards_p0.npz")).files
    assert not np.load(os.path.join(d, "model_shards_p1.npz")).files  # replica 0 stores each leaf once
    with open(os.path.join(d, "smp_config.pt"), "rb") as fh:
        assert pickle.load(fh)["num_processes"] == 2
    with open(os.path.join(root, "newest")) as fh:
        assert fh.read() == "t1"


def test_rdp2_resume_is_bit_equal(runs):
    _, _, per_rank = runs
    for r in per_rank:
        assert r["user"] == {"run": "rdp2"}
        _assert_equal(r["restored"], r["saved"])
        assert r["resumed"] == r["after"]
    _assert_equal(per_rank[1]["saved"], per_rank[0]["saved"])
    assert per_rank[0]["after"] == per_rank[1]["after"]


def test_elastic_resume_at_rdp1_of_the_rdp2_checkpoint(runs):
    root, _, per_rank = runs
    smp.reset()
    try:
        smp.init(CFG, device="cpu")
        smp.resume_from_checkpoint(root, tag="t1")
        model, opt, train_step = _build(seed=11)
        _assert_equal(_snapshot(model, opt), per_rank[0]["saved"])
    finally:
        smp.reset()


def test_elastic_resume_at_rdp2_of_an_rdp1_checkpoint(runs):
    _, w1, per_rank = runs
    for r in per_rank:
        _assert_equal(r["w1"], w1)


def test_jax_resumes_the_port_rdp2_checkpoint(runs):
    root, _, per_rank = runs
    jax_smp.reset()
    try:
        jax_smp.init({"microbatches": 2})
        assert jax_smp.resume_from_checkpoint(root, tag="t1") == {"run": "rdp2"}
        model = jax_smp.DistributedModel(JaxTransformerLM(**ZOO))
        opt = jax_smp.DistributedOptimizer(optax.adamw(LR), model)

        @jax_smp.step
        def train_step(model, ids):
            loss = jnp.mean(model(ids[:, :-1], targets=ids[:, 1:]))
            model.backward(loss)
            return loss

        got = []
        for _ in range(K):
            got.append(float(train_step(model, jnp.asarray(_batch())).reduce_mean()))
            opt.step()
        # The port's rdp = 2 losses are the global batch's mean over both ranks.
        np.testing.assert_allclose(got, per_rank[0]["after"], rtol=2e-5)
    finally:
        jax_smp.reset()
