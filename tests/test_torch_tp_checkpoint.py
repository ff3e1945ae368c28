"""Checkpoints at tp = 2 on the CPU.

The ``smp.nn`` LM head (AdamW) in two gloo ranks at tp = 2:
  - built from a seed, it holds exact slices of the tp = 1 model from that
    seed (the gathered reference dicts are bit-equal);
  - a partial checkpoint: each tp rank writes its region of every
    tp-sharded leaf (``"key|bounds"`` pieces that cover the leaf once) and
    rank 0 the replicated leaves; training on, resuming and training again
    repeats the losses bit for bit;
  - elastic both ways (``tests/test_resilience.py``'s ``TestElasticResume``
    semantics): a one-process run at tp = 1 resumes the tp = 2 checkpoint,
    and the two ranks resume a tp = 1 checkpoint, each to bit-equal
    parameters and AdamW moments; ``elastic=False`` across the change raises
    ``SMPValidationError`` (``tests/test_checkpoint.py``'s
    ``test_config_mismatch_rejected``);
  - ``partial=False`` gathers over tp into the unsharded layout: for the same
    weights it equals the tp = 1 full save bit for bit, and the JAX package
    loads it as it loads a tp = 1 one.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import smdistributed_modelparallel_tpu_torch as smp
from chip_smoke import run_ranks
from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerLMHead
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

HEAD = dict(
    num_layers=2, num_attention_heads=4, attention_head_size=8, hidden_size=32, intermediate_size=64,
    vocab_size=64, num_positions=16, causal_mask_size=16, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
TP2 = {"microbatches": 2, "ddp": True, "tensor_parallel_degree": 2}
TP1 = {"microbatches": 2}
LR, N, K = 1e-2, 2, 2  # N steps before the save, K after it


def _batch():
    return torch.from_numpy(np.random.default_rng(3).integers(0, 64, (4, 16)))


def _build(seed=0):
    torch.manual_seed(seed)
    model = smp.DistributedModel(DistributedTransformerLMHead(**HEAD), device="cpu")
    opt = smp.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4, eps=1e-8), model)

    @smp.step
    def train_step(model, ids):
        loss = model(ids[:, :-1], targets=ids[:, 1:]).mean()
        model.backward(loss)
        return loss

    return model, opt, train_step


def _train(model, opt, train_step, steps):
    losses = []
    for _ in range(steps):
        losses.append(float(train_step(model, _batch()).reduce_mean()))
        opt.step()
    return losses


def _snapshot(model, opt):
    """Parameters and AdamW state in the JAX layout (numpy; whole over tp)."""
    return model.reference_state_dict(), {k: np.asarray(v) for k, v in opt.reference_state_dict().items()}


def _rank(rank, world, root):
    torch.set_num_threads(1)
    out = {}
    smp.init(TP2, device="cpu")
    model, opt, train_step = _build()
    out["init"] = model.reference_state_dict()
    out["before"] = _train(model, opt, train_step, N)
    smp.save_checkpoint(root, tag="t2", user_content={"run": "tp2"})
    smp.barrier()
    out["saved"] = _snapshot(model, opt)
    d = os.path.join(root, "t2_partial")
    out["files"] = sorted(os.listdir(d))
    out["after"] = _train(model, opt, train_step, K)
    out["user"] = smp.resume_from_checkpoint(root, tag="t2")
    out["restored"] = _snapshot(model, opt)
    out["resumed"] = _train(model, opt, train_step, K)
    smp.reset()

    # The elastic resume of the one-process checkpoint "w1" at tp = 2, then
    # a full save of the same weights.
    smp.init(TP2, device="cpu")
    smp.resume_from_checkpoint(root, tag="w1")
    model, opt, train_step = _build(seed=rank + 7)
    out["w1"] = _snapshot(model, opt)
    smp.save_checkpoint(root, tag="f2", partial=False)
    smp.barrier()
    smp.reset()

    smp.init(TP2, device="cpu")
    try:
        smp.resume_from_checkpoint(root, tag="w1", elastic=False)
        out["strict"] = None
    except SMPValidationError as e:
        out["strict"] = str(e)
    smp.shutdown()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_ckpt"))
    threads = torch.get_num_threads()
    smp.reset()
    try:
        smp.init(TP1, device="cpu")
        init, *_ = _build()
        init = init.reference_state_dict()
        model, opt, train_step = _build(seed=3)
        _train(model, opt, train_step, N)
        smp.save_checkpoint(root, tag="w1")
        smp.save_checkpoint(root, tag="f1", partial=False)
        w1 = _snapshot(model, opt)
    finally:
        smp.reset()
        torch.set_num_threads(threads)
    return root, init, w1, run_ranks(2, _rank, root, timeout=300)


def _assert_equal(got, want):
    (gp, go), (wp, wo) = got, want
    assert set(gp) == set(wp) and set(go) == set(wo)
    for k in wp:
        np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
    for k in wo:
        np.testing.assert_array_equal(go[k], wo[k], err_msg=k)


def test_tp2_model_holds_slices_of_the_tp1_draw(runs):
    _, init, _, per_rank = runs
    for r in per_rank:
        assert set(r["init"]) == set(init)
        for k in init:
            np.testing.assert_array_equal(r["init"][k], init[k], err_msg=k)


def test_tp2_files_hold_each_rank_s_pieces(runs):
    root, _, _, per_rank = runs
    d = os.path.join(root, "t2_partial")
    files = set(per_rank[0]["files"])
    for p in range(2):
        assert {f"model_shards_p{p}.npz", f"optimizer_shards_p{p}.npz", f".done_p{p}"} <= files
    assert ".committed" in files
    pieces = [set(np.load(os.path.join(d, f"model_shards_p{p}.npz")).files) for p in range(2)]
    qkv = "transformer/seq_layers/layer/attention/qkv/kernel"
    # [layers, D, 3, H, hd]: the heads over tp.
    assert f"{qkv}|[[0, 2], [0, 32], [0, 3], [0, 2], [0, 8]]" in pieces[0]
    assert f"{qkv}|[[0, 2], [0, 32], [0, 3], [2, 4], [0, 8]]" in pieces[1]
    assert not any(k.startswith("ln_f/") for k in pieces[1])  # replicated: stored once, by tp rank 0
    opt = set(np.load(os.path.join(d, "optimizer_shards_p1.npz")).files)
    assert f"0/mu/{qkv}|[[0, 2], [0, 32], [0, 3], [2, 4], [0, 8]]" in opt
    with open(os.path.join(d, "smp_config.pt"), "rb") as fh:
        saved = pickle.load(fh)
    assert saved["num_processes"] == 2 and saved["tensor_parallel_degree"] == 2


def test_tp2_resume_is_bit_equal(runs):
    _, _, _, per_rank = runs
    for r in per_rank:
        assert r["user"] == {"run": "tp2"}
        _assert_equal(r["restored"], r["saved"])
        assert r["resumed"] == r["after"]
    _assert_equal(per_rank[1]["saved"], per_rank[0]["saved"])
    assert per_rank[0]["after"] == per_rank[1]["after"]


def test_elastic_resume_at_tp1_of_the_tp2_checkpoint(runs):
    root, _, _, per_rank = runs
    smp.reset()
    try:
        smp.init(TP1, device="cpu")
        smp.resume_from_checkpoint(root, tag="t2")
        model, opt, _ = _build(seed=11)
        _assert_equal(_snapshot(model, opt), per_rank[0]["saved"])
    finally:
        smp.reset()


def test_elastic_resume_at_tp2_of_a_tp1_checkpoint(runs):
    _, _, w1, per_rank = runs
    for r in per_rank:
        _assert_equal(r["w1"], w1)


def test_strict_resume_across_tp_raises(runs):
    _, _, _, per_rank = runs
    for r in per_rank:
        assert r["strict"] is not None and "tensor_parallel_degree" in r["strict"], r["strict"]


def test_full_save_equals_tp1_and_loads_in_jax(runs):
    # The JAX side is imported here: the spawned ranks import this module.
    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.nn import transformer as jax_tr

    root, _, _, _ = runs
    with open(os.path.join(root, "f1"), "rb") as fh:
        f1 = pickle.load(fh)
    with open(os.path.join(root, "f2"), "rb") as fh:
        f2 = pickle.load(fh)
    for part in ("model", "optimizer"):
        assert set(f2[part]) == set(f1[part])
        for k in f1[part]:
            np.testing.assert_array_equal(np.asarray(f2[part][k]), np.asarray(f1[part][k]), err_msg=k)
    jax_smp.reset()
    try:
        jax_smp.init({"microbatches": 2})
        jax_smp.resume_from_checkpoint(root, tag="f2", partial=False)
        model = jax_smp.DistributedModel(jax_tr.DistributedTransformerLMHead(**HEAD))
        model(_batch().numpy())  # the lazy init, then the deferred load
        got = {k: np.asarray(v) for k, v in model.state_dict().items()}
        assert set(got) == set(f2["model"])
        for k, v in f2["model"].items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    finally:
        jax_smp.reset()
