"""The port's checkpoints against the JAX package's, in both directions.

Both packages write one on-disk format (pickles and npz shard catalogs keyed
by the JAX package's pytree paths), so a run moves between them. On the CPU,
fp32, with a small ``smp.nn`` ``DistributedTransformerLMHead`` (``TINY``, the
config of ``tests/test_checkpoint.py``) and a small zoo ``TransformerLM``
(``ZOO``), trained with AdamW (``optax.adamw`` and ``torch.optim.AdamW`` with
its defaults) at 2 microbatches:
  - JAX to port: the JAX package trains N steps, saves a partial and a full
    checkpoint, and trains K more; the port resumes each (before its model
    exists: the deferred path) into a model built from another seed and
    trains K steps. Losses and parameters match the JAX run's at
    ``tests/test_torch_step.py``'s tolerances (losses rtol 2e-4 / atol 2e-5,
    parameters rtol 2e-3 / atol 2e-4: the same function in fp32, summed in
    other orders);
  - port to JAX: the same the other way round, from weights drawn by a seeded
    numpy generator in the JAX layout and loaded through ``convert.py``;
  - resharding: the JAX package saves at ``tensor_parallel_degree: 2`` and
    ``pipeline_parallel_degree: 2`` on its 8-device CPU mesh (leaves split
    into pieces); the port resumes on one device and the losses continue;
  - the same keys and arrays: the port's model and optimizer
    ``local_state_dict()``s and npz files hold the JAX package's keys,
    bounds and shapes, and equal arrays; ``convert.py``'s maps round-trip
    bit for bit, bf16 included, and a bf16 leaf the port writes is the file
    the JAX package writes;
  - the cases of ``tests/test_checkpoint.py`` against the port (file naming,
    v2 detection, ``newest``, retention GC and the orphan sweep, the config
    check with ``elastic=False``, deferred application, async snapshots,
    submission order, errors surfacing on ``wait_for_checkpoints``), the
    interrupted-save refusal and the coverage pre-flight;
  - the fp16 loss scaler and the fp8 ``QuantState`` through
    ``fp16_states.pt`` and ``quant_states.pt``, both directions;
  - two gloo ranks at ``context_parallel_degree: 2`` save (per-rank files,
    ``.done_p1``, commit by rank 0) and resume to the same losses.
"""

import glob
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import smdistributed_modelparallel_tpu as jax_smp
from smdistributed_modelparallel_tpu import shard_io as jax_shard_io
from smdistributed_modelparallel_tpu.backend.state import state as jax_state
from smdistributed_modelparallel_tpu.fp16.loss_scaler import DynamicLossScaler as JaxDynamicLossScaler
from smdistributed_modelparallel_tpu.models.transformer_lm import TransformerLM as JaxTransformerLM
from smdistributed_modelparallel_tpu.nn.cross_entropy import vocab_parallel_cross_entropy as jax_vpce
from smdistributed_modelparallel_tpu.nn.transformer import DistributedTransformerLMHead as JaxLMHead
from smdistributed_modelparallel_tpu.quant import QuantState as JaxQuantState
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch import convert, shard_io
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.quant import QuantState
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPRuntimeError, SMPValidationError
from chip_smoke import run_ranks

TINY = dict(
    num_layers=2, num_attention_heads=2, attention_head_size=8, hidden_size=16, intermediate_size=32,
    vocab_size=64, num_positions=32, causal_mask_size=32, pre_layernorm=True, post_layernorm=False,
    final_layernorm=True, attention_dropout_prob=0.0, hidden_dropout_prob=0.0, embedding_dropout_prob=0.0,
)
ZOO = dict(vocab_size=64, max_len=32, d_model=32, n_layers=2, n_heads=4)
CFG = {"microbatches": 2}
LR = 1e-3
N, K = 2, 2  # steps before the save, steps after it
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this file's tensors are small, so torch's thread
    pool costs more than it gives (8 threads took 25x longer than one for
    the dropout hash), and the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _ids():
    return np.random.default_rng(3).integers(0, 64, (4, 16)).astype(np.int32)


# ----------------------------------------------------------------------
# The two packages' training loops
# ----------------------------------------------------------------------


def _jax_start(family, cfg=CFG):
    jax_smp.reset()
    jax_smp.init(cfg)
    return _jax_build(family)


def _jax_build(family, tx=None):
    """The JAX package's model, optimizer and step; ``smp.init`` has run."""
    module = JaxLMHead(**TINY) if family == "nn" else JaxTransformerLM(**ZOO)
    model = jax_smp.DistributedModel(module)
    opt = jax_smp.DistributedOptimizer(tx or optax.adamw(LR), model)

    @jax_smp.step
    def train_step(model, ids):
        logits = model(ids)
        loss = jnp.mean(jax_vpce(logits[:, :-1], ids[:, 1:]))
        model.backward(loss)
        return loss

    return model, opt, train_step


def _port_build(family, seed=0, init=None, optimizer=None):
    """The port's model (``init``: a state dict of either layout), its
    AdamW and step; ``smp.init`` has run."""
    torch.manual_seed(seed)
    module = smp.nn.DistributedTransformerLMHead(**TINY) if family == "nn" else TransformerLM(**ZOO)
    model = smp.DistributedModel(module, device="cpu")
    if init is not None:
        model.load_state_dict(init)
    inner = (optimizer or (lambda ps: torch.optim.AdamW(ps, lr=LR, weight_decay=1e-4, eps=1e-8)))(
        model.parameters())
    opt = smp.DistributedOptimizer(inner, model)

    @smp.step
    def train_step(model, ids):
        logits = model(ids)
        loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:].long()).mean()
        model.backward(loss)
        return loss

    return model, opt, train_step


def _train(model, opt, train_step, ids, steps):
    losses = []
    for _ in range(steps):
        losses.append(float(train_step(model, ids).reduce_mean()))
        opt.step()
    return losses


def _numpy_init(family, seed=11):
    """Weights in the JAX layout from a seeded numpy generator: the port
    model's reference layout, every leaf drawn anew."""
    smp.init(CFG, device="cpu")
    model, _, _ = _port_build(family)
    shapes = {k: v.shape for k, v in model.reference_state_dict().items()}
    smp.reset()
    rng = np.random.default_rng(seed)
    return {k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}


def _key_bias(key, arr):
    """(the key bias's elements, the rest) of a qkv bias in the JAX layout,
    or None: zoo [L, 3D] (columns D:2D), smp.nn [L, 3, H, hd] ([:, 1])."""
    if key == "layers/block/attn/qkv/bias":
        d = arr.shape[1] // 3
        return arr[:, d:2 * d], np.concatenate([arr[:, :d], arr[:, 2 * d:]], axis=1)
    if key.endswith("attention/qkv/bias"):
        return arr[:, 1], arr[:, ::2]
    return None


def _assert_params_close(got, want):
    """Every parameter at PARAM_TOL, but the key bias: softmax ignores a
    shift along a query's row, so its gradient is zero but for rounding, and
    AdamW moves it by up to LR a step in whichever direction each package's
    rounding picks (up to 2 LR a step apart)."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        split = _key_bias(k, g)
        if split is None:
            np.testing.assert_allclose(g, w, err_msg=k, **PARAM_TOL)
            continue
        (g_key, g_rest), (w_key, w_rest) = split, _key_bias(k, w)
        np.testing.assert_allclose(g_rest, w_rest, err_msg=k, **PARAM_TOL)
        np.testing.assert_allclose(g_key, w_key, rtol=0, atol=2 * LR * (N + K), err_msg=k + " (key bias)")


# ----------------------------------------------------------------------
# JAX to port
# ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=["nn", "zoo"])
def jax_run(request, tmp_path_factory):
    """The JAX package trains N + K steps and saves a partial ("p") and a
    full ("f") checkpoint after N: its losses, final parameters and the
    local state dicts at the save."""
    family = request.param
    root = str(tmp_path_factory.mktemp(f"jax_{family}"))
    model, opt, train_step = _jax_start(family)
    ids = jnp.asarray(_ids())
    losses, local = [], None
    for i in range(N + K):
        if i == N:
            # The side files too: a loss scaler and an fp8 state held only
            # for the saves, so the fp32 training is unchanged.
            jax_state.loss_scaler = JaxDynamicLossScaler()
            hist, scale = _quant_arrays(1)
            jax_state.quant_state = JaxQuantState()
            jax_state.quant_state.amax_history, jax_state.quant_state.scale = jnp.asarray(hist), jnp.asarray(scale)
            side = (_scaler_state(jax_state.loss_scaler), hist, scale)
            jax_smp.save_checkpoint(root, tag="p", user_content={"from": "jax", "step": N})
            jax_state.loss_scaler = jax_state.quant_state = None
            jax_smp.save_checkpoint(root, tag="f", partial=False, user_content={"from": "jax", "step": N})
            local = (model.local_state_dict(), opt.local_state_dict())
        losses.append(float(train_step(model, ids).reduce_mean()))
        opt.step()
    final = model.state_dict()
    jax_smp.reset()
    return dict(family=family, root=root, losses=losses, final=final, local=local, side=side)


@pytest.mark.parametrize("partial", [True, False], ids=["partial", "full"])
def test_jax_checkpoint_resumes_in_port(jax_run, partial):
    smp.init(CFG, device="cpu")
    user = smp.resume_from_checkpoint(jax_run["root"], tag="p" if partial else "f", partial=partial)
    assert user == {"from": "jax", "step": N}
    assert state.step_count == N
    assert state.loaded_model_state is not None and state.loaded_optimizer_state is not None
    model, opt, train_step = _port_build(jax_run["family"], seed=7)  # another init: the checkpoint wins
    assert state.loaded_model_state is None and state.loaded_optimizer_state is None
    losses = _train(model, opt, train_step, torch.from_numpy(_ids()), K)
    np.testing.assert_allclose(losses, jax_run["losses"][N:], **LOSS_TOL)
    _assert_params_close(model.reference_state_dict(), jax_run["final"])


def _entries(payload):
    return {k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in payload.items()}


def test_local_state_dicts_and_files_match_jax(jax_run, tmp_path):
    """Resumed from the JAX checkpoint, the port's local state dicts and the
    files it writes hold the JAX package's keys, bounds, shapes, dtypes and
    arrays."""
    smp.init(CFG, device="cpu")
    smp.resume_from_checkpoint(jax_run["root"], tag="p")
    model, opt, _ = _port_build(jax_run["family"])
    for got, want in zip((model.local_state_dict(), opt.local_state_dict()), jax_run["local"]):
        assert _entries(got) == _entries(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    smp.save_checkpoint(str(tmp_path), tag="p")
    for comp in ("model", "optimizer"):
        ours = np.load(tmp_path / "p_partial" / f"{comp}_shards_p0.npz")
        theirs = np.load(os.path.join(jax_run["root"], "p_partial", f"{comp}_shards_p0.npz"))
        assert sorted(ours.files) == sorted(theirs.files)
        for k in theirs.files:
            assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    with open(tmp_path / "p_partial" / "smp_config.pt", "rb") as fh:
        ours = pickle.load(fh)
    with open(os.path.join(jax_run["root"], "p_partial", "smp_config.pt"), "rb") as fh:
        theirs = pickle.load(fh)
    assert ours["num_processes"] == theirs["num_processes"] == 1
    assert ours["step_count"] == theirs["step_count"] == N


# ----------------------------------------------------------------------
# Port to JAX
# ----------------------------------------------------------------------


@pytest.mark.parametrize("family", ["nn", "zoo"])
def test_port_checkpoint_resumes_in_jax(family, tmp_path):
    root = str(tmp_path)
    init = _numpy_init(family)
    smp.init(CFG, device="cpu")
    model, opt, train_step = _port_build(family, init=init)
    ids = torch.from_numpy(_ids())
    want = _train(model, opt, train_step, ids, N)
    smp.save_checkpoint(root, tag="p", user_content={"from": "port"})
    smp.save_checkpoint(root, tag="f", partial=False, user_content={"from": "port"})
    want += _train(model, opt, train_step, ids, K)
    final = model.reference_state_dict()
    smp.reset()

    jax_smp.init(CFG)
    assert jax_smp.resume_from_checkpoint(root, tag="p") == {"from": "port"}
    jmodel, jopt, jstep = _jax_build(family)
    jids = jnp.asarray(_ids())
    got = _train(jmodel, jopt, jstep, jids, K)
    np.testing.assert_allclose(got, want[N:], **LOSS_TOL)
    _assert_params_close(jmodel.state_dict(), final)
    # The full checkpoint, into the live model and optimizer.
    assert jax_smp.resume_from_checkpoint(root, tag="f", partial=False) == {"from": "port"}
    got = _train(jmodel, jopt, jstep, jids, K)
    np.testing.assert_allclose(got, want[N:], **LOSS_TOL)
    _assert_params_close(jmodel.state_dict(), final)


# ----------------------------------------------------------------------
# Resharding: tp 2 and pp 2 in the JAX package, one device in the port
# ----------------------------------------------------------------------


def test_tp2_pp2_jax_checkpoint_resumes_on_one_device(tmp_path):
    root = str(tmp_path)
    cfg = {"pipeline_parallel_degree": 2, "tensor_parallel_degree": 2, "ddp": True, "microbatches": 2}
    model, opt, train_step = _jax_start("nn", cfg)
    ids = jnp.asarray(_ids())
    want = _train(model, opt, train_step, ids, N)
    jax_smp.save_checkpoint(root, tag="s")
    want += _train(model, opt, train_step, ids, K)
    final = model.state_dict()
    jax_smp.reset()
    files = np.load(os.path.join(root, "s_partial", "model_shards_p0.npz")).files
    assert len(files) > len({k.rpartition("|")[0] for k in files}), "the leaves should be stored split"

    smp.init(CFG, device="cpu")
    with pytest.raises(SMPValidationError):
        smp.resume_from_checkpoint(root, tag="s", elastic=False)
    smp.resume_from_checkpoint(root, tag="s")
    model, opt, train_step = _port_build("nn", seed=7)
    got = _train(model, opt, train_step, torch.from_numpy(_ids()), K)
    np.testing.assert_allclose(got, want[N:], **LOSS_TOL)
    _assert_params_close(model.reference_state_dict(), final)


# ----------------------------------------------------------------------
# convert.py's maps and bf16 leaves
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["nn", "zoo"])
def test_convert_round_trip_is_bit_equal(family, dtype):
    torch.manual_seed(0)
    if family == "nn":
        module = smp.nn.DistributedTransformerLMHead(**TINY)
        to_jax = lambda sd: convert.lm_head_params_to_jax(sd, TINY["num_attention_heads"])  # noqa: E731
        from_jax = convert.lm_head_params_from_jax
    else:
        module = TransformerLM(**ZOO)
        to_jax, from_jax = convert.params_to_jax, convert.params_from_jax
    sd = {k: v.to(dtype) for k, v in module.state_dict().items()}
    flat = to_jax(sd)
    back = from_jax(flat)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    again = to_jax(back)
    for k, v in flat.items():
        assert again[k].dtype == v.dtype and again[k].tobytes() == v.tobytes(), k


def test_convert_gives_the_jax_layout():
    """The inverse maps produce the JAX package's own keys and shapes (of a
    JAX init of the same config), and invert ``*_from_jax`` on them."""
    from flax.core import meta
    from smdistributed_modelparallel_tpu.module_manager import path_key as jax_path_key

    for family in ("nn", "zoo"):
        module = JaxLMHead(**TINY) if family == "nn" else JaxTransformerLM(**ZOO)
        params = jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]  # one compile
        flat = {jax_path_key(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(meta.unbox(params))[0]}
        if family == "nn":
            back = convert.lm_head_params_to_jax(convert.lm_head_params_from_jax(flat), TINY["num_attention_heads"])
        else:
            back = convert.params_to_jax(convert.params_from_jax(flat))
        assert set(back) == set(flat)
        for k, v in flat.items():
            assert back[k].shape == v.shape and back[k].tobytes() == v.tobytes(), k


def _npy_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("ml_dtypes_present", [True, False])
def test_bf16_leaf_written_as_jax_writes_it(tmp_path, monkeypatch, ml_dtypes_present):
    """A bf16 leaf the port writes is byte for byte the npy member the JAX
    package writes for the same values; without ``ml_dtypes`` its header
    says ``|V2`` where ``ml_dtypes`` writes ``<V2`` (both load as ``V2``) and
    the data bytes are the same. Both packages read the other's file bit
    for bit."""
    if not ml_dtypes_present:
        monkeypatch.setattr(convert, "_BF16", np.dtype("V2"))
    values = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(values).bfloat16()
    smp.init({}, device="cpu")
    ours = shard_io.save_sharded({"w": t, "b": torch.arange(4.0)}, str(tmp_path / "port"), "model")
    jax_smp.init({})
    tree = {"w": jnp.asarray(values, jnp.bfloat16), "b": jnp.arange(4.0)}
    theirs = jax_shard_io.save_sharded(jax.device_put(tree, jax.devices()[0]), str(tmp_path / "jax"), "model")
    if ml_dtypes_present:
        assert _npy_members(ours) == _npy_members(theirs)
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k
    # The JAX package reads the port's piece (np.load gives |V2).
    cat = jax_shard_io.ShardCatalog(str(tmp_path / "port"), "model")
    piece = np.asarray(cat._read(*cat.entries["w"][0][:2]))
    assert piece.dtype == np.dtype("V2")
    np.testing.assert_array_equal(piece.view(np.uint16), np.asarray(tree["w"]).view(np.uint16))
    cat.close()
    # The port reads the JAX package's file into torch.bfloat16.
    cat = shard_io.ShardCatalog(str(tmp_path / "jax"), "model")
    got = cat.load_tree({"w": torch.empty(3, 5, dtype=torch.bfloat16), "b": torch.empty(4)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(got["b"], torch.arange(4.0))


def test_flatten_matches_jax_tree_util():
    """``module_manager.tree_flatten_with_path`` + ``path_key`` name an
    optax adamw state as ``jax.tree_util`` does."""
    from smdistributed_modelparallel_tpu.module_manager import path_key as jax_path_key
    from smdistributed_modelparallel_tpu_torch.module_manager import path_key, tree_flatten_with_path

    params = {"b": {"kernel": jnp.ones((2, 3)), "bias": jnp.ones(3)}, "a": jnp.ones(4)}
    opt_state = optax.adamw(1e-3).init(params)
    want = [jax_path_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(opt_state)[0]]
    host = jax.tree_util.tree_map(np.asarray, opt_state)
    got = [path_key(p) for p, _ in tree_flatten_with_path(host)]
    assert got == want


# ----------------------------------------------------------------------
# The optimizer map
# ----------------------------------------------------------------------


def test_unmapped_optimizer_raises_naming_the_mapped_ones():
    smp.init(CFG, device="cpu")
    for make in (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
                 lambda ps: torch.optim.Adam(ps, lr=LR, weight_decay=0.1),
                 lambda ps: torch.optim.AdamW(ps, lr=LR, amsgrad=True)):
        model, opt, train_step = _port_build("nn", optimizer=make)
        _train(model, opt, train_step, torch.from_numpy(_ids()), 1)
        with pytest.raises(SMPValidationError, match="torch.optim.AdamW .optax.adamw."):
            opt.local_state_dict()
        # torch's own state dict is unaffected.
        assert opt.state_dict()["state"]


def test_adam_maps_onto_optax_adam(tmp_path):
    """torch.optim.Adam (no weight decay) resumes the JAX package's
    optax.adam run."""
    jax_smp.init(CFG)
    jmodel, jopt, jstep = _jax_build("nn", optax.adam(LR))
    ids = jnp.asarray(_ids())
    want = _train(jmodel, jopt, jstep, ids, N)
    jax_smp.save_checkpoint(str(tmp_path), tag="a")
    want += _train(jmodel, jopt, jstep, ids, K)
    jax_smp.reset()
    smp.init(CFG, device="cpu")
    smp.resume_from_checkpoint(str(tmp_path), tag="a")
    model, opt, train_step = _port_build("nn", optimizer=lambda ps: torch.optim.Adam(ps, lr=LR))
    np.testing.assert_allclose(_train(model, opt, train_step, torch.from_numpy(_ids()), K), want[N:], **LOSS_TOL)


# ----------------------------------------------------------------------
# The reference's cases, against the port
# ----------------------------------------------------------------------


def _port_setup(cfg=None):
    smp.reset()
    smp.init(cfg or CFG, device="cpu")
    return (*_port_build("nn"), torch.from_numpy(_ids()))


class TestSaveLoad:
    def test_partial_roundtrip(self, tmp_path):
        _port_setup()
        f = str(tmp_path / "obj.pt")
        written = smp.save({"a": np.arange(4)}, f)
        assert written.endswith("obj_0_0_0.pt")
        jax_smp.init({})
        assert jax_smp.save({"a": np.arange(4)}, str(tmp_path / "jax" / "obj.pt")).endswith("obj_0_0_0.pt")
        np.testing.assert_array_equal(smp.load(f)["a"], np.arange(4))

    def test_v2_format_autodetect(self, tmp_path):
        _port_setup()
        with open(str(tmp_path / "obj_0_0.pt"), "wb") as fh:
            pickle.dump({"x": 1}, fh)
        assert smp.load(str(tmp_path / "obj.pt"))["x"] == 1

    def test_missing_raises(self, tmp_path):
        _port_setup()
        with pytest.raises(SMPRuntimeError):
            smp.load(str(tmp_path / "nope.pt"))


class TestSaveCheckpointDir:
    def test_roundtrip_with_newest(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        opt.step()
        loss_before = float(step_fn(model, ids).reduce_mean())
        smp.save_checkpoint(str(tmp_path), tag="t1", user_content={"epoch": 3})
        assert (tmp_path / "newest").read_text() == "t1"
        assert (tmp_path / "t1_partial" / "model_shards_p0.npz").exists()
        assert (tmp_path / "t1_partial" / "optimizer_shards_p0.npz").exists()
        assert (tmp_path / "t1_partial" / ".committed").exists()
        assert not glob.glob(str(tmp_path / "t1_partial" / ".inflight*"))
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        assert smp.resume_from_checkpoint(str(tmp_path)) == {"epoch": 3}
        loss_after = float(step_fn(model, ids).reduce_mean())
        assert loss_after == loss_before

    def test_retention_gc(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        for i in range(4):
            smp.save_checkpoint(str(tmp_path), tag=f"t{i}", num_kept_partial_checkpoints=2)
        kept = sorted(d for d in os.listdir(tmp_path) if d.endswith("_partial"))
        assert kept == ["t2_partial", "t3_partial"]

    def test_gc_sweeps_interrupted_saves_only(self, tmp_path, monkeypatch):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        orphan, legacy = tmp_path / "o_partial", tmp_path / "l_partial"
        orphan.mkdir()
        (orphan / ".inflight_s9").write_text("9")
        legacy.mkdir()
        old = os.path.getmtime(tmp_path) - 3600
        for d in (orphan, legacy):
            os.utime(d, (old, old))
        monkeypatch.setenv("SMP_CKPT_COMMIT_TIMEOUT", "60")
        smp.save_checkpoint(str(tmp_path), tag="t", num_kept_partial_checkpoints=5)
        kept = sorted(d for d in os.listdir(tmp_path) if d.endswith("_partial"))
        assert kept == ["l_partial", "t_partial"]

    def test_config_mismatch_rejected_without_elastic(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        smp.save_checkpoint(str(tmp_path), tag="t1")
        smp.reset()
        smp.init({"microbatches": 4}, device="cpu")
        with pytest.raises(SMPValidationError):
            smp.resume_from_checkpoint(str(tmp_path), elastic=False)
        # A saved tp 2 layout: refused without elastic, gathered with it.
        cfg_path = tmp_path / "t1_partial" / "smp_config.pt"
        saved = pickle.loads(cfg_path.read_bytes())
        cfg_path.write_bytes(pickle.dumps(dict(saved, tensor_parallel_degree=2, microbatches=4)))
        with pytest.raises(SMPValidationError):
            smp.resume_from_checkpoint(str(tmp_path), elastic=False)
        smp.resume_from_checkpoint(str(tmp_path))
        assert state.loaded_model_state is not None

    def test_deferred_application(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        opt.step()
        ref = {k: v.clone() for k, v in model.state_dict().items()}
        smp.save_checkpoint(str(tmp_path), tag="t1")
        smp.reset()
        smp.init(CFG, device="cpu")
        smp.resume_from_checkpoint(str(tmp_path), load_optimizer=False)
        assert state.loaded_model_state is not None and state.loaded_optimizer_state is None
        seen = []
        model2, opt2, _ = _port_build("nn", seed=5)
        model2.register_post_partition_hook(lambda m: seen.append(
            torch.equal(m.state_dict()["word_embedding.weight"], ref["word_embedding.weight"])))
        assert seen == [True]  # once, after the deferred state
        assert not opt2.has_state
        for k, v in ref.items():
            assert torch.equal(model2.state_dict()[k], v), k

    def test_full_checkpoint(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        opt.step()
        want = float(step_fn(model, ids).reduce_mean())
        smp.save_checkpoint(str(tmp_path), tag="full1", partial=False)
        assert (tmp_path / "full1").exists()
        payload = pickle.loads((tmp_path / "full1").read_bytes())
        assert set(payload) == {"model", "optimizer", "user_content", "smp_config"}
        assert set(payload["model"]) == set(model.reference_state_dict())
        assert payload["optimizer"]["0/count"] == 1
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        smp.resume_from_checkpoint(str(tmp_path), partial=False)
        assert float(step_fn(model, ids).reduce_mean()) == want

    def test_interrupted_save_refused(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        smp.save_checkpoint(str(tmp_path), tag="t1")
        d = tmp_path / "t1_partial"
        (d / ".committed").unlink()
        (d / ".inflight_s3").write_text("3")
        with pytest.raises(SMPRuntimeError, match="interrupted mid-save"):
            smp.resume_from_checkpoint(str(tmp_path), tag="t1")

    def test_missing_shard_file_refused_before_apply(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        smp.save_checkpoint(str(tmp_path), tag="t1")
        cfg_path = tmp_path / "t1_partial" / "smp_config.pt"
        saved = pickle.loads(cfg_path.read_bytes())
        cfg_path.write_bytes(pickle.dumps(dict(saved, num_processes=2)))
        with pytest.raises(SMPRuntimeError, match="peer's file is missing"):
            smp.resume_from_checkpoint(str(tmp_path), tag="t1")
        assert state.loaded_model_state is None


class TestAsyncSave:
    def test_async_snapshot_is_exact(self, tmp_path):
        """The save holds the parameters as they were at submission, although
        ``optimizer.step()`` updates them in place right after."""
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        opt.step()
        want = model.reference_state_dict()
        want_opt = opt.reference_state_dict()
        smp.save_checkpoint(str(tmp_path), tag="a1", blocking=False)
        for _ in range(3):
            step_fn(model, ids)
            opt.step()
        smp.wait_for_checkpoints()
        now = model.reference_state_dict()
        assert not np.array_equal(now["word_embedding/embedding"], want["word_embedding/embedding"])
        smp.reset()
        smp.init(CFG, device="cpu")
        smp.resume_from_checkpoint(str(tmp_path), tag="a1")
        model2, opt2, _ = _port_build("nn", seed=9)
        for got, ref in ((model2.reference_state_dict(), want), (opt2.reference_state_dict(), want_opt)):
            for k, v in ref.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)

    def test_submission_order_newest(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        opt.step()
        smp.save_checkpoint(str(tmp_path), tag="t1", blocking=False)
        smp.save_checkpoint(str(tmp_path), tag="t2", blocking=False)
        smp.wait_for_checkpoints()
        assert (tmp_path / "newest").read_text() == "t2"

    def test_errors_surface_on_wait(self, tmp_path):
        model, opt, step_fn, ids = _port_setup()
        step_fn(model, ids)
        smp.save_checkpoint(str(tmp_path), tag="ok", blocking=False)
        smp.wait_for_checkpoints()
        (tmp_path / "bad_partial").write_text("")  # the job's directory is a file
        smp.save_checkpoint(str(tmp_path), tag="bad", blocking=False)
        with pytest.raises(Exception):
            smp.wait_for_checkpoints()
        smp.wait_for_checkpoints()  # drained after the failure is reported


# ----------------------------------------------------------------------
# Side files: the fp16 loss scaler and the fp8 state, both directions
# ----------------------------------------------------------------------


def _scaler_state(scaler):
    scaler.update(True)
    for _ in range(3):
        scaler.update(False)
    return scaler.state_dict()


def _quant_arrays(seed):
    rng = np.random.default_rng(seed)
    n, h = JaxQuantState().amax_history.shape
    return rng.random((n, h)).astype(np.float32), (rng.random(n) + 0.5).astype(np.float32)


def test_side_files_port_to_jax(tmp_path):
    smp.init({"fp16": True}, device="cpu")
    want_scaler = _scaler_state(state.loss_scaler)
    hist, scale = _quant_arrays(0)
    state.quant_state = QuantState()
    state.quant_state.amax_history, state.quant_state.scale = torch.from_numpy(hist), torch.from_numpy(scale)
    smp.DistributedModel(smp.nn.DistributedTransformerLMHead(**TINY), device="cpu")
    smp.save_checkpoint(str(tmp_path), tag="s")
    assert glob.glob(str(tmp_path / "s_partial" / "fp16_states_0_0_0.pt"))
    assert glob.glob(str(tmp_path / "s_partial" / "quant_states_0_0_0.pt"))
    jax_smp.init({"fp16": True})
    jax_smp.resume_from_checkpoint(str(tmp_path), tag="s")
    assert jax_state.loss_scaler.state_dict() == want_scaler
    jax_smp.reset()
    jax_smp.init({"matmul_precision": "fp8"})
    jax_smp.resume_from_checkpoint(str(tmp_path), tag="s")
    got = jax_state.quant_state.state_dict()
    np.testing.assert_array_equal(got["amax_history"], hist)
    np.testing.assert_array_equal(got["scale"], scale)


def test_side_files_jax_to_port(jax_run):
    want_scaler, hist, scale = jax_run["side"]
    smp.init({"fp16": True}, device="cpu")
    smp.resume_from_checkpoint(jax_run["root"], tag="p")
    assert state.loss_scaler.state_dict() == want_scaler
    smp.reset()
    smp.init({"matmul_precision": "fp8"}, device="cpu")
    smp.resume_from_checkpoint(jax_run["root"], tag="p")
    got = state.quant_state.state_dict()
    np.testing.assert_array_equal(got["amax_history"], hist)
    np.testing.assert_array_equal(got["scale"], scale)


# ----------------------------------------------------------------------
# Two ranks at context_parallel_degree 2
# ----------------------------------------------------------------------


def _cp_rank(rank, world, root):
    """Train 2 steps at cp = 2, save, train 2 more; resume into a model of
    another seed and train the same 2: (losses after the save, resumed
    losses, the files after the save)."""
    cfg = {"context_parallel_degree": world, "ddp": True, "microbatches": 1}
    smp.init(cfg, device="cpu")
    model, opt, train_step = _port_build("zoo")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 32)))
    _train(model, opt, train_step, ids, N)
    smp.save_checkpoint(root, tag="cp", user_content={"run": "cp"})
    files = sorted(os.listdir(os.path.join(root, "cp_partial")))
    want = _train(model, opt, train_step, ids, K)
    smp.reset()
    smp.init(cfg, device="cpu")
    user = smp.resume_from_checkpoint(root, tag="cp")
    model, opt, train_step = _port_build("zoo", seed=rank + 5)
    return want, _train(model, opt, train_step, ids, K), files, user


def test_two_rank_cp_checkpoint(tmp_path):
    results = run_ranks(2, _cp_rank, str(tmp_path), timeout=300)
    d = tmp_path / "cp_partial"
    assert {"model_shards_p0.npz", "model_shards_p1.npz", "optimizer_shards_p0.npz", "optimizer_shards_p1.npz",
            ".committed", ".done_p1", "smp_config.pt", "user_content.pt"} <= set(os.listdir(d))
    assert np.load(d / "model_shards_p0.npz").files and not np.load(d / "model_shards_p1.npz").files
    assert pickle.loads((d / "smp_config.pt").read_bytes())["num_processes"] == 2
    assert (tmp_path / "newest").read_text() == "cp"
    for want, got, files, user in results:
        assert got == want
        assert user == {"run": "cp"}
    assert results[0][0] == results[1][0]
