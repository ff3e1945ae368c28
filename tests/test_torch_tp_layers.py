"""The port's tensor-parallel regions and ``smp.nn`` layers at tp = 2.

Two CPU processes over gloo. First the Megatron regions of
``backend/collectives.py`` against their definitions (each rank's input
drawn from its own seed): copy-to-tp (identity forward, all-reduce
backward), reduce-from-tp (all-reduce forward, identity backward; with
``sum_grad`` an all-reduce backward too), the all-gather along T (backward a
reduce-scatter, or this rank's chunk with ``split_grad``; uneven parts), the
reduce-scatter along T (backward an all-gather) and the scatter (backward an
all-gather); bf16 through gloo keeps its dtype and sums as fp32 rounded
once. Then each layer against the JAX package's at tp = 2 on a 2-device CPU
mesh (``tests/test_nn_layers.py``'s oracles), from the same weights (each
rank keeps its part of the whole tensors), outputs and the gradients of the
weights and the input within 1e-5: ``DistributedLinear`` (whole and
sharded input), the ``ColumnParallelLinear`` -> ``RowParallelLinear`` pair,
``DistributedEmbedding`` split by vocab (V = 63: a shorter last shard) and by
dim (lookup and ``attend``), ``DistributedLayerNorm(sharded=True)``, and the
MLP (``DistributedTransformerOutputLayer``) with ``fused_bias_gelu`` on the
rank's [.., F/2] block (the ``_is_cuda`` seam sends the CPU tensors down the
kernel's branch, its plain version; the JAX side's Pallas kernel in
interpret mode).
"""

import numpy as np
import pytest
import torch

from chip_smoke import run_ranks

# The JAX side is imported where it runs: the spawned ranks import this
# module, and need torch alone.

B, T, D = 2, 8, 16


def _jax_layers():
    """{case: (params as numpy, inputs, cotangent, output, grads of params,
    grad of the input)} of the JAX layers at tp = 2."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    import smdistributed_modelparallel_tpu as jax_smp
    from smdistributed_modelparallel_tpu.backend.state import state as jax_state

    from smdistributed_modelparallel_tpu import nn as jnn
    from smdistributed_modelparallel_tpu.nn import transformer as jax_tr
    from smdistributed_modelparallel_tpu.ops import pallas_gelu

    class Pair(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jnn.RowParallelLinear(16, name="row")(jnn.ColumnParallelLinear(64, name="col")(x))

    class Attend(fnn.Module):
        split: str

        def setup(self):
            self.emb = jnn.DistributedEmbedding(63 if self.split == "vocab" else 64, D, split=self.split)

        def __call__(self, ids, x):
            return self.emb(ids), self.emb.attend(x)

    x = jax.random.normal(jax.random.key(0), (B, T, D))
    x32 = jax.random.normal(jax.random.key(3), (B, T, 32))
    ids = jax.random.randint(jax.random.key(4), (B, T), 0, 63)
    cases = {
        "linear": (jnn.DistributedLinear(32), (x,)),
        "pair": (Pair(), (x,)),
        "embed_vocab": (Attend("vocab"), (ids, x)),
        "embed_dim": (Attend("dim"), (ids, x)),
        "layernorm": (jnn.DistributedLayerNorm(sharded=True), (x32,)),
        "mlp": (jax_tr.DistributedTransformerOutputLayer(D, 64, hidden_dropout_prob=0.0, fused_bias_gelu=True,
                                                          deterministic=True), (x,)),
    }
    out = {}
    old = pallas_gelu.FORCE_INTERPRET
    pallas_gelu.FORCE_INTERPRET = True
    try:
        jax_smp.reset()
        jax_smp.init({"tensor_parallel_degree": 2, "ddp": True, "_device_count_override": 2, "microbatches": 1,
                      "use_pallas_kernels": True})
        for i, (name, (module, args)) in enumerate(cases.items()):
            params = meta.unbox(module.init(jax.random.key(10 + i), *args)["params"])
            if name == "mlp":  # nonzero biases, so their gradients and the epilogue's add show
                params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.ones_like(p) if p.ndim == 1 else p, params)
            d = 1 if name.startswith("embed") else 0  # the float input differentiated
            with jax.set_mesh(jax_state.mesh):
                y, vjp = jax.vjp(lambda p, a: module.apply({"params": p}, *args[:d], a, *args[d + 1:]), params,
                                 args[d])
                cot = jax.tree_util.tree_map(lambda t: jax.random.normal(jax.random.key(99), t.shape), y)
                dp, dx = vjp(cot)
            flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)  # noqa: E731
                                 for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
            out[name] = (flat(params), [np.asarray(a) for a in args], jax.tree_util.tree_map(np.asarray, cot),
                         jax.tree_util.tree_map(np.asarray, y), flat(dp), np.asarray(dx))
        out["linear_local"] = out["linear"]  # the same layer, fed this rank's block of the input
    finally:
        pallas_gelu.FORCE_INTERPRET = old
        jax_smp.reset()
    return out


def _regions(rank, smp):
    """Each region's forward and backward on this rank's inputs."""
    from smdistributed_modelparallel_tpu_torch.backend import collectives as C
    from smdistributed_modelparallel_tpu_torch.nn.utils import tp_group

    g = tp_group()
    out = {}
    for name, fn in (
            ("copy", lambda x: C.copy_to_tp(x, g)),
            ("reduce", lambda x: C.reduce_from_tp(x, g)),
            ("reduce_sum_grad", lambda x: C.reduce_from_tp(x, g, sum_grad=True)),
            ("gather", lambda x: C.gather_from_tp(x, g, 1)),
            ("gather_split", lambda x: C.gather_from_tp(x, g, 1, split_grad=True)),
            ("gather_uneven", lambda x: C.gather_from_tp(x[:, :3 - rank], g, 1, sizes=[3, 2])),
            ("reduce_scatter", lambda x: C.reduce_scatter_to_tp(x, g, 1)),
            ("scatter", lambda x: C.scatter_to_tp(x, g, 1))):
        gen = torch.Generator().manual_seed(100 * rank)
        x = torch.randn(2, 4, 3, generator=gen, requires_grad=True)
        y = fn(x)
        cot = torch.randn(y.shape, generator=gen)
        (y * cot).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    half = torch.full((4,), 1.0 + rank * 3 * 2.0 ** -7, dtype=torch.bfloat16)
    out["bf16"] = C.reduce_from_tp(half, g)
    return out


def _port_layer(name, smp):
    from smdistributed_modelparallel_tpu_torch.nn import (
        ColumnParallelLinear,
        DistributedEmbedding,
        DistributedLayerNorm,
        DistributedLinear,
        RowParallelLinear,
    )
    from smdistributed_modelparallel_tpu_torch.nn.transformer import DistributedTransformerOutputLayer

    if name.startswith("linear"):
        return DistributedLinear(D, 32)
    if name == "pair":
        return torch.nn.Sequential(ColumnParallelLinear(D, 64), RowParallelLinear(64, 16))
    if name.startswith("embed"):
        split = name.split("_")[1]
        return DistributedEmbedding(63 if split == "vocab" else 64, D, split=split)
    if name == "layernorm":
        return DistributedLayerNorm(32, sharded=True)
    return DistributedTransformerOutputLayer(D, 64, hidden_dropout_prob=0.0, fused_bias_gelu=True,
                                             deterministic=True)


# The port's parameter name of each JAX leaf, and whether the kernel is
# transposed (flax [in, out] against torch [out, in]).
_NAMES = {
    "linear": {"kernel": ("weight", True), "bias": ("bias", False)},
    "linear_local": {"kernel": ("weight", True), "bias": ("bias", False)},
    "pair": {"col/kernel": ("0.weight", True), "col/bias": ("0.bias", False), "row/kernel": ("1.weight", True),
             "row/bias": ("1.bias", False)},
    "embed_vocab": {"emb/embedding": ("weight", False)},
    "embed_dim": {"emb/embedding": ("weight", False)},
    "layernorm": {"scale": ("weight", False), "bias": ("bias", False)},
    "mlp": {"fc/kernel": ("fc.weight", True), "fc/bias": ("fc.bias", False), "proj/kernel": ("proj.weight", True),
            "proj/bias": ("proj.bias", False)},
}


def _layers(rank, smp, want):
    """Each layer's (output, {name: whole weight gradient}, input gradient)
    on this rank, gathered whole over tp."""
    from smdistributed_modelparallel_tpu_torch.backend.collectives import gather_from_tp
    from smdistributed_modelparallel_tpu_torch.nn.utils import tp_group, tp_param_specs, tp_rank
    from smdistributed_modelparallel_tpu_torch.ops import bias_gelu as bg

    bg._is_cuda = lambda t: True  # the kernel's branch, its plain version on the CPU
    g = tp_group()
    out = {}
    for name, (params, args, cot, _, _, _) in want.items():
        torch.manual_seed(0)
        layer = _port_layer(name, smp)
        specs = tp_param_specs(layer)
        own = dict(layer.named_parameters())
        with torch.no_grad():
            for key, (pname, transpose) in _NAMES[name].items():
                full = torch.from_numpy(params[key])
                full = full.t() if transpose else full
                spec = specs.get(pname)
                own[pname].copy_(spec.local(full, tp_rank(), 2) if spec is not None else full)
        args = [torch.from_numpy(a) for a in args]
        if name == "layernorm":  # the input is this rank's block of the hidden axis
            x = args[0].chunk(2, dim=-1)[rank].clone().requires_grad_()
            y = gather_from_tp(layer(x), g, -1, split_grad=True)
        elif name == "linear_local":
            x = args[0].chunk(2, dim=-1)[rank].clone().requires_grad_()
            y = layer(x)
        elif name.startswith("embed"):
            x = args[1].clone().requires_grad_()
            y = (layer(args[0].long()), layer.gather_logits(layer.attend(x)))
        else:
            x = args[0].clone().requires_grad_()
            y = layer(x)
        ys = y if isinstance(y, tuple) else (y,)
        cots = cot if isinstance(cot, (tuple, list)) else (cot,)
        sum((yi * torch.from_numpy(np.asarray(ci))).sum() for yi, ci in zip(ys, cots)).backward()
        grads = {pname: (specs[pname].gather(own[pname].grad, g) if pname in specs else own[pname].grad).numpy()
                 for pname, _ in _NAMES[name].values()}
        dx = x.grad
        if name in ("layernorm", "linear_local"):
            dx = gather_from_tp(dx, g, -1)
        out[name] = ([yi.detach().numpy() for yi in ys], grads, dx.numpy())
    return out


def _worker(rank, world, want):
    import smdistributed_modelparallel_tpu_torch as smp

    torch.set_num_threads(1)
    smp.init({"tensor_parallel_degree": 2, "ddp": True}, device="cpu")
    try:
        return {"regions": _regions(rank, smp), "layers": _layers(rank, smp, want)}
    finally:
        smp.reset()


@pytest.fixture(scope="module")
def runs():
    want = _jax_layers()
    return want, run_ranks(2, _worker, want)


def _inputs(rank):
    gen = torch.Generator().manual_seed(100 * rank)
    x = torch.randn(2, 4, 3, generator=gen)
    return x.numpy(), None, gen


def _cot(rank, shape):
    gen = torch.Generator().manual_seed(100 * rank)
    torch.randn(2, 4, 3, generator=gen)
    return torch.randn(shape, generator=gen).numpy()


def test_regions_forward_and_backward(runs):
    _, per_rank = runs
    xs = [_inputs(r)[0] for r in range(2)]
    got = [r["regions"] for r in per_rank]
    total = xs[0] + xs[1]
    for r in range(2):
        y, dx = got[r]["copy"]
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_allclose(dx, _cot(0, y.shape) + _cot(1, y.shape), rtol=1e-6)
        for name in ("reduce", "reduce_sum_grad"):
            y, dx = got[r][name]
            np.testing.assert_allclose(y, total, rtol=1e-6)
            want = _cot(r, y.shape) if name == "reduce" else _cot(0, y.shape) + _cot(1, y.shape)
            np.testing.assert_allclose(dx, want, rtol=1e-6)
        y, dx = got[r]["gather"]
        np.testing.assert_array_equal(y, np.concatenate(xs, axis=1))
        full = _cot(0, y.shape) + _cot(1, y.shape)
        np.testing.assert_allclose(dx, full[:, 4 * r:4 * (r + 1)], rtol=1e-6)
        y, dx = got[r]["gather_split"]
        np.testing.assert_allclose(dx, _cot(r, y.shape)[:, 4 * r:4 * (r + 1)], rtol=1e-6)
        y, dx = got[r]["gather_uneven"]
        np.testing.assert_array_equal(y, np.concatenate([xs[0][:, :3], xs[1][:, :2]], axis=1))
        full = _cot(0, y.shape) + _cot(1, y.shape)
        want = np.zeros_like(xs[r])
        want[:, :3 - r] = full[:, :3] if r == 0 else full[:, 3:]
        np.testing.assert_allclose(dx, want, rtol=1e-6)
        y, dx = got[r]["reduce_scatter"]
        np.testing.assert_allclose(y, total[:, 2 * r:2 * (r + 1)], rtol=1e-6)
        np.testing.assert_allclose(dx, np.concatenate([_cot(0, y.shape), _cot(1, y.shape)], axis=1), rtol=1e-6)
        y, dx = got[r]["scatter"]
        np.testing.assert_array_equal(y, xs[r][:, 2 * r:2 * (r + 1)])
        want = np.concatenate([_cot(0, y.shape), _cot(1, y.shape)], axis=1)
        np.testing.assert_allclose(dx, want, rtol=1e-6)
        half = got[r]["bf16"]
        assert half.dtype == torch.bfloat16
        # 2 + 1.5 ulp of bf16: the fp32 sum rounded once (to even).
        assert half.float().tolist() == [float(torch.tensor(2.0 + 3 * 2.0 ** -7).bfloat16())] * 4 == [2.03125] * 4


@pytest.mark.parametrize("name", ["linear", "linear_local", "pair", "embed_vocab", "embed_dim", "layernorm", "mlp"])
def test_layer_matches_jax(runs, name):
    want, per_rank = runs
    _, _, _, y, dparams, dx = want[name]
    ys = y if isinstance(y, (tuple, list)) else (y,)
    for r in per_rank:
        got_y, got_grads, got_dx = r["layers"][name]
        for a, b in zip(got_y, ys):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        for key, (pname, transpose) in _NAMES[name].items():
            w = dparams[key].T if transpose else dparams[key]
            np.testing.assert_allclose(got_grads[pname], w, rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got_dx, dx, rtol=0, atol=1e-5)
