"""The port's input pipeline (``smp.shard_batches``, ``smp.prefetch_to_device``,
``smp.dataloader``) on the cases of ``tests/test_data.py``.

On the CPU (``smp.init(device="cpu")``): a single rank's batches pass
through ``shard_batches`` as the JAX package's do; with a data-parallel
degree of 2 (a stand-in topology) the rank at coordinate 1 keeps the rows
the JAX package's process 1 of 2 keeps, scalar leaves untouched; prefetched
batches arrive as tensors on the device with the source's values; source
errors re-raise at the consumption point and stay; an exhausted iterator
keeps raising StopIteration; ``close()`` stops the fill thread; and training
through ``smp.dataloader`` gives the losses of the same batches fed
directly, bit for bit. The CUDA staging (pinned copies on a side stream) is
held on the card (``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax

import smdistributed_modelparallel_tpu as jax_smp
import smdistributed_modelparallel_tpu_torch as smp
from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.nn.cross_entropy import vocab_parallel_cross_entropy
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError


@pytest.fixture(autouse=True)
def _reset():
    yield
    smp.reset()
    jax_smp.reset()


def _batches(n, B=8, T=16, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield {"ids": rng.randint(0, 64, (B, T)), "w": rng.rand(B).astype("f4")}


def _init(cfg=None):
    smp.reset()
    smp.init(cfg or {"microbatches": 1}, device="cpu")


class _Rdp2:
    """A topology stand-in: data-parallel degree 2, this rank at rdp 1 (ep 1:
    ``shard_batches`` cuts by the row coordinate over rdp x ep)."""

    rdp_size = 2
    ep_size = 1

    def coords(self, rank):
        return {"rdp": 1, "cp": 0, "ep": 0, "pp": 0, "tp": 0}


class TestShardBatches:
    def test_single_process_passthrough(self):
        _init()
        out = list(smp.shard_batches(_batches(3)))
        jax_smp.init({"microbatches": 1})
        ref = list(jax_smp.shard_batches(_batches(3)))
        assert len(out) == 3
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a["ids"], b["ids"])
            np.testing.assert_array_equal(a["w"], b["w"])

    def test_data_parallel_slice_matches_jax_process_slice(self, monkeypatch):
        _init()
        monkeypatch.setattr(state, "topology", _Rdp2())
        batches = [{"ids": np.arange(32).reshape(8, 4), "epoch": 3, "t": torch.arange(16).reshape(8, 2)}]
        out = list(smp.shard_batches(iter(batches)))
        jax_smp.init({"microbatches": 1})
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda: 1)
        ref = list(jax_smp.shard_batches(iter([{"ids": np.arange(32).reshape(8, 4), "epoch": 3}])))
        assert out[0]["epoch"] == ref[0]["epoch"] == 3
        np.testing.assert_array_equal(out[0]["ids"], ref[0]["ids"])
        assert torch.equal(out[0]["t"], torch.arange(16).reshape(8, 2)[4:])

    def test_indivisible_batch_raises(self, monkeypatch):
        _init()
        monkeypatch.setattr(state, "topology", _Rdp2())
        with pytest.raises(SMPValidationError, match="divisible"):
            list(smp.shard_batches(iter([{"ids": np.zeros((3, 4))}])))


class TestPrefetch:
    def test_batches_arrive_on_the_device(self):
        _init()
        seen = list(smp.prefetch_to_device(_batches(4), size=2))
        assert len(seen) == 4
        ref = list(_batches(4))
        for got, want in zip(seen, ref):
            assert isinstance(got["ids"], torch.Tensor) and got["ids"].device == torch.device("cpu")
            np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])
            np.testing.assert_array_equal(got["w"].numpy(), want["w"])

    def test_nested_trees_and_scalars(self):
        _init()
        src = [([np.ones((2, 3)), torch.zeros(2)], {"k": (np.arange(4), "tag", 7)})]
        (got,) = list(smp.prefetch_to_device(iter(src)))
        assert isinstance(got, tuple) and isinstance(got[0], list) and isinstance(got[1]["k"], tuple)
        assert torch.equal(got[0][0], torch.ones(2, 3, dtype=torch.float64))
        assert torch.equal(got[1]["k"][0], torch.arange(4))
        assert got[1]["k"][1:] == ("tag", 7)

    def test_source_errors_reraise_at_consumption(self):
        _init()

        def bad():
            yield {"ids": np.zeros((4, 8), np.int32)}
            raise ValueError("source broke")

        it = smp.prefetch_to_device(bad(), size=2)
        next(it)
        with pytest.raises(ValueError, match="source broke"):
            next(it)

    def test_requires_init(self):
        smp.reset()
        with pytest.raises(SMPValidationError):
            smp.prefetch_to_device(_batches(1))

    def test_size_must_be_positive(self):
        _init()
        with pytest.raises(SMPValidationError, match=">= 1"):
            smp.prefetch_to_device(_batches(1), size=0)

    def test_trains_through_step_engine(self):
        """Training through ``smp.dataloader`` gives, bit for bit, the
        losses of the same batches fed directly."""
        tiny = dict(num_layers=2, num_attention_heads=2, attention_head_size=8, hidden_size=16,
                    intermediate_size=32, vocab_size=64, num_positions=16, causal_mask_size=16,
                    pre_layernorm=True, post_layernorm=False, final_layernorm=True, attention_dropout_prob=0.0,
                    hidden_dropout_prob=0.0, embedding_dropout_prob=0.0)

        def run(make_feed):
            _init({"microbatches": 2})
            torch.manual_seed(0)
            model = smp.DistributedModel(smp.nn.DistributedTransformerLMHead(**tiny), device="cpu")
            opt = smp.DistributedOptimizer(torch.optim.Adam(model.parameters(), lr=1e-2), model)

            @smp.step
            def train_step(model, ids):
                logits = model(ids)
                loss = vocab_parallel_cross_entropy(logits[:, :-1], ids[:, 1:]).mean()
                model.backward(loss)
                return loss

            losses = []
            for batch in make_feed():
                out = train_step(model, torch.as_tensor(batch["ids"]))
                opt.step()
                losses.append(float(out.reduce_mean()))
            return losses

        direct = run(lambda: _batches(4, B=8, T=16))
        piped = run(lambda: smp.dataloader(_batches(4, B=8, T=16), size=2))
        assert len(piped) == 4 and all(np.isfinite(piped))
        assert piped == direct


class TestPrefetchLifecycle:
    def test_exhausted_iterator_keeps_raising_stopiteration(self):
        _init()
        it = smp.prefetch_to_device(_batches(2), size=2)
        assert len(list(it)) == 2
        with pytest.raises(StopIteration):
            next(it)
        with pytest.raises(StopIteration):
            next(it)

    def test_error_is_sticky(self):
        _init()

        def bad():
            raise ValueError("broken source")
            yield  # pragma: no cover

        it = smp.prefetch_to_device(bad(), size=1)
        for _ in range(2):
            with pytest.raises(ValueError, match="broken source"):
                next(it)

    def test_close_stops_fill_thread(self):
        _init()
        with smp.prefetch_to_device(_batches(100), size=2) as it:
            next(it)
        assert not it._thread.is_alive()
        with pytest.raises(StopIteration):
            next(it)

    def test_cuda_device_is_never_moved_to_the_cpu(self, monkeypatch):
        """With no device named and no CUDA, prefetch raises instead of
        staging on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        smp.reset()
        smp.init({"microbatches": 1})
        with pytest.raises(smp.SMPRuntimeError, match="CUDA is not available"):
            smp.prefetch_to_device(_batches(1))
