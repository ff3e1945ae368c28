"""The port's pipeline schedule builders against the JAX package's.

``parallel/pipeline_1f1b.py``'s schedule half is the port's own copy (it
imports nothing of the JAX package). On a grid of S in {2, 3, 4} stages,
M in {1, 2, 4, 8} microbatches, windows W in {1, 2, S + 1} and virtual
degrees V in {1, 2}: every builder gives the JAX package's arrays, array for
array; each grid passes ``tests/schedule_checker.check_schedule``; where the
JAX builder raises, the port raises the same class; the occupancy, the phase
bounds and the theoretical bubble are equal too.
"""

import itertools

import numpy as np
import pytest

from smdistributed_modelparallel_tpu.parallel import pipeline_1f1b as jax_sched
from smdistributed_modelparallel_tpu_torch.parallel import pipeline_1f1b as port_sched
from tests.schedule_checker import check_schedule

GRID = [(S, M, W, V) for S, M, V in itertools.product((2, 3, 4), (1, 2, 4, 8), (1, 2)) for W in (1, 2, S + 1)]


def _both(name, *args):
    """(JAX result or exception class, port result or exception class)."""
    out = []
    for mod in (jax_sched, port_sched):
        try:
            out.append(getattr(mod, name)(*args))
        except Exception as e:  # the classes are compared
            out.append(type(e))
    return out


def _same(a, b):
    if isinstance(a, type):
        assert isinstance(b, type) and a.__name__ == b.__name__ == "PartitionError"
        return False
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    return True


@pytest.mark.parametrize("S,M,W,V", GRID, ids=[f"S{S}-M{M}-W{W}-V{V}" for S, M, W, V in GRID])
def test_builders_match_jax_and_pass_the_checker(S, M, W, V):
    if V == 1:
        want, got = _both("build_1f1b_schedule", S, M, W)
        if _same(want, got):
            check_schedule(S, M, *got, window=W)
            assert port_sched.schedule_occupancy(*got) == jax_sched.schedule_occupancy(*want)
    want, got = _both("build_interleaved_1f1b_schedule", S, M, W, V)
    if _same(want, got):
        fk, fm, bk, bm = got
        check_schedule(S, M, fm, bm, fwd_chunk=fk, bwd_chunk=bk, virtual=V, window=W)
        assert port_sched.interleaved_phase_bounds(fm, bm) == jax_sched.interleaved_phase_bounds(fm, bm)
        if V == 1:
            # At v = 1 the interleaved builder is the plain one.
            f, b = port_sched.build_1f1b_schedule(S, M, W)
            assert np.array_equal(fm, f) and np.array_equal(bm, b)
    want, got = _both("build_zero_bubble_schedule", S, M, W, V)
    if _same(want, got):
        fk, fm, bk, bm, wk, wm = got
        check_schedule(S, M, fm, bm, fwd_chunk=fk, bwd_chunk=bk, wgt_mb=wm, wgt_chunk=wk, virtual=V, window=W)
        assert port_sched.zero_bubble_phase_bounds(fm, bm, wm) == jax_sched.zero_bubble_phase_bounds(fm, bm, wm)
        occ = dict(wgt=wm)
        assert port_sched.schedule_occupancy(fm, bm, **occ) == jax_sched.schedule_occupancy(fm, bm, **occ)
    assert port_sched.zero_bubble_theoretical_bubble(S, M, V) == jax_sched.zero_bubble_theoretical_bubble(S, M, V)


@pytest.mark.parametrize("args", [(2, 4, 0), (3, 2, -1)])
def test_bad_window_raises_partition_error_in_both(args):
    want, got = _both("build_1f1b_schedule", *args)
    assert want.__name__ == got.__name__ == "PartitionError"
    want, got = _both("build_interleaved_1f1b_schedule", *args, 1)
    assert want.__name__ == got.__name__ == "PartitionError"
    want, got = _both("build_interleaved_1f1b_schedule", args[0], args[1], 2, 0)
    assert want.__name__ == got.__name__ == "PartitionError"


def test_default_grid_bubble():
    """GPT-2's card configuration: S 2, M 4, the default window min(pp + 2,
    M) = 4: 16 busy sub-slots of 24, theoretical (pp - 1)/(M + pp - 1) 0.2."""
    from smdistributed_modelparallel_tpu_torch.utils.telemetry import record_pipeline_occupancy

    fwd, bwd = port_sched.build_1f1b_schedule(2, 4, 4)
    assert port_sched.schedule_occupancy(fwd, bwd) == (16, 24)
    assert record_pipeline_occupancy("1f1b", 2, 4, busy_slots=16, total_slots=24) == pytest.approx(1 / 3)
