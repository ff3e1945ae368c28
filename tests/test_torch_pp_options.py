"""The port's pipeline step against the JAX package's, with its options:
``active_microbatches`` 1 and 2 (the 1F1B window), five layers over two
stages (the cost model's uneven 2/3 split) and ``grad_clip_norm`` (the
global norm summed over the stages, each replicated parameter counted once).
Same model, data, bounds and harness as ``tests/test_torch_pp_step.py``.
"""

import pytest

from tests.test_torch_pp_step import as_tuple, case, check_against, ranks_of, run_all

CASES = {
    "window1": case({"pipeline_parallel_degree": 2, "active_microbatches": 1}),
    "window2": case({"pipeline_parallel_degree": 2, "active_microbatches": 2}),
    "uneven": case({"pipeline_parallel_degree": 2}, layers=5),
    "clip": case({"pipeline_parallel_degree": 2}, clip=0.5),
}


@pytest.fixture(scope="module")
def runs():
    return run_all(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_pp_options_match_jax(runs, name):
    want, per_rank, _ = runs
    check_against(ranks_of(per_rank, name, CASES), want[name], name, CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_pp_options_match_pp1(runs, name):
    _, per_rank, base = runs
    check_against(ranks_of(per_rank, name, CASES), as_tuple(base[name]), name, CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_pp_options_gauges_and_bits(runs, name):
    want, per_rank, _ = runs
    ranks = ranks_of(per_rank, name, CASES)
    for r in ranks:
        assert r[name]["gauges"] == want[name][4] and want[name][4]
        assert r[name]["prints"] == ranks[0][name]["prints"]


def test_uneven_split(runs):
    """The cost model's split of five equal layers (the JAX package's:
    ``tests/test_torch_pipeline_partition.py``); each stage holds its own."""
    _, per_rank, _ = runs
    stages = [sorted({int(n.split(".")[1]) for n in r["uneven"]["layers"]}) for r in per_rank[2]]
    assert stages == [[0, 1], [2, 3, 4]]


def test_window_bounds_transfers(runs):
    """Every microbatch crosses the stage boundary once each way, whatever
    the window."""
    _, per_rank, _ = runs
    for name in CASES:
        assert [r[name]["transfers"] for r in per_rank[2]] == [4, 4]
