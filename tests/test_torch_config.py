"""The port's ModelParallelConfig resolves configs as the JAX package's does.

The dicts are those of ``tests/test_config.py``: each must resolve to the
same values in both packages, or be refused by both.
"""

import json

import pytest
import torch

from smdistributed_modelparallel_tpu.backend.config import ModelParallelConfig as JaxConfig
from smdistributed_modelparallel_tpu.backend.schema import SCHEMA as JAX_SCHEMA
from smdistributed_modelparallel_tpu.utils.exceptions import ConfigError as JaxConfigError
from smdistributed_modelparallel_tpu_torch.backend.config import ModelParallelConfig
from smdistributed_modelparallel_tpu_torch.backend.schema import SCHEMA
from smdistributed_modelparallel_tpu_torch.utils.exceptions import ConfigError

ACCEPTED = [
    {},
    {"pipeline_parallel_degree": 4, "microbatches": 8},
    {"pipeline_parallel_degree": 4, "microbatches": 8, "active_microbatches": 3},
    {"pipeline_parallel_degree": 4, "microbatches": 4},
    {"partitions": 4, "microbatches": 4},
    {"tensor_parallel_degree": 2, "ddp": True},
    {"bf16": True},
    {"fp16": True},
    {"sharded_data_parallel_degree": 4, "ddp": True},
    {"auto_partition": False, "default_partition": 1, "pipeline_parallel_degree": 2, "microbatches": 2},
    {"ddp_dist_backend": "nccl", "ddp": True},
    {"ddp": 1},
    {"sdp_reduce_bucket_size": 5e8},
    {"microbatches": 4, "bf16": True, "fused_step_donation": True},
    {"pallas_attn_block_q": 128, "pallas_attn_block_k": 256},
]
REFUSED = [
    {"partitions": 2, "pipeline_parallel_degree": 2},
    {"no_such_key": 1},
    {"pipeline_parallel_degree": 0},
    {"pipeline_parallel_degree": "two"},
    {"memory_weight": 1.5},
    {"pipeline": "zigzag"},
    {"tensor_parallel_degree": 2},
    {"ddp": True, "horovod": True},
    {"bf16": True, "fp16": True},
    {"sharded_data_parallel_degree": 4, "pipeline_parallel_degree": 2, "microbatches": 2, "ddp": True},
    {"auto_partition": False},
    {"auto_partition": False, "default_partition": 3, "pipeline_parallel_degree": 2, "microbatches": 2},
    {"prescaled_batch": True, "optimize": "memory"},
    {"pallas_attn_block_q": 300},
]


def test_schema_is_a_copy_key_for_key():
    assert list(SCHEMA) == list(JAX_SCHEMA)
    for key, spec in JAX_SCHEMA.items():
        port = {k: v for k, v in SCHEMA[key].items() if k != "description"}
        assert port == {k: v for k, v in spec.items() if k != "description"}, key


@pytest.mark.parametrize("cfg", ACCEPTED, ids=[json.dumps(c) for c in ACCEPTED])
def test_resolves_like_jax(cfg):
    assert ModelParallelConfig(cfg).as_dict() == JaxConfig(cfg).as_dict()


@pytest.mark.parametrize("cfg", REFUSED, ids=[json.dumps(c) for c in REFUSED])
def test_refuses_like_jax(cfg):
    with pytest.raises(JaxConfigError):
        JaxConfig(cfg)
    with pytest.raises(ConfigError):
        ModelParallelConfig(cfg)


def test_half_dtype_is_a_torch_dtype():
    assert ModelParallelConfig({"bf16": True}).half_dtype is torch.bfloat16
    assert ModelParallelConfig({"fp16": True}).half_dtype is torch.float16
    assert ModelParallelConfig({}).half_dtype is None


@pytest.mark.parametrize("env", [
    {"SM_HP_MP_PARAMETERS": json.dumps({"partitions": 2, "microbatches": 4})},
    {"SMP_ZERO3": "1", "SM_HP_MP_PARAMETERS": json.dumps({"ddp": True})},
    {"SMP_RECOMPUTE": "full", "SMP_RECOMPUTE_BUDGET_MB": "512"},
    {"SMP_TP_OVERLAP": "off", "SMP_MATMUL_PRECISION": "bf16"},
])
def test_environment_injection_like_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ModelParallelConfig().as_dict() == JaxConfig().as_dict()


DEGREE_REFUSED = [
    {"context_parallel_degree": 2},
    {"expert_parallel_degree": 2},
    {"tensor_parallel_degree": 2, "ddp": True},
]


@pytest.mark.parametrize("cfg", DEGREE_REFUSED, ids=[json.dumps(c) for c in DEGREE_REFUSED])
def test_degree_check_refuses_like_jax(cfg):
    """At one device both packages refuse, at smp.init, degrees whose
    product does not divide the device count, with the same error."""
    import smdistributed_modelparallel_tpu as jax_smp
    import smdistributed_modelparallel_tpu_torch as smp_torch
    from smdistributed_modelparallel_tpu.utils.exceptions import DeviceCountError as JaxDeviceCountError
    from smdistributed_modelparallel_tpu_torch.utils.exceptions import DeviceCountError

    try:
        with pytest.raises(JaxDeviceCountError) as want:
            jax_smp.init({**cfg, "_device_count_override": 1})
        with pytest.raises(DeviceCountError) as got:
            smp_torch.init(cfg)
        assert str(got.value) == str(want.value)
        # The override shrinks the port's count as it does the JAX mesh.
        with pytest.raises(DeviceCountError):
            smp_torch.init({**cfg, "_device_count_override": 1})
    finally:
        jax_smp.reset()
        smp_torch.reset()


def test_device_count_override_may_not_exceed_the_devices():
    """Neither package builds a topology over more devices than it has."""
    import jax

    import smdistributed_modelparallel_tpu as jax_smp
    import smdistributed_modelparallel_tpu_torch as smp_torch

    try:
        with pytest.raises(ValueError):
            jax_smp.init({"_device_count_override": 2 * len(jax.devices())})
        with pytest.raises(ValueError, match="exceeds"):
            smp_torch.init({"_device_count_override": 2})
        smp_torch.init({"_device_count_override": 1})
        assert smp_torch.size() == 1 and smp_torch.cp_size() == 1 and smp_torch.get_cp_group() == [0]
    finally:
        jax_smp.reset()
        smp_torch.reset()


TOPOLOGIES = [
    {"context_parallel_degree": 2, "ddp": True},
    {"context_parallel_degree": 4, "tensor_parallel_degree": 2, "ddp": True},
    {"context_parallel_degree": 2, "pipeline_parallel_degree": 2, "microbatches": 2, "ddp": True,
     "placement_strategy": "spread"},
    {"expert_parallel_degree": 2, "context_parallel_degree": 2, "ddp": True},
]


@pytest.mark.parametrize("cfg", TOPOLOGIES, ids=[json.dumps(c) for c in TOPOLOGIES])
def test_topology_coords_and_cp_groups_match_jax(cfg):
    """Over 8 devices the port's rank grid gives every rank the JAX mesh's
    coordinates and cp group."""
    from smdistributed_modelparallel_tpu.backend.topology import DeviceTopology as JaxTopology
    from smdistributed_modelparallel_tpu_torch.backend.topology import DeviceTopology

    want = JaxTopology(JaxConfig(cfg))
    got = DeviceTopology(ModelParallelConfig(cfg), 8)
    assert got.axis_names == want.axis_names and got.axis_sizes == want.axis_sizes
    for r in range(8):
        assert got.coords(r) == want.coords(r)
        assert got.axis_group(r, "cp") == want.axis_group(r, "cp")
    assert sorted(r for g in got.axis_groups("cp") for r in g) == list(range(8))
