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
