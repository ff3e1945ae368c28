"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points never move to the CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import smdistributed_modelparallel_tpu_torch as smp_torch
from smdistributed_modelparallel_tpu_torch.model import resolve_device
from smdistributed_modelparallel_tpu_torch.models.transformer_lm import TransformerLM
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPRuntimeError

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "smdistributed_modelparallel_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smdistributed_modelparallel_tpu")


@pytest.fixture(autouse=True)
def _reset_port():
    yield
    smp_torch.reset()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted([*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, smdistributed_modelparallel_tpu_torch as smp\n"
        "import smdistributed_modelparallel_tpu_torch.convert\n"
        "from smdistributed_modelparallel_tpu_torch.models import gpt2\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_distributed_model_defaults_to_cuda(monkeypatch):
    """device=None means cuda; without CUDA that is an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    smp_torch.init({})
    module = TransformerLM(vocab_size=11, max_len=8, d_model=8, n_layers=1, n_heads=2)
    with pytest.raises(SMPRuntimeError, match="CUDA is not available"):
        smp_torch.DistributedModel(module)
    with pytest.raises(SMPRuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert smp_torch.DistributedModel(module, device="cpu").device == torch.device("cpu")
    smp_torch.init({}, device="cpu")
    assert smp_torch.DistributedModel(module).device == torch.device("cpu")


def test_distributed_model_needs_init():
    from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPValidationError

    module = TransformerLM(vocab_size=11, max_len=8, d_model=8, n_layers=1, n_heads=2)
    with pytest.raises(SMPValidationError, match="smp.init"):
        smp_torch.DistributedModel(module, device="cpu")


def test_no_kernel_is_built_on_import():
    from smdistributed_modelparallel_tpu_torch.ops import flash_attention as fa

    assert fa._LIB is None  # loaded at the first CUDA launch only
