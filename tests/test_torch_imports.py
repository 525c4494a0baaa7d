"""Import hygiene of the PyTorch port: src/repro_torch and chip_smoke.py
import neither ``jax`` nor the JAX package ``repro`` (only the tests import
both), and importing the serving CLI pulls no JAX into the process.  Every
tests/test_torch_*.py imports tests/_torch_parity.py, which gives torch one
intra-op thread per xdist worker on a machine without a card; the
subprocesses started here get ``OMP_NUM_THREADS=1`` for the same reason."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "prng.py", "ops.py", "sde.py", "service.py", "train.py",
            "discretise.py", "synthetic.py", "optimizers.py", "tree.py",
            "flash_attention.py", "layers.py", "transformer.py", "counting.py", "base.py",
            "qwen2_5_14b.py", "tinyllama_1_1b.py", "starcoder2_3b.py", "ssd_chunk.py",
            "mamba2_1_3b.py", "fused_mlp.py", "vjp.py", "xent.py", "elastic.py",
            "store.py", "continuous.py", "checkpoint.py", "adjoint.py"} <= names
    for src in ("flash_attention.cu", "ssd_chunk.cu", "fused_mlp.cu", "fused_xent.cu"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / src).exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _imports_leave_jax_unloaded(modules: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py"))


@pytest.mark.parametrize("path", TEST_FILES, ids=lambda p: p.name)
def test_port_test_file_imports_the_thread_helper(path):
    assert "_torch_parity" in set(_imported_modules(path)), (
        f"{path.name} does not import _torch_parity (one torch thread per xdist worker)")


def test_the_thread_helper_gives_torch_one_thread_without_a_card():
    import torch

    assert torch.cuda.is_available() or torch.get_num_threads() == 1


def test_serving_cli_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.launch.serve, repro_torch.kernels.build")


def test_train_cli_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.launch.train, repro_torch.core.gradients, "
                                "repro_torch.core.adjoint, repro_torch.data, "
                                "repro_torch.optim")


def test_adaptive_slice_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.core.solve, repro_torch.core.sde, "
                                "repro_torch.core.gradients.discretise, "
                                "repro_torch.serving.types, repro_torch.launch.steps")


def test_lm_slice_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.configs, repro_torch.models.transformer, "
                                "repro_torch.models.counting, "
                                "repro_torch.kernels.flash_attention")


def test_ssm_slice_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.configs.mamba2_1_3b, repro_torch.models.layers, "
                                "repro_torch.kernels.ssd_chunk, repro_torch.kernels.ops")


def test_field_slice_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.nn, repro_torch.kernels.fused_mlp, "
                                "repro_torch.kernels.vjp")


def test_lm_training_slice_import_leaves_jax_unloaded():
    _imports_leave_jax_unloaded("repro_torch.kernels.xent, repro_torch.distributed.elastic, "
                                "repro_torch.checkpoint.store, repro_torch.optim.optimizers, "
                                "repro_torch.data.synthetic, repro_torch.launch.train")


def test_zoo_slice_import_leaves_jax_unloaded():
    """The last LM families' modules exist and pull no JAX in: the three
    configs, the reversible stack, the MLA and cross-attention layers."""
    names = {p.name for p in PORT_FILES}
    assert {"minicpm3_4b.py", "pixtral_12b.py", "seamless_m4t_medium.py",
            "reversible.py"} <= names
    _imports_leave_jax_unloaded("repro_torch.configs.minicpm3_4b, repro_torch.configs.pixtral_12b, "
                                "repro_torch.configs.seamless_m4t_medium, "
                                "repro_torch.models.reversible, repro_torch.models.layers")
