"""The port stands alone: no import of JAX, flax or the JAX package, and its
config tree matches the JAX package's key for key."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nmrf_tpu")


def _port_files():
    # with the bodies of the CPU tests' spawned processes, which run the
    # port alone
    return sorted((ROOT / "nmrf_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_spatial_workers.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, nmrf_tpu_torch, nmrf_tpu_torch.models, "
            "nmrf_tpu_torch.ops, nmrf_tpu_torch.utils.convert, "
            "nmrf_tpu_torch.solver, nmrf_tpu_torch.data, "
            "nmrf_tpu_torch.ops.msda, nmrf_tpu_torch.models.swin, "
            "nmrf_tpu_torch.models.adaptor, nmrf_tpu_torch.parallel, "
            "nmrf_tpu_torch.parallel.mesh, nmrf_tpu_torch.parallel.spatial; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'nmrf_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_config_tree_matches_jax_package():
    from nmrf_tpu.config import get_cfg as get_cfg_jax
    from nmrf_tpu_torch.config import get_cfg

    assert get_cfg().to_dict() == get_cfg_jax().to_dict()
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "kitti_mix_train.yaml"))
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.BASE_LR", "2e-4"])
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.SOLVER.BASE_LR == 2e-4
