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


def test_entry_point_imports_leave_pil_tensorboard_jax_unloaded():
    """The CLI and its data, evaluation and checkpoint modules import PIL,
    OpenCV and tensorboard only where they are used (a real dataset's
    reader, the photometric kernel's plain version, the event writer)."""
    code = ("import sys, nmrf_tpu_torch.train, nmrf_tpu_torch.data, "
            "nmrf_tpu_torch.evalx, nmrf_tpu_torch.utils.checkpoint, "
            "nmrf_tpu_torch.tools.convergence_gate, "
            "nmrf_tpu_torch.tools.determinism_probe; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'nmrf_tpu', 'PIL', 'cv2', 'tensorboard', "
            "'tensorflow')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_serving_imports_leave_matplotlib_pil_cv2_jax_unloaded():
    """The CLI, the export and the server import matplotlib, PIL and
    OpenCV only where they are used (the renderer, the image readers and
    the KITTI writer), so the KITTI-submission mode and the server run
    without them."""
    code = ("import sys, nmrf_tpu_torch.inference, "
            "nmrf_tpu_torch.utils.export, nmrf_tpu_torch.tools.serve_http, "
            "nmrf_tpu_torch.tools.export_serving, "
            "nmrf_tpu_torch.utils.visualization, nmrf_tpu_torch.ops.library; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'nmrf_tpu', 'matplotlib', 'PIL', 'cv2')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_measurement_imports_leave_pil_tensorboard_jax_unloaded():
    """The bench, the training bench and the tools of the measurement
    entry points import no JAX, and PIL, OpenCV, matplotlib and
    tensorboard only where they are used."""
    code = ("import sys, nmrf_tpu_torch.bench, nmrf_tpu_torch.bench_train, "
            "nmrf_tpu_torch.utils.benchmarks, nmrf_tpu_torch.tools.flops, "
            "nmrf_tpu_torch.tools.profile_model, "
            "nmrf_tpu_torch.tools.profile_train, "
            "nmrf_tpu_torch.tools.bench_stages, "
            "nmrf_tpu_torch.tools.bench_swin_parts, "
            "nmrf_tpu_torch.tools.bench_loader, "
            "nmrf_tpu_torch.tools.bench_photometric, "
            "nmrf_tpu_torch.tools.check_tap_coverage; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'nmrf_tpu', 'matplotlib', 'PIL', 'cv2', "
            "'tensorboard', 'tensorflow')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_config_tree_matches_jax_package():
    from nmrf_tpu.config import get_cfg as get_cfg_jax
    from nmrf_tpu_torch.config import get_cfg

    port, jax_tree = get_cfg().to_dict(), get_cfg_jax().to_dict()
    # the port's own keys: the architecture switch and the RAFT-Stereo and
    # IGEV-Stereo nodes
    own = {"MODEL", "RAFT", "IGEV"}
    assert set(port) - set(jax_tree) == own
    assert {k: v for k, v in port.items() if k not in own} == jax_tree
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / "configs" / "kitti_mix_train.yaml"))
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.BASE_LR", "2e-4"])
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.SOLVER.BASE_LR == 2e-4
