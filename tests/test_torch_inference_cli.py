"""The port's demo and KITTI-submission CLI (``python -m
nmrf_tpu_torch.inference``) on the CPU, mirroring
``tests/test_inference_cli.py``, and its renderer and writer against the
JAX package.

* the three modes (``--input`` glob pairs, ``--dataset-name`` demo
  rendering, the KITTI submission) with ``--device cpu``, the demo mode
  restoring a checkpoint directory of ``python -m nmrf_tpu_torch.train``
  (``SOLVER.RESUME``) and the KITTI files equal, within the 1/256
  encoding, to ``predict`` of the restored weights;
* one upstream-format ``.pth`` (``{"model": port.state_dict()}``) read by
  both CLIs in KITTI-submission mode on the same PNGs: the uint16 files
  agree outside the refinement's reach of an argmax near-tie (the slice
  tolerance of ``tests/test_fullmodel_parity.py:163-182``, 4e-3 px, is at
  most 2 units of 1/256 after the two roundings);
* the export tool's ``--check`` round trip on the CPU;
* ``Visualizer.draw_disparity`` and ``draw_error_map`` byte for byte
  against the JAX package's on the same arrays, and ``write_disp_kitti``
  files byte for byte.

Small config of ``tests/test_export.py`` (``DPN.MAX_DISP`` 64,
``SOLVER.MAX_DISP`` 48) at 32 x 64.
"""

import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from nmrf_tpu_torch import build_model, get_cfg, predict
from nmrf_tpu_torch import inference as cli
from nmrf_tpu_torch.data.frame_io import read_disp_kitti, write_disp_kitti
from nmrf_tpu_torch.utils.visualization import Visualizer

H, W = 32, 64
OPTS = ["DPN.MAX_DISP", "64", "SOLVER.MAX_DISP", "48"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _png(path, seed=0, size=(H, W)):
    os.makedirs(osp.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(*size, 3) * 255).astype(np.uint8)).save(path)


def _model(seed=None):
    """The CLI's model at OPTS (random weights from ``cfg.SEED``, the
    config's unless given)."""
    cfg = get_cfg()
    cfg.merge_from_list(OPTS + ([] if seed is None else ["SEED", str(seed)]))
    cfg.freeze()
    return cfg, build_model(cfg, device="cpu")


def _kitti_root(tmp_path, n=2):
    """A KITTI_2015 ``testing`` layout of n pairs; returns DATASETS.ROOT."""
    root = tmp_path / "data"
    for i in range(n):
        for side, seed in (("image_2", 2 * i), ("image_3", 2 * i + 1)):
            _png(str(root / "KITTI" / "KITTI_2015" / "testing" / side
                     / f"{i:06d}_10.png"), seed)
    return str(root)


def _read_pair(root, i):
    base = osp.join(root, "KITTI", "KITTI_2015", "testing")
    return tuple(np.asarray(Image.open(osp.join(base, side, f"{i:06d}_10.png")))
                 .astype(np.float32) for side in ("image_2", "image_3"))


def test_input_glob_mode(tmp_path):
    for seed, n in enumerate(("a", "b")):
        _png(str(tmp_path / f"{n}_left.png"), 2 * seed)
        _png(str(tmp_path / f"{n}_right.png"), 2 * seed + 1)
    out = str(tmp_path / "out")
    written = cli.main(["--input", str(tmp_path / "*_left.png"),
                        str(tmp_path / "*_right.png"), "--output", out,
                        "--device", "cpu"] + OPTS)
    made = sorted(os.listdir(out))
    assert made == ["a_left_disp.png", "b_left_disp.png"]
    assert sorted(osp.basename(p) for p in written) == made
    im = np.asarray(Image.open(osp.join(out, made[0])))
    assert im.shape[:2] == (H, W)


def test_kitti_submission_mode(tmp_path):
    root = _kitti_root(tmp_path)
    out = str(tmp_path / "sub")
    cli.main(["--dataset-name", "kitti_2015", "--output", out, "--device",
              "cpu", "DATASETS.ROOT", root] + OPTS)
    files = sorted(os.listdir(out))
    assert files == ["000000_10.png", "000001_10.png"]
    _, model = _model()
    for i, name in enumerate(files):
        disp, valid = read_disp_kitti(osp.join(out, name))
        assert disp.shape == (H, W) and np.isfinite(disp).all()
        want = predict(model, *_read_pair(root, i))
        np.testing.assert_allclose(disp, want, atol=0.5 / 256 + 1e-6, rtol=0)


def test_dataset_demo_mode_with_restore(tmp_path):
    """eth3d demo rendering of the error map with ``SOLVER.RESUME`` a
    checkpoint directory of the training CLI (its model weights kept), and
    the restored weights' KITTI files equal to their ``predict``."""
    from nmrf_tpu_torch import build_optimizer
    from nmrf_tpu_torch.data.frame_io import write_pfm
    from nmrf_tpu_torch.utils.checkpoint import save_checkpoint, train_state

    droot = str(tmp_path / "data")
    sc = osp.join(droot, "ETH3D", "two_view_training", "scene_1l")
    _png(osp.join(sc, "im0.png"), 0)
    _png(osp.join(sc, "im1.png"), 1)
    gt = osp.join(droot, "ETH3D", "two_view_training_gt", "scene_1l")
    os.makedirs(gt, exist_ok=True)
    write_pfm(osp.join(gt, "disp0GT.pfm"), np.full((H, W), 5.0, np.float32))

    cfg, model = _model(seed=7)
    optimizer, _ = build_optimizer(model, cfg)
    ckpt_dir = str(tmp_path / "ckpt")
    save_checkpoint(ckpt_dir, 3, train_state(model, optimizer, 3))

    out = str(tmp_path / "demo")
    cli.main(["--dataset-name", "eth3d", "--show-attr", "error", "--output",
              out, "--device", "cpu", "DATASETS.ROOT", droot,
              "SOLVER.RESUME", ckpt_dir] + OPTS)
    assert os.listdir(out) == ["000000.png"]
    im = np.asarray(Image.open(osp.join(out, "000000.png")))
    assert im.shape[:2] == (H, W)

    kroot = _kitti_root(tmp_path, n=1)
    sub = str(tmp_path / "sub")
    cli.main(["--dataset-name", "kitti_2015", "--output", sub, "--device",
              "cpu", "DATASETS.ROOT", kroot, "SOLVER.RESUME", ckpt_dir] + OPTS)
    disp, _ = read_disp_kitti(osp.join(sub, "000000_10.png"))
    np.testing.assert_allclose(disp, predict(model, *_read_pair(kroot, 0)),
                               atol=0.5 / 256 + 1e-6, rtol=0)
    _, fresh = _model()
    assert not np.allclose(disp, predict(fresh, *_read_pair(kroot, 0)))


def test_strict_resume_raises_on_unmatched_keys(tmp_path):
    _, model = _model(seed=5)
    state = dict(model.state_dict())
    state.pop("infer_score_head.weight")
    path = str(tmp_path / "partial.pth")
    torch.save({"model": state}, path)
    with pytest.raises(ValueError, match="unmatched"):
        cli.build(cli.get_args_parser().parse_args(
            ["--device", "cpu", "SOLVER.RESUME", path] + OPTS))
    _, loose = cli.build(cli.get_args_parser().parse_args(
        ["--device", "cpu", "SOLVER.RESUME", path,
         "SOLVER.STRICT_RESUME", "False"] + OPTS))
    assert torch.equal(loose.dpn.prop_head.layers[0].weight,
                       model.dpn.prop_head.layers[0].weight)


def test_both_clis_read_one_pth(tmp_path, monkeypatch):
    """One upstream-format ``.pth`` through both CLIs' ``SOLVER.RESUME`` in
    KITTI-submission mode on the same PNGs (module docstring)."""
    import inference as cli_jax

    _, model = _model(seed=11)
    with torch.no_grad():  # spread the zero-initialised heads and tables
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    pth = str(tmp_path / "model.pth")
    torch.save({"model": model.state_dict()}, pth)
    root = _kitti_root(tmp_path)
    common = ["--dataset-name", "kitti_2015"]
    opts = ["DATASETS.ROOT", root, "SOLVER.RESUME", pth] + OPTS
    cli.main(common + ["--output", str(tmp_path / "port"), "--device",
                       "cpu"] + opts)
    monkeypatch.setattr(sys, "argv", ["inference.py"] + common
                        + ["--output", str(tmp_path / "jax")] + opts)
    cli_jax.main()

    for i in range(2):
        name = f"{i:06d}_10.png"
        got, want = (np.asarray(Image.open(str(tmp_path / d / name)))
                     .astype(np.int64) for d in ("port", "jax"))
        assert got.shape == want.shape == (H, W)
        model.train()
        with torch.no_grad():
            logits = model(*(torch.from_numpy(x[None]) for x in
                             _read_pair(root, i)))["logits_layers"][-1]
        model.eval()
        top2 = np.sort(logits.numpy(), axis=-1)[..., -2:]
        near_tie = torch.from_numpy((top2[..., 1] - top2[..., 0] < 1e-5)
                                    .astype(np.float32))
        tie = (F.max_pool2d(near_tie[:, None], 193, 1, 96)[0, 0] > 0).numpy()
        assert np.abs(got - want)[~tie].max(initial=0) <= 2
        assert (got != want).mean() < 0.10


def test_export_serving_tool_check(tmp_path):
    """``python -m nmrf_tpu_torch.tools.export_serving --check`` on the CPU:
    30 x 60 padded to 32 x 64, the loaded artifact within the tool's 1e-4
    of the live model it builds, the sidecar naming the shape."""
    from nmrf_tpu_torch.tools import export_serving
    from nmrf_tpu_torch.utils.export import load_meta

    path = str(tmp_path / "tool.pt2")
    size = export_serving.main(["--device", "cpu", "--height", "30",
                                "--width", "60", "--output", path,
                                "--check"] + OPTS)
    meta = load_meta(path)
    assert size > 0 and meta["input_shape"] == [1, 32, 64, 3]
    assert meta["divis_by"] == 8 and meta["model"] == "resnet"
    assert meta["device"] == "cpu" and meta["frozen_params"]


def _render_inputs():
    rng = np.random.RandomState(4)
    img = rng.rand(H, W, 3) * 255
    disp = (rng.rand(H, W) * 40).astype(np.float32)
    err = np.abs(rng.randn(H, W)).astype(np.float32) * 20
    return img, disp, err


@pytest.mark.parametrize("draw", ["disparity", "error_map"])
def test_renderings_equal_jax(draw):
    from nmrf_tpu.utils.visualization import Visualizer as VisualizerJax

    img, disp, err = _render_inputs()
    images = []
    for vis in (Visualizer, VisualizerJax):
        v = vis(img)
        out = v.draw_disparity(disp) if draw == "disparity" \
            else v.draw_error_map(err)
        images.append(out.get_image())
    assert images[0].shape[:2] == (H, W)
    assert images[0].dtype == np.uint8 and images[0].std() > 0
    np.testing.assert_array_equal(images[0], images[1])


def test_write_disp_kitti_equals_jax(tmp_path):
    from nmrf_tpu.data.frame_io import write_disp_kitti as write_jax

    disp = np.random.RandomState(5).rand(H, W).astype(np.float32) * 200
    write_disp_kitti(str(tmp_path / "port.png"), disp)
    write_jax(str(tmp_path / "jax.png"), disp)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    back, valid = read_disp_kitti(str(tmp_path / "port.png"))
    np.testing.assert_allclose(back, disp, atol=0.5 / 256 + 1e-4)
