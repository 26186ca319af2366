"""The port's data pipeline against the JAX package (CPU, numpy seeds).

* the sampler's indices (``ShardedBatchSampler.epoch_indices`` over ranks,
  worlds and epochs; ``InferenceSampler`` shards) equal the JAX ones;
* ``FlowAugmentor`` and ``SparseFlowAugmentor`` give the JAX outputs
  exactly under the loader's per-sample seeds (``_sample_seed`` and the
  seeding of ``_load_indexed``);
* the host photometric kernel (the port's own copy and build) equals the
  JAX package's exactly, and its PIL version within the JAX test's bound on
  hue; skipped without ``g++``;
* the dataset classes list the same files of fabricated layouts and read
  the same samples; the readers read the same PFM and 16-bit KITTI PNG;
* ``slic_segments`` gives the same labels and ``downsample_disp`` the same
  pooled disparity (numpy exactly; the torch path within 1e-6 relative);
* the loader gives the JAX loader's batches, and a loader placed at
  (epoch, step) gives the batches of a whole run from there on.
"""

import json
import os
import os.path as osp
import random
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.data import datasets as DJ
from nmrf_tpu.data import frame_io as FJ
from nmrf_tpu.data import loader as LJ
from nmrf_tpu.data import transforms as TJ
from nmrf_tpu.data.superpixel import slic_segments as slic_jax
from nmrf_tpu.ops.downsample import downsample_disp as downsample_jax
from nmrf_tpu_torch.config import get_cfg
from nmrf_tpu_torch.data import datasets as D
from nmrf_tpu_torch.data import frame_io as F
from nmrf_tpu_torch.data import loader as L
from nmrf_tpu_torch.data import transforms as T
from nmrf_tpu_torch.data.superpixel import slic_segments
from nmrf_tpu_torch.ops.downsample import downsample_disp

H, W = 32, 48


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- samplers ---- #

@pytest.mark.parametrize("n,batch,world,shuffle,drop_last", [
    (37, 8, 1, True, True), (37, 8, 2, True, True), (40, 4, 4, True, False),
    (11, 6, 3, False, False)])
def test_sampler_indices_match_jax(n, batch, world, shuffle, drop_last):
    for rank in range(world):
        got = L.ShardedBatchSampler(n, batch, rank, world, seed=5,
                                    shuffle=shuffle, drop_last=drop_last)
        want = LJ.ShardedBatchSampler(n, batch, rank, world, seed=5,
                                      shuffle=shuffle, drop_last=drop_last)
        for epoch in (0, 1, 7):
            np.testing.assert_array_equal(got.epoch_indices(epoch),
                                          want.epoch_indices(epoch))
    for size, world in ((10, 3), (2, 4), (16, 1)):
        for rank in range(world):
            assert list(L.InferenceSampler(size, rank, world)) == \
                list(LJ.InferenceSampler(size, rank, world))


# ---- augmentation and the photometric kernel ---- #

def _aug_inputs(seed):
    rng = np.random.RandomState(seed)
    img1 = (rng.rand(100, 140, 3) * 255).astype(np.uint8)
    img2 = (rng.rand(100, 140, 3) * 255).astype(np.uint8)
    flow = np.stack([rng.rand(100, 140) * 20, np.zeros((100, 140))],
                    -1).astype(np.float32)
    valid = rng.rand(100, 140) > 0.3
    return img1, img2, flow, valid


def _seeded(fn, seed, *args):
    """``fn(*args)`` under the loader's per-sample seeding
    (``loader._load_indexed``)."""
    np.random.seed(seed)
    random.seed(seed + 1)
    return fn(*args)


@pytest.mark.parametrize("sparse", [False, True])
def test_augmentors_match_jax_under_loader_seeds(sparse):
    kw = dict(crop_size=[64, 96], min_scale=-0.2, max_scale=0.4,
              saturation_range=(0.0, 1.4), do_flip=False)
    if sparse:
        got_aug, want_aug = T.SparseFlowAugmentor(**kw), TJ.SparseFlowAugmentor(**kw)
    else:
        got_aug = T.FlowAugmentor(**kw, spatial_aug_prob=1.0)
        want_aug = TJ.FlowAugmentor(**kw, spatial_aug_prob=1.0)
    for step in range(3):
        for slot in range(2):
            seed = L._sample_seed(326, 1, 0, step, slot)
            assert seed == LJ._sample_seed(326, 1, 0, step, slot)
            img1, img2, flow, valid = _aug_inputs(step * 2 + slot)
            args = (img1, img2, flow, valid) if sparse else (img1, img2, flow)
            got = _seeded(got_aug, seed, *args)
            want = _seeded(want_aug, seed, *args)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def native_libs():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the host photometric kernel cannot be built")
    from nmrf_tpu import native as native_jax
    from nmrf_tpu_torch import native

    lib_jax = native_jax.load()
    if lib_jax is None:
        pytest.skip("the JAX package's photometric kernel did not build")
    return native.load(), lib_jax


def _run_lib(lib, img, codes, b=1.0, c=1.0, s=1.0, hue=0, lut=None):
    import ctypes

    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = img.copy()
    codes = np.asarray(codes, np.int32)
    table = np.arange(256, dtype=np.uint8) if lut is None else lut
    lib.nmrf_photometric(out.ctypes.data_as(u8p), out.size // 3,
                         codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         len(codes), b, c, s, hue, table.ctypes.data_as(u8p),
                         int(lut is not None))
    return out


def test_photometric_kernel_matches_jax_and_pil(native_libs):
    lib, lib_jax = native_libs
    img = np.random.RandomState(7).randint(0, 256, (64, 96, 3), dtype=np.uint8)
    lut = T._gamma_lut(1.73, 1.1)
    np.testing.assert_array_equal(lut, TJ._gamma_lut(1.73, 1.1))
    cases = [dict(codes=[0], b=0.73), dict(codes=[1], c=1.39),
             dict(codes=[2], s=0.6), dict(codes=[], lut=lut),
             dict(codes=[3], hue=int(round(0.09 * 255))),
             dict(codes=[2, 0, 3, 1], b=1.2, c=0.8, s=1.3, hue=-20, lut=lut)]
    for case in cases:
        np.testing.assert_array_equal(_run_lib(lib, img, **case),
                                      _run_lib(lib_jax, img, **case),
                                      err_msg=str(case))
    # the PIL chain is the plain version: exact on the first four
    # operations, within the JAX test's bound on hue
    from PIL import ImageEnhance

    pil = Image.fromarray(img)
    for case, want in zip(cases, (
            ImageEnhance.Brightness(pil).enhance(0.73),
            ImageEnhance.Contrast(pil).enhance(1.39),
            ImageEnhance.Color(pil).enhance(0.6),
            T._adjust_gamma(pil, 1.73, 1.1))):
        np.testing.assert_array_equal(_run_lib(lib, img, **case),
                                      np.asarray(want), err_msg=str(case))
    got = _run_lib(lib, img, **cases[4]).astype(np.int32)
    want = np.asarray(T._adjust_hue(pil, 0.09)).astype(np.int32)
    assert np.abs(got - want).max() <= 8 and (got != want).mean() < 0.02

    jitter = (0.4, 0.4, (0.6, 1.4), 0.5 / 3.14)
    gamma = (0.8, 1.2, 1.0, 1.02)
    for seed in range(3):
        random.seed(seed)
        got = T.fused_photometric(img, T.ColorJitter(*jitter), T.AdjustGamma(*gamma))
        tail = random.random()
        random.seed(seed)
        want = TJ.fused_photometric(img, TJ.ColorJitter(*jitter),
                                    TJ.AdjustGamma(*gamma))
        assert random.random() == tail
        np.testing.assert_array_equal(got, want)
        random.seed(seed)
        plain = T.fused_photometric(img, T.ColorJitter(*jitter),
                                    T.AdjustGamma(*gamma), plain=True)
        diff = np.abs(plain.astype(np.int32) - got.astype(np.int32))
        assert diff.max() <= 12 and (diff > 0).mean() < 0.05


# ---- datasets and readers ---- #

def _rgb(path, seed=0):
    os.makedirs(osp.dirname(path), exist_ok=True)
    arr = (np.random.RandomState(seed).rand(H, W, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def _gray16(path, value):
    os.makedirs(osp.dirname(path), exist_ok=True)
    Image.fromarray(np.full((H, W), value, np.uint16)).save(path)


def _pfm(path):
    os.makedirs(osp.dirname(path), exist_ok=True)
    FJ.write_pfm(path, np.linspace(1.0, 40.0, H * W, dtype=np.float32).reshape(H, W))


def _layouts(root):
    """Fabricated trees of every dataset class (tests/test_dataset_layouts.py)."""
    sf = osp.join(root, "SceneFlow")
    for split, scene in (("TRAIN", "A/0000"), ("TEST", "B/0001")):
        for side in ("left", "right"):
            _rgb(osp.join(sf, "FlyingThings3D/frames_finalpass", split, scene,
                          side, "0006.png"), 1)
        _pfm(osp.join(sf, "FlyingThings3D/disparity", split, scene, "left",
                      "0006.pfm"))
    for side in ("left", "right"):
        _rgb(osp.join(sf, "Monkaa/frames_finalpass/scene_x", side, "0048.png"), 2)
        _rgb(osp.join(sf, "Driving/frames_finalpass/35mm_focallength",
                      "scene_forwards/fast", side, "0401.png"), 3)
    _pfm(osp.join(sf, "Monkaa/disparity/scene_x/left/0048.pfm"))
    _pfm(osp.join(sf, "Driving/disparity/35mm_focallength",
                  "scene_forwards/fast/left/0401.pfm"))
    ep = osp.join(root, "Carla/episode_0000/generated")
    depth = np.zeros((H, W, 3), np.uint8)
    depth[..., 2] = 10
    os.makedirs(osp.join(ep, "images_depth"))
    for i in range(2):
        _rgb(osp.join(ep, "images_rgb", f"00000{i}_0.png"), 4)
        _rgb(osp.join(ep, "images_rgb", f"00000{i}_1.png"), 5)
        Image.fromarray(depth).save(osp.join(ep, "images_depth", f"00000{i}_20.png"))
    for scene in ("delivery_area_1l", "playground_1l"):
        _rgb(osp.join(root, "ETH3D/two_view_training", scene, "im0.png"), 6)
        _rgb(osp.join(root, "ETH3D/two_view_training", scene, "im1.png"), 7)
        _pfm(osp.join(root, "ETH3D/two_view_training_gt", scene, "disp0GT.pfm"))
    si = osp.join(root, "SintelStereo/training")
    for render in ("clean", "final"):
        _rgb(osp.join(si, f"{render}_left/alley_1/frame_0001.png"), 8)
        _rgb(osp.join(si, f"{render}_right/alley_1/frame_0001.png"), 9)
    for sub, arr in (("disparities", np.full((H, W, 3), 5, np.uint8)),
                     ("occlusions", np.zeros((H, W), np.uint8))):
        os.makedirs(osp.join(si, sub, "alley_1"))
        Image.fromarray(arr).save(osp.join(si, sub, "alley_1/frame_0001.png"))
    ft = osp.join(root, "FallingThings")
    names = ["mixed/kitchen_0/000000.left.jpg", "mixed/kitchen_0/000001.left.jpg"]
    for n in names:
        _rgb(osp.join(ft, n), 10)
        _rgb(osp.join(ft, n.replace("left.jpg", "right.jpg")), 11)
        _gray16(osp.join(ft, n.replace("left.jpg", "left.depth.png")), 3000)
    with open(osp.join(ft, "mixed/kitchen_0/_camera_settings.json"), "w") as f:
        json.dump({"camera_settings": [{"intrinsic_settings": {"fx": 768.0}}]}, f)
    with open(osp.join(ft, "filenames.txt"), "w") as f:
        f.write("\n".join(names))
    entry = "abandonedfactory/Easy/P000/image_left/000000_left.png"
    _rgb(osp.join(root, entry), 12)
    _rgb(osp.join(root, entry.replace("_left", "_right")), 13)
    depth = osp.join(root, entry.replace("image_left", "depth_left")
                     .replace("left.png", "left_depth.npy"))
    os.makedirs(osp.dirname(depth))
    np.save(depth, np.full((H, W), 8.0, np.float32))
    with open(osp.join(root, "tartanair_filenames.txt"), "w") as f:
        f.write(entry)
    ki = osp.join(root, "KITTI")
    for year, imdirs, dispdir in (("KITTI_2012", ("colored_0", "colored_1"), "disp_occ"),
                                  ("KITTI_2015", ("image_2", "image_3"), "disp_occ_0")):
        for split in ("training", "testing"):
            for d in imdirs:
                _rgb(osp.join(ki, year, split, d, "000000_10.png"), 14)
        _gray16(osp.join(ki, year, "training", dispdir, "000000_10.png"), 20 * 256)
    fdir = osp.join(root, "filenames")
    os.makedirs(fdir)
    with open(osp.join(fdir, "KITTI_mix.txt"), "w") as f:
        f.write("training/colored_0/000000_10.png training/colored_1/000000_10.png "
                "training/disp_occ/000000_10.png\ntraining/image_2/000000_10.png "
                "training/image_3/000000_10.png training/disp_occ_0/000000_10.png")
    mb = osp.join(root, "Middlebury")
    _rgb(osp.join(mb, "2014/Adirondack-perfect/im0.png"), 15)
    for s in ("", "E", "L"):
        _rgb(osp.join(mb, f"2014/Adirondack-perfect/im1{s}.png"), 16)
    _pfm(osp.join(mb, "2014/Adirondack-perfect/disp0.pfm"))
    for scene in ("Jadeplant", "NotOfficial"):
        base = osp.join(mb, "MiddEval3/trainingF", scene)
        _rgb(osp.join(base, "im0.png"), 17)
        _rgb(osp.join(base, "im1.png"), 18)
        _pfm(osp.join(base, "disp0GT.pfm"))
        Image.fromarray(np.full((H, W), 255, np.uint8)).save(
            osp.join(base, "mask0nocc.png"))
    with open(osp.join(mb, "MiddEval3/official_train.txt"), "w") as f:
        f.write("Jadeplant")
    return fdir


def test_dataset_layouts_match_jax(tmp_path):
    root = str(tmp_path)
    fdir = _layouts(root)
    makers = {
        "sceneflow": lambda M: M.SceneFlowDatasets(root=osp.join(root, "SceneFlow")),
        "things_test": lambda M: M.SceneFlowDatasets(
            root=osp.join(root, "SceneFlow"), things_test=True),
        "carla": lambda M: M.Carla(root=osp.join(root, "Carla")),
        "eth3d": lambda M: M.ETH3D(root=osp.join(root, "ETH3D")),
        "sintel": lambda M: M.SintelStereo(root=osp.join(root, "SintelStereo")),
        "falling_things": lambda M: M.FallingThings(root=osp.join(root, "FallingThings")),
        "tartan_air": lambda M: M.TartanAir(root=root),
        "kitti_mix": lambda M: M.KITTI(root=osp.join(root, "KITTI"),
                                       image_set="kitti_mix", filenames_dir=fdir),
        "kitti_2015_test": lambda M: M.KITTI(root=osp.join(root, "KITTI"),
                                             split="testing", image_set="kitti_2015"),
        "middlebury_2014": lambda M: M.Middlebury(root=osp.join(root, "Middlebury"),
                                                  split="2014"),
        "middlebury_F": lambda M: M.Middlebury(root=osp.join(root, "Middlebury"),
                                               split="F"),
    }
    for name, make in makers.items():
        got, want = make(D), make(DJ)
        assert len(got) == len(want) > 0, name
        assert got.image_list == want.image_list, name
        assert got.disparity_list == want.disparity_list, name
        assert got.extra_info == want.extra_info, name
        a, b = got[len(got) - 1], want[len(want) - 1]
        assert a.keys() == b.keys(), name
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")

    cfg, cfg_jax = get_cfg(), get_cfg_jax()
    for c in (cfg, cfg_jax):
        c.DATASETS.ROOT = root
        c.DATASETS.TRAIN = ("sceneflow", "synthetic_2x64x96")
        c.DATASETS.CROP_SIZE = (24, 40)
    got, want = D.build_train_dataset(cfg), DJ.build_train_dataset(cfg_jax)
    assert len(got) == len(want) == 5
    for i in (0, 4):
        for key, value in _seeded(got.__getitem__, 11, i).items():
            np.testing.assert_array_equal(value, _seeded(want.__getitem__, 11, i)[key])
    for name in ("things", "eth3d", "synthetic_2x40x56"):
        a, b = D.build_val_dataset(cfg, name), DJ.build_val_dataset(cfg_jax, name)
        assert len(a) == len(b)
        for key, value in a[0].items():
            np.testing.assert_array_equal(value, b[0][key])


def test_readers_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    arr = rng.rand(7, 9).astype(np.float32)
    F.write_pfm(str(tmp_path / "a.pfm"), arr)
    np.testing.assert_array_equal(F.read_pfm(str(tmp_path / "a.pfm")),
                                  FJ.read_pfm(str(tmp_path / "a.pfm")))
    FJ.write_pfm(str(tmp_path / "b.pfm"), arr)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    disp = np.round(rng.rand(5, 6) * 100 * 256).astype(np.uint16)
    disp[0, 0] = 0
    Image.fromarray(disp).save(str(tmp_path / "d.png"))
    for got, want in zip(F.read_disp_kitti(str(tmp_path / "d.png")),
                         FJ.read_disp_kitti(str(tmp_path / "d.png"))):
        np.testing.assert_array_equal(got, want)
    assert not F.read_disp_kitti(str(tmp_path / "d.png"))[1][0, 0]
    np.testing.assert_array_equal(np.asarray(F.read_gen(str(tmp_path / "d.png"))),
                                  np.asarray(FJ.read_gen(str(tmp_path / "d.png"))))


# ---- superpixels and pooling ---- #

def test_superpixels_and_pooling_match_jax():
    rng = np.random.RandomState(3)
    img = (rng.rand(37, 50, 3) * 255).astype(np.float32)
    np.testing.assert_array_equal(slic_segments(img), slic_jax(img))
    np.testing.assert_array_equal(slic_segments(img, iters=3), slic_jax(img, iters=3))
    disp = (rng.rand(2, 40, 64) * 60).astype(np.float32)
    disp[disp < 10] = 0
    label = np.stack([slic_segments((rng.rand(40, 64, 3) * 255).astype(np.float32))
                      for _ in range(2)])
    want = np.asarray(downsample_jax(disp, label))
    got = downsample_disp(disp, label)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got_t = downsample_disp(torch.from_numpy(disp), torch.from_numpy(label))
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- the loader ---- #

class _GlobalRngDataset:
    """Samples drawn from the global numpy and stdlib generators, as the
    augmentors draw (module level: spawn workers unpickle it)."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {"img1": np.random.rand(4, 4, 3).astype(np.float32) + i,
                "img2": np.full((4, 4, 3), random.random(), np.float32),
                "disp": np.zeros((4, 4), np.float32),
                "valid": np.ones((4, 4), bool)}


def test_loader_matches_jax_and_resumes_in_place():
    from nmrf_tpu.data.synthetic import SyntheticStereoDataset as SynJ
    from nmrf_tpu_torch.data import SyntheticStereoDataset

    got = L.PrefetchLoader(SyntheticStereoDataset(6, 16, 32),
                           L.ShardedBatchSampler(6, 2, seed=3), num_workers=2)
    want = LJ.PrefetchLoader(SynJ(6, 16, 32), LJ.ShardedBatchSampler(6, 2, seed=3),
                             num_workers=2)
    full = [b for _ in range(2) for b in got]
    for a, b in zip(full, [b for _ in range(2) for b in want]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    # a loader at (epoch 0, step 2) yields the run's batches 2.. and the
    # next epoch whole
    tail = L.PrefetchLoader(SyntheticStereoDataset(6, 16, 32),
                            L.ShardedBatchSampler(6, 2, seed=3), num_workers=2,
                            start_epoch=0, start_step=2)
    rest = [b for _ in range(2) for b in tail]
    assert len(rest) == len(full) - 2
    for a, b in zip(rest, full[2:]):
        np.testing.assert_array_equal(a["img1"], b["img1"])

    # spawn workers: the per-sample seeds of a resumed loader are the run's
    def run(**kw):
        loader = L.PrefetchLoader(_GlobalRngDataset(), L.ShardedBatchSampler(6, 2, seed=0),
                                  num_workers=2, use_processes=True, seed=123, **kw)
        try:
            return [b for _ in range(2) for b in loader]
        finally:
            loader.shutdown()

    whole, resumed = run(), run(start_epoch=1, start_step=1)
    assert len(whole) == 6 and len(resumed) == 5
    for a, b in zip(resumed[:2], whole[4:]):
        for key in ("img1", "img2"):
            np.testing.assert_array_equal(a[key], b[key])
