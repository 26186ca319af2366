"""Stereo dataset catalog, the port's copy of ``nmrf_tpu/data/datasets.py``
(reference ``nmrf/data/datasets.py``): the same directory layouts,
filename-list driven KITTI mixes and sample dict contract {img1, img2,
disp, valid(, meta)}, as channel-last numpy arrays.  ``build_train_dataset``
and ``build_val_dataset`` also take ``synthetic_<N>x<H>x<W>``: random-dot
stereograms, which need no files, PIL or OpenCV.
"""

import copy
import logging
import os
import os.path as osp
from glob import glob
from pathlib import Path

import numpy as np

from . import frame_io
from .transforms import FlowAugmentor, SparseFlowAugmentor

logger = logging.getLogger(__name__)


def read_all_lines(filename):
    with open(filename) as fp:
        return [line.rstrip() for line in fp.readlines()]


class StereoDataset:
    """Index-based dataset; returns dicts of numpy arrays
    (reference datasets.py:28-127)."""

    def __init__(self, aug_params=None, sparse=False, reader=None):
        self.augmentor = None
        self.sparse = sparse
        aug_params = copy.deepcopy(aug_params) if aug_params is not None else None
        self.img_pad = aug_params.pop("img_pad", None) if aug_params else None
        if aug_params is not None and "crop_size" in aug_params:
            if self.sparse:
                aug_params.pop("yjitter", None)
                self.augmentor = SparseFlowAugmentor(**aug_params)
            else:
                self.augmentor = FlowAugmentor(**aug_params)
        self.disparity_reader = reader if reader is not None else frame_io.read_gen
        self.is_test = False
        self.flow_list = []
        self.disparity_list = []
        self.image_list = []
        self.extra_info = []

    def __getitem__(self, index):
        sample = {}
        if self.is_test:
            img1 = np.array(frame_io.read_gen(self.image_list[index][0])).astype(np.uint8)[..., :3]
            img2 = np.array(frame_io.read_gen(self.image_list[index][1])).astype(np.uint8)[..., :3]
            sample["img1"] = img1.astype(np.float32)
            sample["img2"] = img2.astype(np.float32)
            sample["meta"] = self.extra_info[index]
            return sample

        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512

        img1 = np.array(frame_io.read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.array(frame_io.read_gen(self.image_list[index][1])).astype(np.uint8)
        disp = np.array(disp).astype(np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], axis=-1)

        if img1.ndim == 2:  # grayscale -> RGB
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow, valid)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)

        sample["img1"] = img1.astype(np.float32)
        sample["img2"] = img2.astype(np.float32)
        sample["disp"] = flow[..., 0].astype(np.float32)
        if self.sparse:
            sample["valid"] = np.asarray(valid, bool)
        else:
            sample["valid"] = sample["disp"] < 512
        return sample

    def __mul__(self, v):
        c = copy.deepcopy(self)
        c.flow_list = v * c.flow_list
        c.image_list = v * c.image_list
        c.disparity_list = v * c.disparity_list
        c.extra_info = v * c.extra_info
        return c

    def __add__(self, other):
        # torch Dataset.__add__ -> ConcatDataset equivalence
        return ConcatStereoDataset([self, other])

    def __len__(self):
        return len(self.image_list)


class ConcatStereoDataset:
    """Heterogeneous dataset concat (torch ConcatDataset equivalent)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._cum, idx, side="right"))
        start = 0 if d == 0 else self._cum[d - 1]
        return self.datasets[d][int(idx - start)]


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D + Monkaa + Driving (reference datasets.py:130-179)."""

    def __init__(self, aug_params=None, root="datasets/SceneFlow",
                 dstype="frames_finalpass", things_test=False):
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _add_things(self, split="TRAIN"):
        original = len(self.disparity_list)
        root = osp.join(self.root, "FlyingThings3D")
        left = sorted(glob(osp.join(root, self.dstype, split, "*/*/left/*.png")))
        right = [im.replace("left", "right") for im in left]
        disp = [im.replace(self.dstype, "disparity").replace(".png", ".pfm") for im in left]
        for i1, i2, d in zip(left, right, disp):
            self.image_list += [[i1, i2]]
            self.disparity_list += [d]
        logger.info(f"Added {len(self.disparity_list) - original} from FlyingThings {self.dstype}")

    def _add_monkaa(self):
        root = osp.join(self.root, "Monkaa")
        left = sorted(glob(osp.join(root, self.dstype, "*/left/*.png")))
        right = [im.replace("left", "right") for im in left]
        disp = [im.replace(self.dstype, "disparity").replace(".png", ".pfm") for im in left]
        for i1, i2, d in zip(left, right, disp):
            self.image_list += [[i1, i2]]
            self.disparity_list += [d]

    def _add_driving(self):
        root = osp.join(self.root, "Driving")
        left = sorted(glob(osp.join(root, self.dstype, "*/*/*/left/*.png")))
        right = [im.replace("left", "right") for im in left]
        disp = [im.replace(self.dstype, "disparity").replace(".png", ".pfm") for im in left]
        for i1, i2, d in zip(left, right, disp):
            self.image_list += [[i1, i2]]
            self.disparity_list += [d]


class Carla(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/Carla"):
        super().__init__(aug_params, reader=frame_io.read_disp_carla)
        left = sorted(glob(osp.join(root, "*/generated/images_rgb/*_0.png")))
        right = sorted(glob(osp.join(root, "*/generated/images_rgb/*_1.png")))
        disp = sorted(glob(osp.join(root, "*/generated/images_depth/*_20.png")))
        for i1, i2, d in zip(left, right, disp):
            self.image_list += [[i1, i2]]
            self.disparity_list += [d]


class ETH3D(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/ETH3D", split="training"):
        super().__init__(aug_params, sparse=True)
        im0 = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        im1 = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:
            disp = [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")] * len(im0)
        for i1, i2, d in zip(im0, im1, disp):
            self.image_list += [[i1, i2]]
            self.disparity_list += [d]


class SintelStereo(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True, reader=frame_io.read_disp_sintel)
        im1 = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        im2 = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for i1, i2, d in zip(im1, im2, disp):
            if i1.split("/")[-2:] != d.split("/")[-2:]:
                raise ValueError(f"unpaired Sintel files {i1} {d}")
            self.image_list += [[i1, i2]]
            self.disparity_list += [d]


class FallingThings(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/FallingThings"):
        super().__init__(aug_params, reader=frame_io.read_disp_fallingthings)
        with open(os.path.join(root, "filenames.txt")) as f:
            filenames = sorted(f.read().splitlines())
        for e in filenames:
            self.image_list += [[osp.join(root, e),
                                 osp.join(root, e.replace("left.jpg", "right.jpg"))]]
            self.disparity_list += [osp.join(root, e.replace("left.jpg", "left.depth.png"))]


class TartanAir(StereoDataset):
    def __init__(self, aug_params=None, root="datasets", keywords=()):
        super().__init__(aug_params, reader=frame_io.read_disp_tartanair)
        with open(os.path.join(root, "tartanair_filenames.txt")) as f:
            filenames = sorted(s for s in f.read().splitlines()
                               if "seasonsforest_winter/Easy" not in s)
            for kw in keywords:
                filenames = sorted(s for s in filenames if kw in s.lower())
        for e in filenames:
            self.image_list += [[osp.join(root, e),
                                 osp.join(root, e.replace("_left", "_right"))]]
            self.disparity_list += [osp.join(
                root, e.replace("image_left", "depth_left").replace("left.png", "left_depth.npy"))]


class KITTI(StereoDataset):
    """KITTI 2012/2015 with filename-list mixes (reference datasets.py:260-319)."""

    def __init__(self, aug_params=None, root="datasets/KITTI", split="training",
                 image_set="kitti_mix", filenames_dir="filenames"):
        super().__init__(aug_params, sparse=True, reader=frame_io.read_disp_kitti)
        if split == "testing":
            self.is_test = True
            if image_set == "kitti_2012":
                root = osp.join(root, "KITTI_2012")
                images1 = sorted(glob(osp.join(root, "testing", "colored_0/*_10.png")))
                images2 = sorted(glob(osp.join(root, "testing", "colored_1/*_10.png")))
            elif image_set == "kitti_2015":
                root = osp.join(root, "KITTI_2015")
                images1 = sorted(glob(osp.join(root, "testing", "image_2/*_10.png")))
                images2 = sorted(glob(osp.join(root, "testing", "image_3/*_10.png")))
            else:
                raise ValueError(f"Unknown dataset for test: '{image_set}'")
            for i1, i2 in zip(images1, images2):
                self.extra_info += [i1.split("/")[-1]]
                self.image_list += [[i1, i2]]
        else:
            kitti_dict = {
                "kitti_mix_2012_train": "KITTI_mix_2012_train.txt",
                "kitti_mix_2015_train": "KITTI_mix_2015_train.txt",
                "kitti_2012_val": "KITTI_2012_val.txt",
                "kitti_2015_val": "KITTI_2015_val.txt",
                "kitti_mix": "KITTI_mix.txt",
                "kitti_2015_train": "KITTI_2015_train.txt",
                "kitti_2015_trainval": "KITTI_2015_trainval.txt",
                "kitti_2012_train": "KITTI_2012_train.txt",
                "kitti_2012_trainval": "KITTI_2012_trainval.txt",
            }
            if image_set not in kitti_dict:
                raise ValueError(f"Unknown KITTI image set: '{image_set}'")
            self._root_12 = os.path.join(root, "KITTI_2012")
            self._root_15 = os.path.join(root, "KITTI_2015")
            self.load_path(os.path.join(filenames_dir, kitti_dict[image_set]))

    def load_path(self, list_filename):
        for line in (l.split() for l in read_all_lines(list_filename)):
            left_name = line[0].split("/")[1]
            root = self._root_15 if left_name.startswith("image") else self._root_12
            self.image_list += [[os.path.join(root, line[0]), os.path.join(root, line[1])]]
            if len(line) > 2:
                self.disparity_list += [os.path.join(root, line[2])]
            self.extra_info += [line[0].split("/")[-1]]


class Middlebury(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/Middlebury", split="F"):
        super().__init__(aug_params, sparse=True, reader=frame_io.read_disp_middlebury)
        if split not in ("F", "H", "Q", "2014"):
            raise ValueError(f"Unknown Middlebury split: '{split}'")
        if split == "2014":
            scenes = list((Path(root) / "2014").glob("*"))
            for scene in scenes:
                for s in ["E", "L", ""]:
                    self.image_list += [[str(scene / "im0.png"), str(scene / f"im1{s}.png")]]
                    self.disparity_list += [str(scene / "disp0.pfm")]
        else:
            lines = list(map(osp.basename, glob(os.path.join(root, "MiddEval3/trainingF/*"))))
            official = Path(os.path.join(root, "MiddEval3/official_train.txt")).read_text().splitlines()
            lines = [p for p in lines if any(s in p.split("/") for s in official)]
            im0 = sorted(os.path.join(root, "MiddEval3", f"training{split}", f"{n}/im0.png") for n in lines)
            im1 = sorted(os.path.join(root, "MiddEval3", f"training{split}", f"{n}/im1.png") for n in lines)
            disp = sorted(os.path.join(root, "MiddEval3", f"training{split}", f"{n}/disp0GT.pfm") for n in lines)
            if not len(im0) == len(im1) == len(disp) > 0:
                raise ValueError(f"Middlebury {split}: no complete scenes "
                                 f"under {root}")
            for i1, i2, d in zip(im0, im1, disp):
                self.image_list += [[i1, i2]]
                self.disparity_list += [d]


def build_train_dataset(cfg):
    """Dataset concat by name (reference build_train_loader, datasets.py:345-381)."""
    crop_size = cfg.DATASETS.CROP_SIZE
    aug_params = {
        "crop_size": list(crop_size),
        "min_scale": cfg.DATASETS.SPATIAL_SCALE[0],
        "max_scale": cfg.DATASETS.SPATIAL_SCALE[1],
        "do_flip": False,
        "yjitter": cfg.DATASETS.YJITTER,
    }
    if cfg.DATASETS.SATURATION_RANGE is not None:
        aug_params["saturation_range"] = cfg.DATASETS.SATURATION_RANGE
    if cfg.DATASETS.IMG_GAMMA is not None:
        aug_params["gamma"] = cfg.DATASETS.IMG_GAMMA
    if cfg.DATASETS.DO_FLIP is not None:
        aug_params["do_flip"] = cfg.DATASETS.DO_FLIP

    root = cfg.DATASETS.ROOT
    parts = []
    for name in cfg.DATASETS.TRAIN:
        if name.startswith("middlebury_"):
            ds = Middlebury(aug_params, root=osp.join(root, "Middlebury"),
                            split=name.replace("middlebury_", ""))
        elif name == "sceneflow":
            ds = SceneFlowDatasets(aug_params, root=osp.join(root, "SceneFlow"),
                                   dstype="frames_finalpass")
        elif "kitti" in name:
            ds = KITTI(aug_params, root=osp.join(root, "KITTI"), image_set=name)
        elif name == "sintel_stereo":
            ds = SintelStereo(aug_params, root=osp.join(root, "SintelStereo")) * 140
        elif name == "falling_things":
            ds = FallingThings(aug_params, root=osp.join(root, "FallingThings")) * 5
        elif name.startswith("tartan_air"):
            ds = TartanAir(aug_params, root=root, keywords=name.split("_")[2:])
        elif name == "carla":
            ds = Carla(aug_params, root=osp.join(root, "Carla"))
        elif name.startswith("synthetic"):
            # dataset-free random-dot stereograms (new; for smoke/e2e runs):
            # "synthetic" or "synthetic_<size>x<H>x<W>"
            from .synthetic import SyntheticStereoDataset

            spec = name.split("_")[1] if "_" in name else ""
            size, h, w = (map(int, spec.split("x")) if spec else (64, 256, 512))
            ds = SyntheticStereoDataset(size=size, height=h, width=w)
        else:
            raise ValueError(f"Unknown train dataset {name}")
        logger.info(f"Adding {len(ds)} samples from {name}")
        parts.append(ds)
    if len(parts) == 1:
        return parts[0]
    return ConcatStereoDataset(parts)


def build_val_dataset(cfg, dataset_name):
    """Per-name validation dataset (reference build_val_loader, datasets.py:409-425)."""
    root = cfg.DATASETS.ROOT
    if dataset_name == "things":
        return SceneFlowDatasets(root=osp.join(root, "SceneFlow"),
                                 dstype="frames_finalpass", things_test=True)
    if "kitti" in dataset_name:
        return KITTI(root=osp.join(root, "KITTI"), image_set=dataset_name)
    if dataset_name == "eth3d":
        return ETH3D(root=osp.join(root, "ETH3D"), split="training")
    if dataset_name.startswith("middlebury_"):
        return Middlebury(root=osp.join(root, "Middlebury"),
                          split=dataset_name.replace("middlebury_", ""))
    if dataset_name.startswith("synthetic"):
        from .synthetic import SyntheticStereoDataset

        spec = dataset_name.split("_")[1] if "_" in dataset_name else ""
        size, h, w = (map(int, spec.split("x")) if spec else (16, 256, 512))
        return SyntheticStereoDataset(size=size, height=h, width=w, seed=7)
    raise ValueError(f"Unknown dataset: '{dataset_name}'")
