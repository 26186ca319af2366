from .datasets import (
    ETH3D,
    KITTI,
    Carla,
    ConcatStereoDataset,
    FallingThings,
    Middlebury,
    SceneFlowDatasets,
    SintelStereo,
    StereoDataset,
    TartanAir,
    build_train_dataset,
    build_val_dataset,
)
from .frame_io import InputPadder
from .loader import InferenceSampler, PrefetchLoader, ShardedBatchSampler
from .synthetic import SyntheticStereoDataset, make_stereo_pair, synthetic_batch
from .transforms import FlowAugmentor, SparseFlowAugmentor

__all__ = ["Carla", "ConcatStereoDataset", "ETH3D", "FallingThings",
           "FlowAugmentor", "InferenceSampler", "InputPadder", "KITTI",
           "Middlebury", "PrefetchLoader", "SceneFlowDatasets",
           "ShardedBatchSampler", "SintelStereo", "SparseFlowAugmentor",
           "StereoDataset", "SyntheticStereoDataset", "TartanAir",
           "build_train_dataset", "build_val_dataset", "make_stereo_pair",
           "synthetic_batch"]
