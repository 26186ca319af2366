from .frame_io import InputPadder
from .synthetic import SyntheticStereoDataset, make_stereo_pair, synthetic_batch

__all__ = ["InputPadder", "SyntheticStereoDataset", "make_stereo_pair",
           "synthetic_batch"]
