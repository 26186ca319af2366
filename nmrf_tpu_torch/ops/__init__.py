from .attention import stripe_attention, window_attention
from .correlation import correlation_volume
from .encodings import fourier_coord_embed, fourier_grid_embed
from .nms import max_pool_1d_3, nms_topk_seeds
from .sampling import disp_warp, sample_cost

__all__ = [
    "correlation_volume",
    "disp_warp",
    "fourier_coord_embed",
    "fourier_grid_embed",
    "max_pool_1d_3",
    "nms_topk_seeds",
    "sample_cost",
    "stripe_attention",
    "window_attention",
]
