"""Disparity Proposal Network (``nmrf_tpu/models/dpn.py``; reference
``nmrf/models/DPN.py:11-134``):

1. modal extraction: Conv1d stack (G -> 8 -> 16 -> 1, k = 5) along
   disparity -> softmax -> 3-tap NMS -> top-k integer label seeds;
2. seed propagation: context projection + CSWin propagation layers +
   MLP head -> residual offsets; labels = relu(offsets + seeds).

Gradients reach the Conv1d stack only through ``prob`` (the seeds are
integers) and the propagation and its head only through the labels, as in
the JAX package.  With a spatial group the inputs are an H tile of the
image and the group reaches the context projection and the propagation
(``dpn.py:70-93``).
"""

import torch
from torch import nn

from ..ops.nms import nms_topk_seeds
from . import graphs
from .layers import Conv1d, ConvINReluConv, MLPBlock
from .stages import Propagation


class DPN(nn.Module):
    def __init__(self, cost_group, num_proposals, feat_dim, context_dim,
                 num_prop_layers, prop_embed_dim, mlp_ratio, split_size,
                 prop_n_heads, gelu_approx=False, normalize_before=False,
                 use_kernels=False, dtype=None, remat=False, spatial=None):
        super().__init__()
        self.num_proposals = num_proposals
        self.mlp = nn.Sequential(
            Conv1d(cost_group, 8, 5, padding=2, dtype=dtype), nn.ReLU(),
            Conv1d(8, 16, 5, padding=2, dtype=dtype), nn.ReLU(),
            Conv1d(16, 1, 5, padding=2, dtype=dtype))
        self.proj = ConvINReluConv(feat_dim, 128, context_dim, dtype=dtype,
                                   spatial=spatial)
        self.propagation = Propagation(
            prop_embed_dim, cost_group, num_prop_layers, mlp_ratio,
            context_dim, split_size, prop_n_heads, gelu_approx,
            normalize_before, use_kernels, dtype, remat, spatial)
        self.prop_head = MLPBlock(prop_embed_dim, prop_embed_dim, 1, 3)

    def forward(self, cost_volume, fmap1, replay=None):
        """cost_volume: [B, H, W, G, D]; fmap1: 1/8-res left features.
        Returns (prob [M, D], label_seeds [M, N], labels [1, M, N]).
        ``replay``: the forward's ``graphs.Segments`` on the graph path,
        which replays :meth:`propose` and returns fresh copies."""
        return graphs.call(replay, "dpn", self.propose, cost_volume, fmap1)

    def propose(self, cost_volume, fmap1):
        B, H, W, G, D = cost_volume.shape
        flat = cost_volume.reshape(B * H * W, G, D)
        cost = self.mlp(flat).squeeze(1).float()
        prob = torch.softmax(cost, dim=-1)
        label_seeds = nms_topk_seeds(prob, self.num_proposals)

        context = self.proj(fmap1)
        memory, seeds_f = self.propagation(flat, label_seeds, context)
        offsets = self.prop_head(memory.float()).squeeze(-1)
        offsets = offsets.reshape(offsets.shape[0], B * H * W,
                                  self.num_proposals)
        labels = torch.relu(offsets + seeds_f[None])
        return prob, label_seeds, labels
