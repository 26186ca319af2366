"""Model factory of the port (``nmrf_tpu/models/__init__.py``)."""

import torch
from torch import nn

from . import swin
from .adaptor import ConvFFN, MSDeformAttn, offset_bias_init
from .layers import (Conv1d, Conv2d, DropPathMasks, LayerNorm, Linear,
                     set_drop_path_masks)
from .losses import Criterion
from .nmp import WindowAttention
from .nmrf import NMRF

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nmrf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def init_weights(model, seed):
    """Seeded random weights with the JAX package's initializers: Linear
    trunc_normal(0.02) and zero bias, convolutions kaiming_normal(fan_out),
    depthwise positional convs torch's default uniform, LayerNorm ones and
    zeros, relative-position tables trunc_normal(0.02), zero last layer of
    the DPN head.  The swin variant's: the patch embedding trunc_normal(0.02);
    ``sampling_offsets`` a zero kernel and the directional grid bias (every
    sample within 4 level pixels at init), ``attention_weights`` zeros,
    ``value_proj``/``output_proj`` Xavier uniform, the ConvFFN depthwise
    kernel variance_scaling(2, fan_out, truncated normal)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                      generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (Conv2d, Conv1d)):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):  # depthwise positional conv
                bound = 1.0 / m.weight[0].numel() ** 0.5
                m.weight.uniform_(-bound, bound, generator=g)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_enc_table, std=0.02,
                                      a=-0.04, b=0.04, generator=g)
        # the swin variant's own initializers, over the generic ones above
        for m in model.modules():
            if isinstance(m, swin.WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02,
                                      a=-0.04, b=0.04, generator=g)
            elif isinstance(m, swin.PatchEmbed):
                nn.init.trunc_normal_(m.proj.weight, std=0.02, a=-0.04,
                                      b=0.04, generator=g)
            elif isinstance(m, MSDeformAttn):
                m.sampling_offsets.weight.zero_()
                m.sampling_offsets.bias.copy_(torch.from_numpy(offset_bias_init(
                    m.n_heads, m.n_levels, m.n_points)))
                m.attention_weights.weight.zero_()
                m.attention_weights.bias.zero_()
                for proj in (m.value_proj, m.output_proj):
                    bound = (6.0 / sum(proj.weight.shape)) ** 0.5
                    proj.weight.uniform_(-bound, bound, generator=g)
                    proj.bias.zero_()
            elif isinstance(m, ConvFFN):
                w = m.dwconv.dwconv.weight  # [C, 1, 3, 3]
                std = (2.0 / (w.shape[0] * w[0, 0].numel())) ** 0.5 \
                    / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=g)
        model.dpn.prop_head.layers[-1].weight.zero_()
    return model


_DROPOUT_KEYS = ("NMP.ATTN_DROP", "NMP.PROJ_DROP", "NMP.DROP_PATH",
                 "NMP.DROPOUT")


def build_model(cfg, device=None, mesh=None):
    """The NMRF model of a config tree, in eval mode (``model.train()`` for
    training), on ``device`` (CUDA unless given; raises when CUDA is
    absent).  Weights are random from ``cfg.SEED``; load trained ones with
    ``load_state_dict``.  ``BACKBONE.DROP_PATH`` (the swin backbone's
    stochastic depth) acts in training: its keep masks come from
    ``model.drop_path_masks``, a ``layers.DropPathMasks`` over a generator
    on the model's device seeded from ``cfg.SEED`` (on a mesh's data axis,
    every rank's rows of one mask of the global batch).

    mesh: a ``parallel.make_mesh`` process grid.  With a spatial axis above
    1 the model's decode region runs on H tiles of the features over the
    mesh's spatial group, and so does the backbone on H tiles of the
    images, with halo rows from the neighbour tiles (a Swin-T stage whose
    tile holds fewer than 7 rows, or an odd count before a merge, runs
    whole on every rank); drive either through
    ``parallel.make_sharded_forward`` or ``make_train_step(..., mesh=)``.
    The parameters are the same, so ``params_from_jax`` and
    ``load_state_dict`` apply unchanged.  The device is then the mesh's
    unless given."""
    if mesh is not None and device is None:
        device = mesh.device
    device = resolve_device(device)
    spatial = mesh.spatial_group if mesh is not None and mesh.spatial > 1 \
        else None
    for key in _DROPOUT_KEYS:
        node, name = key.split(".")
        if getattr(cfg, node)[name] != 0:
            raise ValueError(f"{key} = {getattr(cfg, node)[name]}: the port "
                             "has no dropout in the NMP stages yet (every "
                             "recipe sets 0)")
    model = NMRF(
        backbone_type=cfg.BACKBONE.MODEL_TYPE,
        backbone_out_channels=cfg.BACKBONE.OUT_CHANNELS,
        backbone_drop_path=cfg.BACKBONE.DROP_PATH,
        msda_tap_radius=cfg.TPU.MSDA_TAP_RADIUS,
        divis_by=cfg.DATASETS.DIVIS_BY,
        num_proposals=cfg.DPN.NUM_PROPOSALS,
        max_disp=cfg.DPN.MAX_DISP,
        cost_group=cfg.DPN.COST_GROUP,
        context_dim=cfg.DPN.CONTEXT_DIM,
        prop_embed_dim=cfg.NMP.PROP_EMBED_DIM,
        infer_embed_dim=cfg.NMP.INFER_EMBED_DIM,
        mlp_ratio=cfg.NMP.MLP_RATIO,
        split_size=cfg.NMP.SPLIT_SIZE,
        window_size=cfg.NMP.WINDOW_SIZE,
        refine_window_size=cfg.NMP.REFINE_WINDOW_SIZE,
        prop_n_heads=cfg.NMP.PROP_N_HEADS,
        infer_n_heads=cfg.NMP.INFER_N_HEADS,
        num_prop_layers=cfg.NMP.NUM_PROP_LAYERS,
        num_infer_layers=cfg.NMP.NUM_INFER_LAYERS,
        num_refine_layers=cfg.NMP.NUM_REFINE_LAYERS,
        with_refinement=cfg.NMP.WITH_REFINEMENT,
        normalize_before=cfg.NMP.NORMALIZE_BEFORE,
        gelu_approx=cfg.TPU.GELU_APPROX,
        use_kernels=cfg.TPU.USE_PALLAS,
        dtype=_DTYPES[cfg.TPU.COMPUTE_DTYPE],
        remat=cfg.TPU.REMAT,
        aux_loss=cfg.SOLVER.AUX_LOSS,
        return_intermediate=cfg.NMP.RETURN_INTERMEDIATE,
        spatial=spatial,
    )
    init_weights(model, cfg.SEED)
    model = model.to(device).eval()
    model.drop_path_masks = DropPathMasks(
        torch.Generator(device=device).manual_seed(max(int(cfg.SEED), 0)),
        *((mesh.data_index, mesh.data) if mesh is not None else ()))
    set_drop_path_masks(model, model.drop_path_masks)
    return model


def build_criterion(cfg):
    """The training criterion of a config tree
    (``nmrf_tpu/models/__init__.py:build_model``'s second result)."""
    return Criterion(
        max_disp=cfg.SOLVER.MAX_DISP,
        loss_type=cfg.SOLVER.LOSS_TYPE,
        loss_weights=cfg.SOLVER.LOSS_WEIGHTS,
        aux_loss=cfg.SOLVER.AUX_LOSS,
        fix_proposal_weight=cfg.SOLVER.FIX_PROPOSAL_LOSS_WEIGHT,
        num_infer_layers=cfg.NMP.NUM_INFER_LAYERS,
        num_refine_layers=cfg.NMP.NUM_REFINE_LAYERS,
    )


__all__ = ["NMRF", "Criterion", "build_criterion", "build_model",
           "init_weights", "resolve_device"]
