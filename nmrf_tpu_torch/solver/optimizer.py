"""Optimizer and LR schedule (``nmrf_tpu/solver/optimizer.py``; reference
``build_optimizer``, ``main.py:186-244``, and OneCycleLR, ``main.py:383-391``).

Six parameter groups keyed on the port's torch names, AdamW (betas 0.9,
0.999, eps 1e-8) per group, and the OneCycle cosine schedule over
``MAX_ITER + 100`` steps.  AdamW's update, ``p <- p - lr (m_hat /
(sqrt(v_hat) + eps) + wd p)``, is the JAX package's ``scale_by_adam`` +
``add_decayed_weights`` + ``-lr`` chain; gradients are clipped to a global
norm of ``SOLVER.GRAD_CLIP`` first (``make_train_step``).
"""

import torch

# group name -> (lr multiplier, weight decay); see build_optimizer
GROUPS = ("default", "offset", "norm", "backbone", "backbone_rpb", "rpe")


def param_group(name):
    """The optimizer group of a parameter, by its torch name (the rules of
    the JAX package's ``label_params`` on its flax paths)."""
    parts = name.split(".")
    leaf = parts[-1]
    if name.startswith("backbone.backbone."):  # the swin backbone
        return "backbone_rpb" if "relative_position_bias_table" in leaf \
            else "backbone"
    if "sampling_offsets" in name:
        return "offset"
    if "relative_position_enc_table" in leaf:
        return "rpe"
    if len(parts) >= 2 and parts[-2].startswith("norm") \
            and leaf in ("weight", "bias"):
        return "norm"
    return "default"


def build_optimizer(model, cfg):
    """(torch.optim.AdamW over the six groups, torch's OneCycleLR with the
    cosine anneal over ``MAX_ITER + 100`` updates, each group peaking at its
    own lr).  Call ``scheduler.step()`` after every update."""
    base_lr = cfg.SOLVER.BASE_LR
    wd = cfg.SOLVER.WEIGHT_DECAY
    spec = {
        "default": (1.0, wd),
        "offset": (0.1, wd),
        "norm": (1.0, cfg.SOLVER.WEIGHT_DECAY_NORM),
        "backbone": (cfg.SOLVER.BACKBONE_LR_DECAY,
                     cfg.SOLVER.BACKBONE_WEIGHT_DECAY),
        "backbone_rpb": (cfg.SOLVER.BACKBONE_LR_DECAY, 0.0),
        "rpe": (1.0, 0.0),
    }
    params = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if p.requires_grad:
            params[param_group(name)].append(p)
    groups = [{"params": params[g], "lr": spec[g][0] * base_lr,
               "weight_decay": spec[g][1], "name": g}
              for g in GROUPS if params[g]]
    optimizer = torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999),
                                  eps=1e-8)
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=[g["lr"] for g in groups],
        total_steps=cfg.SOLVER.MAX_ITER + 100, anneal_strategy="cos",
        cycle_momentum=False, pct_start=0.05, div_factor=25.0,
        final_div_factor=1e4)
    return optimizer, scheduler
