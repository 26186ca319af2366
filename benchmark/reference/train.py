"""The reference training step: the NMRF criterion (upstream
``NMRF.py:276-447``, with the proposal loss weighted), the six AdamW
parameter groups, the OneCycle schedule and the global gradient clip of
the published recipe (upstream ``main.py:186-244, 383-391``), in plain
float32 PyTorch.  ``spec`` holds a configuration's keys (the measured
package's config names, ``SOLVER.BASE_LR``, ...)."""

import torch

from .model import choices
from .ops import soft_histogram


def smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def l1(x, y):
    return (x - y).abs()


def masked_mean(x, mask):
    cnt = mask.sum()
    return torch.where(cnt > 0, (x * mask).sum() / cnt.clamp(min=1), 0.0)


def cells(x):
    """[B, H, W] -> [B, H/8 W/8, 64]."""
    B, H, W = x.shape
    return x.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4).reshape(
        B, -1, 64)


class Criterion:
    def __init__(self, spec):
        if not spec.get("SOLVER.FIX_PROPOSAL_LOSS_WEIGHT", True):
            raise ValueError("the reference weights the proposal loss")
        self.max_disp = spec["SOLVER.MAX_DISP"]
        self.loss_fn = smooth_l1 if spec["SOLVER.LOSS_TYPE"] == "SMOOTH_L1" \
            else l1
        self.weights = list(spec["SOLVER.LOSS_WEIGHTS"])
        self.L_i = spec["NMP.NUM_INFER_LAYERS"]
        self.L_r = spec["NMP.NUM_REFINE_LAYERS"]

    def loss_prop(self, prop, gt):
        tgt = cells(torch.where(gt >= 320, 0.0, gt))
        dist = (tgt[..., None] - prop[:, :, None, :]).abs()
        idx = torch.argmin(dist, dim=-1, keepdim=True)
        src = torch.gather(prop[:, :, None, :].expand(dist.shape), -1,
                           idx).squeeze(-1)
        mask = (tgt > 0) & (tgt < self.max_disp)
        return (smooth_l1(src, tgt) * mask).sum() / (mask.sum() + 1e-6)

    def loss_init(self, prob, gt):
        W = gt.shape[-1]
        gt = gt.clamp(min=0.0)
        valid = (gt > 0) & (gt < 320)
        valid = valid & (torch.arange(W, device=gt.device) - gt >= 0)
        w = valid.float()
        label = soft_histogram(cells(gt / 8.0).reshape(-1, 64),
                               cells(w).reshape(-1, 64), prob.shape[-1])
        label = label / label.sum(-1, keepdim=True).clamp(min=1e-3)
        nll = -(torch.log(prob.clamp(min=1e-6)) * label).sum()
        return nll / ((cells(w).reshape(-1, 64).sum(-1) > 0).sum() + 1e-6)

    def loss_disp(self, pred, gt):
        mask = (gt > 0) & (gt < self.max_disp)
        return masked_mean(self.loss_fn(pred, gt), mask)

    def loss_coarse(self, pred, logits, gt):
        mask = (gt > 0) & (gt < self.max_disp)
        err = self.loss_fn(pred, gt[..., None])
        return masked_mean((torch.softmax(logits, -1) * err).sum(-1), mask)

    def __call__(self, out, disp, valid):
        """The weighted total loss of the model's outputs."""
        gt = torch.where(valid, disp, 0.0)
        total = self.loss_prop(out["proposal"] * 8.0, gt) \
            + self.loss_init(out["prob"], gt) \
            + self.weights[-1] * self.loss_disp(out["disp_pred"] * 4.0, gt)
        coarse, logits = out["coarse_disp_layers"], out["logits_layers"]
        for i in range(self.L_i):
            total = total + self.weights[i] * self.loss_coarse(
                coarse[i] * 8.0, logits[i], gt)
        dpl = out["disp_pred_layers"]
        for j in range(self.L_r - 1):
            total = total + self.weights[self.L_i + j] * self.loss_disp(
                dpl[j] * 4.0, gt)
        return total


def param_group(name):
    """The optimizer group of a parameter by its upstream name."""
    parts = name.split(".")
    leaf = parts[-1]
    if name.startswith("backbone.backbone."):
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


def optimizer(model, spec):
    """(AdamW over the recipe's groups, its OneCycle schedule)."""
    lr, wd = spec["SOLVER.BASE_LR"], spec["SOLVER.WEIGHT_DECAY"]
    decay = spec["SOLVER.BACKBONE_LR_DECAY"]
    rules = {"default": (1.0, wd), "offset": (0.1, wd),
             "norm": (1.0, spec["SOLVER.WEIGHT_DECAY_NORM"]),
             "backbone": (decay, spec["SOLVER.BACKBONE_WEIGHT_DECAY"]),
             "backbone_rpb": (decay, 0.0),
             "rpe": (1.0, 0.0)}
    params = {g: [] for g in rules}
    for name, p in model.named_parameters():
        params[param_group(name)].append(p)
    groups = [{"params": params[g], "lr": rules[g][0] * lr,
               "weight_decay": rules[g][1]} for g in rules if params[g]]
    opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=[g["lr"] for g in groups],
        total_steps=spec["SOLVER.MAX_ITER"] + 100, anneal_strategy="cos",
        cycle_momentum=False, pct_start=0.05, div_factor=25.0,
        final_div_factor=1e4)
    return opt, sched


def train_steps(model, crit, opt, sched, batches, grad_clip, force=None):
    """One update per batch, each forward with its ``force`` (a list, one
    a step, or None); returns {"loss": [each step's total], "grad": {name:
    the clipped gradient of the first step}, "force": [each step's
    integer choices, :func:`~.model.choices`]}."""
    model.train()
    params = dict(model.named_parameters())
    losses, first, made = [], None, []
    for i, batch in enumerate(batches):
        f = None if force is None else {
            k: v.to(batch["img1"].device) for k, v in force[i].items()}
        out = model(batch["img1"], batch["img2"], f)
        made.append(choices(out))
        loss = crit(out, batch["disp"], batch["valid"])
        del out
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), grad_clip)
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in params.items()
                     if p.grad is not None}
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad": first, "force": made}
