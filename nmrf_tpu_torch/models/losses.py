"""NMRF training criterion (``nmrf_tpu/models/losses.py``; reference
``Criterion``, ``nmrf/models/NMRF.py:276-429``, and the loss weights of
``build``, ``NMRF.py:432-447``).

Boolean-indexed reductions are masked sums and the reference's "dummy loss
when no pixel is valid" branches are ``where(count > 0, loss, 0)``, as in
the JAX package.  ``fix_proposal_weight`` keeps the JAX package's repair of
the reference defect that weights the proposal loss under a key no loss
has (True weights ``loss_prop`` at 1.0; False reproduces the defect).
"""

import torch

from ..ops.histogram import soft_histogram


def smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def l1(x, y):
    return (x - y).abs()


def _masked_mean(x, mask):
    cnt = mask.sum()
    return torch.where(cnt > 0, (x * mask).sum() / cnt.clamp(min=1), 0.0)


def _cells(x):
    """[B, H, W] -> [B, H/8 * W/8, 64], the 8x8 cells of the 1/8 grid."""
    B, H, W = x.shape
    x = x.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(B, -1, 64)


class Criterion:
    """Loss aggregator over the model's output dict (no parameters)."""

    def __init__(self, max_disp=192, loss_type="L1",
                 loss_weights=(1.0,) * 10, aux_loss=True,
                 fix_proposal_weight=True, num_infer_layers=5,
                 num_refine_layers=5):
        if loss_type not in ("L1", "SMOOTH_L1"):
            raise ValueError(f"loss type {loss_type!r}")
        self.max_disp = max_disp
        self.loss_fn = smooth_l1 if loss_type == "SMOOTH_L1" else l1
        self.loss_weights = list(loss_weights)
        self.aux_loss = aux_loss
        self.fix_proposal_weight = fix_proposal_weight
        self.num_infer_layers = num_infer_layers
        self.num_refine_layers = num_refine_layers

    # ---- individual losses (reference NMRF.py:301-385) ---- #

    def loss_prop(self, disp_prop, gt_disp):
        """disp_prop: [B, hw, N] (already x8); gt_disp: [B, H, W].  Each
        ground-truth pixel is matched to its nearest proposal (first winner
        on ties)."""
        tgt = _cells(torch.where(gt_disp >= 320, 0.0, gt_disp))  # [B, hw, 64]
        dist = (tgt[..., None] - disp_prop[:, :, None, :]).abs()
        idx = torch.argmin(dist, dim=-1, keepdim=True)
        src = torch.gather(disp_prop[:, :, None, :].expand(dist.shape), -1,
                           idx).squeeze(-1)
        mask = (tgt > 0) & (tgt < self.max_disp)
        loss = (smooth_l1(src, tgt) * mask).sum() / (mask.sum() + 1e-6)
        return {"loss_prop": loss}

    def loss_init(self, prob, gt_disp):
        """prob: [B*h*w, D]; gt_disp: [B, H, W] (H = 8h)."""
        nd = prob.shape[-1]
        W = gt_disp.shape[-1]
        gt = gt_disp.clamp(min=0.0)
        valid = (gt > 0) & (gt < 320)
        coord = torch.arange(W, dtype=gt.dtype, device=gt.device) - gt
        valid = valid & (coord >= 0)
        w = valid.to(gt.dtype)
        label = soft_histogram(_cells(gt / 8.0).reshape(-1, 64),
                               _cells(w).reshape(-1, 64), nd)
        label = label / label.sum(-1, keepdim=True).clamp(min=1e-3)
        log_prob = -(torch.log(prob.clamp(min=1e-6)) * label).sum()
        valid_pixs = (_cells(w).reshape(-1, 64).sum(-1) > 0).sum()
        return {"init": log_prob / (valid_pixs + 1e-6)}

    def loss_coarse(self, disp_pred, logits_pred, disp_gt):
        """disp_pred/logits_pred: [B, H, W, N] (pred already x8)."""
        mask = (disp_gt > 0) & (disp_gt < self.max_disp)
        prob = torch.softmax(logits_pred, dim=-1)
        err = self.loss_fn(disp_pred, disp_gt[..., None])
        return {"loss_coarse_disp": _masked_mean((prob * err).sum(-1), mask)}

    def loss_disp(self, disp_pred, disp_gt):
        mask = (disp_gt > 0) & (disp_gt < self.max_disp)
        return {"loss_disp": _masked_mean(self.loss_fn(disp_pred, disp_gt), mask)}

    # ---- aggregation (reference NMRF.py:387-429, build NMRF.py:432-447) ---- #

    def weight_dict(self):
        L_i, L_r = self.num_infer_layers, self.num_refine_layers
        w = {"init": 1.0}
        if self.fix_proposal_weight:
            w["loss_prop"] = 1.0
        else:
            w["proposal_disp"] = 1.0  # reference defect: matches no loss
        lw = self.loss_weights
        if len(lw) != L_i + L_r:
            raise ValueError(f"{len(lw)} loss weights for {L_i} + {L_r} layers")
        if self.aux_loss:
            for i in range(L_i + L_r - 1):
                key = f"loss_coarse_disp_{i}" if i < L_i else f"loss_disp_{i}"
                w[key] = lw[i]
        w["loss_disp"] = lw[-1]
        return w

    def __call__(self, outputs, targets):
        """Dict of scalar losses, with 'total' and the metric 'epe_train'."""
        gt = torch.where(targets["valid"], targets["disp"], 0.0)
        losses = {}
        losses.update(self.loss_prop(outputs["proposal"] * 8.0, gt))
        losses.update(self.loss_init(outputs["prob"], gt))
        if "disp_pred" in outputs:
            losses.update(self.loss_disp(outputs["disp_pred"] * 4.0, gt))
        valid = (gt > 0) & (gt < self.max_disp)
        losses["epe_train"] = _masked_mean((outputs["disp"] - gt).abs(), valid)
        if self.aux_loss and "coarse_disp_layers" in outputs:
            coarse = outputs["coarse_disp_layers"]  # [L_i, B, H, W, N]
            logits = outputs["logits_layers"]
            L_i = coarse.shape[0]
            for i in range(L_i):
                losses[f"loss_coarse_disp_{i}"] = self.loss_coarse(
                    coarse[i] * 8.0, logits[i], gt)["loss_coarse_disp"]
            if "disp_pred_layers" in outputs:
                dpl = outputs["disp_pred_layers"]  # [L_r, B, H, W]
                for j in range(dpl.shape[0] - 1):
                    losses[f"loss_disp_{L_i + j}"] = self.loss_disp(
                        dpl[j] * 4.0, gt)["loss_disp"]
        wd = self.weight_dict()
        losses["total"] = sum(losses[k] * wd[k] for k in losses if k in wd)
        return losses
