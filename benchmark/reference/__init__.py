"""The plain float32 NMRF reference of the benchmark (``model``, ``ops``,
``train``) and its seeded weights.  It imports nothing of the measured
package; the benchmark loads its ``state_dict`` into the measured model
by the upstream key names both use."""

import torch
from torch import nn

from .model import NMRF, DropPathMasks, choices, set_fp8


def build(spec, device):
    """The reference model of a configuration's ``model`` block, on
    ``device``, float32, in eval mode (weights uninitialised)."""
    return NMRF(spec).to(device).eval()


def _scales(model):
    """{name: (std, mean)} of each parameter's seeded draw: LayerNorm
    weights 1, biases 0, Linear weights and position tables std 0.02,
    convolutions Kaiming normal (fan out)."""
    out = {}
    for prefix, m in model.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            if isinstance(m, nn.LayerNorm):
                out[name] = (0.0, 1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                out[name] = (0.0, 0.0)
            elif p.dim() <= 2:
                out[name] = (0.02, 0.0)
            else:
                out[name] = ((2.0 / (p.shape[0] * p[0, 0].numel())) ** 0.5,
                             0.0)
    return out


@torch.no_grad()
def init_weights(model, seed):
    """Seeded weights, made on the model's device from one generator in
    one draw and scaled leaf by leaf (:func:`_scales`)."""
    params = list(model.named_parameters())
    scales = _scales(model)
    device = params[0][1].device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(p.numel() for _, p in params), generator=gen,
                       device=device)
    offset = 0
    for name, p in params:
        std, mean = scales[name]
        p.copy_(flat[offset:offset + p.numel()].view_as(p) * std + mean)
        offset += p.numel()
    return model


__all__ = ["DropPathMasks", "build", "choices", "init_weights", "set_fp8"]
