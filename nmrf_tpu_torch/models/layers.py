"""Common layers of the port (``nmrf_tpu/models/layers.py``).

Compute-dtype convention, mirroring flax's ``dtype`` argument in the JAX
package: parameters are stored in float32; a layer built with
``dtype=torch.bfloat16`` casts its input and parameters to bf16 and returns
bf16, and a layer with ``dtype=None`` computes in the promotion of its input
and float32 (so float32 for a bf16 input).  Norms compute in float32.

Numerical-parity notes:
  * LayerNorm eps = 1e-5 (torch default) unless given (the swin adaptor's
    norms use 1e-6).
  * GELU is the exact erf form; ``GELU(approximate=True)`` lowers it to the
    tanh form for bf16 inputs only (``TPU.GELU_APPROX``), as a per-module
    attribute.
  * InstanceNorm2d: affine-free, eps=1e-5, single-pass f32 moments.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import halo_exchange_h, instance_norm_2d_sharded


def _dt(dtype, x):
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def to_dtype(x, dtype):
    """x cast to a layer's compute dtype; unchanged when it is None."""
    return x.to(dtype) if dtype is not None else x


class Linear(nn.Linear):
    """``nn.Linear`` with the compute-dtype convention above."""

    def __init__(self, in_features, out_features, bias=True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _dt(self.compute_dtype, x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channel-last [B, H, W, C] tensors with the compute-
    dtype convention above (``groups=in_ch`` for a depthwise convolution).

    spatial: the spatial group when x is an H tile of the image
    (``parallel/spatial.py``), the tile starting on a global row that is a
    multiple of the stride.  The rows the tile's outputs read beyond it
    come from the neighbour tiles (:meth:`halo_rows`; zero rows at the
    global edges, as the zero padding) and the convolution runs with H
    padding 0: the output is the tile of the unsharded output.  The halo
    exchanges are counted under ``site``."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 dilation=1, bias=True, groups=1, dtype=None, spatial=None,
                 site="halo"):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups,
                         bias=bias)
        self.compute_dtype = dtype
        self.spatial = spatial
        self.site = site

    def halo_rows(self):
        """(above, below): the input rows beyond an H tile that its outputs
        read.  Output row o reads input rows s o - p + d j, j < k, so a
        tile of input rows [t, t + h) (t and h multiples of s) gives
        outputs [t / s, (t + h) / s) that read rows t - p to
        t + h - s - p + d (k - 1)."""
        k, s, p, d = (self.kernel_size[0], self.stride[0], self.padding[0],
                      self.dilation[0])
        return p, d * (k - 1) - p - (s - 1)

    def forward(self, x):
        padding = self.padding
        if self.spatial is not None:
            if x.shape[1] % self.stride[0]:
                raise ValueError(f"tile height {x.shape[1]} is not a multiple "
                                 f"of the stride {self.stride[0]}")
            above, below = self.halo_rows()
            halo = max(above, below)
            if halo:
                x = halo_exchange_h(x, halo, self.spatial,
                                    site=self.site).narrow(
                    1, halo - above, above + x.shape[1] + below)
            padding = (0, self.padding[1])
        dt = _dt(self.compute_dtype, x)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     self.stride, padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` over the last axis of [M, C, L] with the compute-dtype
    convention above."""

    def __init__(self, in_ch, out_ch, kernel_size, padding=0, dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = _dt(self.compute_dtype, x)
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5 unless given) computed and returned in float32."""

    def __init__(self, dim, eps=1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GELU(nn.Module):
    """Exact GELU; with ``approximate`` the tanh form for bf16 inputs."""

    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        tanh = self.approximate and x.dtype == torch.bfloat16
        return F.gelu(x, approximate="tanh" if tanh else "none")


class DropPathMasks:
    """The source of drop-path's per-sample keep masks: one explicit
    ``torch.Generator`` (no global RNG), shared by every :class:`DropPath`
    of a model (``build_model`` seeds it from ``cfg.SEED`` on the model's
    device).  ``draw`` is the one place a mask comes from, so a test may
    replace it (or ``draw_global``) to replay given masks.

    On a data axis of ``data_size`` ranks (``build_model(cfg, mesh=)``)
    every rank seeds its generator alike and draws the mask of the global
    batch, as the JAX package's one jit over the global batch draws it, and
    keeps its own rows.  Every drop-path of the model lies in the backbone,
    whose batch is the two images of each pair stacked
    (``NMRF.extract_feature``: [img1; img2]), so the global batch is
    [img1 of every rank; img2 of every rank] and a rank's rows are its own
    slice of each half."""

    def __init__(self, generator, data_index=0, data_size=1):
        self.generator = generator
        self.data_index, self.data_size = data_index, data_size

    def draw_global(self, batch, keep):
        """[batch] bool, each True with probability ``keep``."""
        return torch.rand(batch, generator=self.generator,
                          device=self.generator.device) < keep

    def draw(self, batch, keep):
        """This rank's [batch] bool keep mask, each True with probability
        ``keep``: rows of one global draw on a data axis."""
        if self.data_size == 1:
            return self.draw_global(batch, keep)
        if batch % 2:
            raise ValueError(f"batch {batch} is not the two images of pairs")
        full = self.draw_global(batch * self.data_size, keep)
        return full.reshape(2, self.data_size, batch // 2)[
            :, self.data_index].reshape(batch)


def set_drop_path_masks(module, masks):
    """Give every :class:`DropPath` under ``module`` the mask source
    ``masks``."""
    for m in module.modules():
        if isinstance(m, DropPath):
            m.masks = masks


class DropPath(nn.Module):
    """Stochastic depth per sample (``nmrf_tpu/models/layers.py:DropPath``):
    the identity in eval mode or at rate 0; in training each call draws a
    keep mask of shape (B,) + (1,) * (ndim - 1) from its
    :class:`DropPathMasks` and returns ``where(mask, x / keep, 0)`` in x's
    dtype.  Draw outside any ``torch.utils.checkpoint`` region: a recompute
    restores the default generators only, not an explicit one."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = float(rate)
        self.masks = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.masks is None:
            raise RuntimeError("DropPath in training needs a mask source: "
                               "build_model sets one (set_drop_path_masks)")
        keep = 1.0 - self.rate
        mask = self.masks.draw(x.shape[0], keep).to(x.device)
        mask = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, 0.0)


def instance_norm_2d(x, eps=1e-5):
    """Affine-free instance norm over the spatial dims of [B, H, W, C].
    Moments are single-pass E[x^2] - E[x]^2 in float32; returns float32."""
    xf = x.float()
    n = x.shape[1] * x.shape[2]
    s1 = xf.sum(dim=(1, 2), keepdim=True)
    s2 = (xf * xf).sum(dim=(1, 2), keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps)


def instance_norm(x, spatial=None, site="moments"):
    """:func:`instance_norm_2d`, or with a spatial group (x an H tile) the
    global moments of ``instance_norm_2d_sharded`` (counted under
    ``site``); float32."""
    if spatial is None:
        return instance_norm_2d(x)
    return instance_norm_2d_sharded(x, spatial, site=site)


class Mlp(nn.Module):
    """timm-style MLP: fc1 -> act -> fc2 (dropout is training-only)."""

    def __init__(self, in_features, hidden_features, out_features, act=None,
                 dtype=None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.act = act if act is not None else GELU()
        self.fc2 = Linear(hidden_features, out_features, dtype=dtype)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class MLPBlock(nn.Module):
    """Reference plain MLP (``NMP.py:54-66``): n Linear layers, ReLU between."""

    def __init__(self, in_dim, hidden_dim, output_dim, num_layers, dtype=None):
        super().__init__()
        dims_in = [in_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o, dtype=dtype) for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class ConvINReluConv(nn.Module):
    """Conv3x3 (no bias) -> InstanceNorm -> ReLU -> Conv1x1 (no bias), the
    projection stack of concatconv/gw/context (``NMRF.py:56-65``).  The
    convolutions are registered as ``0`` and ``3``, the indices of the
    reference's ``nn.Sequential``.

    spatial: the spatial group when x is an H tile of the image
    (``parallel/spatial.py``): the 3x3 convolution then takes a 1-row halo
    from each neighbour tile (zero rows at the global edges, as the 'same'
    zero padding) with H padding 0, and the instance norm's moments are
    global (``layers.py:180-215``)."""

    def __init__(self, in_channels, mid_channels, out_channels, dtype=None,
                 spatial=None):
        super().__init__()
        self.dtype = dtype
        self.spatial = spatial
        self.add_module("0", Conv2d(in_channels, mid_channels, 3, padding=1,
                                    bias=False, dtype=dtype, spatial=spatial))
        self.add_module("3", Conv2d(mid_channels, out_channels, 1, bias=False,
                                    dtype=dtype))

    def forward(self, x):
        x = instance_norm(self._modules["0"](x), self.spatial)
        if self.dtype is not None:
            x = x.to(self.dtype)
        return self._modules["3"](torch.relu(x))
