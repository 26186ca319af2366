"""Carry weights from the JAX package's parameter tree to the port.

``params_from_jax`` is the inverse of the JAX package's torch -> flax
converter rules (``nmrf_tpu/utils/checkpoint.py:_RULES``, with the swin
variant's ``_ADAPTOR_RULES`` and ``_SWIN_RULES``), kept here as the port's
own table so the port imports nothing of ``nmrf_tpu``:

* the ``nn.scan`` stacks ``<stage>/layers/layer/...`` (leading axis L) are
  unstacked into ``<stage>.layers.<i>...``;
* Linear kernels [in, out] are transposed to [out, in];
* Conv kernels go from HWIO to OIHW (depthwise [3, 3, 1, dim] included,
  the ConvFFN's ``dwconv_kernel`` too) and
  Conv1d kernels from [k, in, out] to [out, in, k];
* LayerNorm ``scale`` becomes ``weight``.
"""

import re

import numpy as np
import torch

# (regex over the '/'-joined flax path, replacement) applied in order to give
# the '/'-joined torch path
_PATH_RULES = [
    (r"^backbone/layer(\d)_(\d)/", r"backbone/layer\1/\2/"),
    (r"/downsample/", r"/downsample/0/"),
    (r"^(concatconv|gw|dpn/proj)/conv1/", r"\1/0/"),
    (r"^(concatconv|gw|dpn/proj)/conv2/", r"\1/3/"),
    (r"/(mlp|cost_encoder|layers|attns)_(\d+)/", r"/\1/\2/"),
    # swin variant: DeformNeck (ConvStem convs at Sequential indices 0/3/6,
    # fcs = [LayerNorm, Linear], DWConv inside ConvFFN) and Swin-T
    (r"/stem_(\d)/", lambda m: f"/stem/{3 * int(m.group(1))}/"),
    (r"/fcs_(\d+)_norm/", r"/fcs/\1/0/"),
    (r"/fcs_(\d+)_linear/", r"/fcs/\1/1/"),
    (r"/extractors_(\d+)/", r"/extractors/\1/"),
    (r"/dwconv_(kernel|bias)$", r"/dwconv/dwconv/\1"),
    (r"/patch_embed_(proj|norm)/", r"/patch_embed/\1/"),
    (r"/layers_(\d+)_blocks_(\d+)/", r"/layers/\1/blocks/\2/"),
    (r"/layers_(\d+)_downsample/", r"/layers/\1/downsample/"),
    (r"/get_v_kernel$", r"/get_v/weight"),
    (r"/(kernel|scale)$", r"/weight"),
]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _unstack_scans(items):
    """Expand ``.../layers/layer/...`` leaves with a leading L axis into
    ``.../layers_<i>/...`` leaves."""
    for path, value in items:
        if "layers" in path and path[path.index("layers") + 1:][:1] == ("layer",):
            i = path.index("layers")
            for layer in range(value.shape[0]):
                yield path[:i] + (f"layers_{layer}",) + path[i + 2:], value[layer]
        else:
            yield path, value


def _to_torch_layout(path, value):
    leaf = path[-1]
    if leaf in ("kernel", "get_v_kernel", "dwconv_kernel"):
        if value.ndim == 2:
            return value.T
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
    return value


def params_from_jax(tree):
    """JAX params (nested dicts of arrays, with or without the top-level
    ``params`` key) -> the port's ``state_dict`` (float32 CPU tensors)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, value in _unstack_scans(_flatten(tree)):
        value = _to_torch_layout(path, value)
        key = "/".join(path)
        for pattern, repl in _PATH_RULES:
            key = re.sub(pattern, repl, key)
        state[key.replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return state
