"""Ahead-of-time export of the eval forward as a serialized artifact (the
port's ``nmrf_tpu/utils/export.py``).

``export_eval`` runs ``torch.export.export`` over the model's eval forward
at one static padded shape ``(B, H, W, 3)`` of float32 0-255 images.  On
the card the kernels K1, K2 and (swin) B5 appear in the graph as the
registered operators ``nmrf::window_attention``, ``nmrf::stripe_attention``
and ``nmrf::msda_taps`` (``ops/library.py``), one node per launch, so a
call of the loaded artifact launches the hand-written kernels and counts
its launches in their wrappers.  On the CPU the graph holds the plain
versions instead.

Contract of the artifact's module (``load_exported(path).module()``):
``(img1, img2) -> {"disp": [B, H, W] f32, ...}`` (the model's eval
outputs) with inputs of exactly the exported shape on the exported device;
callers pad with ``data.frame_io.InputPadder(mode="proposal")`` as
``inference.predict`` does.  Another shape raises.  ``freeze_params`` False
exports ``(params, img1, img2)`` instead, ``params`` the model's
``dict(named_parameters())`` (weight hot-swap through
``torch.func.functional_call``).
"""

import json
import os

import torch

MAGIC = "nmrf-tpu-torch-exported-v1"


class _HotSwap(torch.nn.Module):
    """``(params, img1, img2) -> model outputs`` with the parameters taken
    from the call, not the module (the model is held outside the module
    tree, so the artifact carries no weights of its own)."""

    def __init__(self, model):
        super().__init__()
        self._model = [model]

    def forward(self, params, img1, img2):
        return torch.func.functional_call(self._model[0], params, (img1, img2))


def export_eval(model, input_shape, freeze_params=True):
    """Export the eval forward of ``model`` for ``input_shape`` = (B, H, W,
    3) on the model's device, under ``torch.no_grad``.  ``freeze_params``
    True bakes the weights into the artifact (called with images only);
    False exports the ``(params, img1, img2)`` convention.  Returns a
    ``torch.export.ExportedProgram``."""
    if model.training:
        raise ValueError("export_eval exports the eval forward: call "
                         "model.eval() first")
    device = next(model.parameters()).device
    # two tensors: one passed twice would trace as one aliased input
    images = tuple(torch.zeros(tuple(input_shape), dtype=torch.float32,
                               device=device) for _ in range(2))
    with torch.no_grad():
        if freeze_params:
            exported = torch.export.export(model, images, strict=False)
        else:
            params = {k: v.detach() for k, v in model.named_parameters()}
            exported = torch.export.export(_HotSwap(model), (params,) + images,
                                           strict=False)
    # the artifact does not carry the trace's inputs (in the hot-swap
    # convention they would be a copy of the weights)
    exported.example_inputs = None
    return exported


def input_spec(exported):
    """((B, H, W, 3), device) of the images an artifact was exported at."""
    spec = [s for s in exported.graph_signature.input_specs
            if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    val = {n.name: n for n in exported.graph.nodes}[spec[-1].arg.name].meta["val"]
    return tuple(int(d) for d in val.shape), val.device


def save_exported(exported, path, extra_meta=None):
    """Serialize to ``path`` (``torch.export.save``) with a JSON sidecar
    (``path + '.json'``): the magic, the device, the input shape, whether
    the weights are frozen in, the torch and CUDA versions and the
    operator namespace, updated with ``extra_meta``.  Returns the
    artifact's size in bytes."""
    from ..ops import library

    torch.export.save(exported, path)
    shape, device = input_spec(exported)
    meta = {
        "magic": MAGIC,
        "device": str(device),
        "input_shape": list(shape),
        "frozen_params": bool(exported.state_dict),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "op_namespace": library.NAMESPACE,
    }
    meta.update(extra_meta or {})
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return os.path.getsize(path)


def load_exported(path):
    """Load an artifact of :func:`save_exported`.  Registers the ``nmrf``
    operators first (``ops/library.py:register``), not the model code;
    call ``.module()`` on the result to run it."""
    from ..ops import library

    library.register()
    return torch.export.load(path)


def load_meta(path):
    """The JSON sidecar of an artifact ({} where there is none)."""
    sidecar = path + ".json"
    if not os.path.exists(sidecar):
        return {}
    with open(sidecar) as f:
        return json.load(f)
