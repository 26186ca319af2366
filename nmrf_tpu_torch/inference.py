"""Single-pair prediction, mirroring the JAX package's ``inference.py:predict``:
pad the pair with ``InputPadder`` in "proposal" mode to the config's
``DATASETS.DIVIS_BY`` (8 for resnet, 32 for swin), run the forward, unpad
the disparity."""

import numpy as np
import torch

from .data.frame_io import InputPadder


def predict(model, img1, img2, divis_by=None):
    """img1/img2: [H, W, 3] arrays (0..255).  Pads to ``divis_by`` (the
    model's ``divis_by``, recorded by ``build_model`` from the config, unless
    given), runs on the model's device under ``torch.inference_mode`` and
    returns the [H, W] float32 numpy disparity."""
    device = next(model.parameters()).device
    divis_by = model.divis_by if divis_by is None else divis_by
    padder = InputPadder(img1.shape, mode="proposal", divis_by=divis_by)
    p1, p2 = padder.pad(np.asarray(img1, np.float32), np.asarray(img2, np.float32))
    with torch.inference_mode():
        a = torch.from_numpy(p1[None]).to(device)
        b = torch.from_numpy(p2[None]).to(device)
        disp = model(a, b)["disp"]
    return padder.unpad(disp.float().cpu().numpy())[0]
