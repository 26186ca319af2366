"""``predict``'s frames (CPU, tiny configs): they travel in the dtype the
caller gave and are cast to float32 and edge-padded by
``InputPadder.pad_tensor``.  The model's input and the returned disparity
are, bit for bit, those of numpy's float32 cast padded by
``np.pad(..., mode="edge")``: for uint8 and float32 frames padded in H
only, in W only, in both and in neither, and for the swin variant."""

import numpy as np
import pytest
import torch

from nmrf_tpu_torch import predict
from nmrf_tpu_torch.data.frame_io import InputPadder

from .test_torch_spans import few_threads, frames, model_of  # noqa: F401

SHAPES = {"pad_h": (60, 128), "pad_w": (64, 124), "pad_hw": (60, 124),
          "no_pad": (64, 128)}
CASES = [("resnet", dtype, pad) for dtype in ("uint8", "float32")
         for pad in SHAPES] + [("swin", "uint8", "pad_hw")]


def numpy_prep_predict(model, img1, img2):
    """The model's input and the disparity of the numpy prep: the float32
    cast padded by ``np.pad`` (``InputPadder.pad``)."""
    padder = InputPadder(img1.shape, mode="proposal", divis_by=model.divis_by)
    a, b = (torch.from_numpy(p[None]) for p in padder.pad(
        np.asarray(img1, np.float32), np.asarray(img2, np.float32)))
    with torch.inference_mode():
        disp = model(a, b)["disp"].float()
    return (a, b), padder.unpad(disp.numpy())[0]


@pytest.mark.parametrize("variant,dtype,pad", CASES,
                         ids=["-".join(c) for c in CASES])
def test_predict_matches_numpy_prep(variant, dtype, pad):
    model = model_of(variant)
    img1, img2 = frames(*SHAPES[pad], seed=2)
    if dtype == "float32":  # off the integers, as a caller's float frames
        img1, img2 = (x.astype(np.float32) + 0.375 for x in (img1, img2))
    seen = []
    model.register_forward_pre_hook(lambda module, args: seen.append(args))
    got = predict(model, img1, img2)
    want_in, want = numpy_prep_predict(model, img1, img2)
    for x, y in zip(seen[0], want_in):
        assert x.dtype == torch.float32 and x.shape == y.shape
        assert torch.equal(x, y)
    assert got.dtype == np.float32 and got.shape == img1.shape[:2]
    assert np.array_equal(got, want)
