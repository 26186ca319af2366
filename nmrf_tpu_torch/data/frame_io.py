"""Frame I/O, the port's copy of ``nmrf_tpu/data/frame_io.py`` (reference
``frame_utils.py:15-281``): image and disparity readers, the KITTI
submission writer and ``InputPadder``.  Each disparity reader returns
(disparity, valid).

PIL and OpenCV are imported inside the functions that need them, so the
synthetic path and the padder run without either.  OpenCV is used where it
is installed, as in the JAX package, else PIL.
"""

import json
import math
import os
import re
from os.path import basename, exists, splitext

import numpy as np
import torch


def _cv2():
    """OpenCV, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
    return cv2


def _pil_image():
    from PIL import Image

    return Image


def read_flow(fn):
    """Middlebury .flo reader (reference frame_utils.py:15-34)."""
    with open(fn, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            raise ValueError(f"Invalid .flo magic in {fn}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        return np.resize(data, (h, w, 2))


def read_pfm(file):
    """PFM reader (reference frame_utils.py:36-71)."""
    with open(file, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape))


def write_pfm(file, array):
    if splitext(file)[1] != ".pfm" or array.ndim != 2:
        raise ValueError("write_pfm takes a .pfm path and a 2-D array")
    with open(file, "wb") as f:
        H, W = array.shape
        f.write(b"Pf\n" + f"{W} {H}\n".encode() + b"-1\n")
        f.write(np.flip(array, axis=0).astype(np.float32).tobytes())


def _imread_anydepth(filename):
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.imread(filename, cv2.IMREAD_ANYDEPTH)
    return np.asarray(_pil_image().open(filename))


def read_disp_kitti(filename):
    """KITTI 16-bit PNG disparity (reference frame_utils.py:127-130)."""
    disp = _imread_anydepth(filename).astype(np.float32) / 256.0
    return disp, disp > 0.0


def read_disp_vkitti(filename):
    cv2 = _cv2()
    depth = (cv2.imread(filename, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
             if cv2 is not None else np.asarray(_pil_image().open(filename)))
    depth = depth.astype(np.float32)
    f, baseline = 725.0087, 0.532725
    disp = f * baseline * 100 / depth
    return disp, disp > 0.59


def read_disp_carla(filename, max_depth_frac=0.9):
    """Carla depth-RGB encoding (reference frame_utils.py:143-163)."""
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imread(filename).astype(np.float32)
    else:
        bgr = np.asarray(_pil_image().open(filename)).astype(np.float32)[..., ::-1]
    normalized_depth = np.dot(bgr, [65536.0, 256.0, 1.0]) / 16777215.0
    depth = normalized_depth * 1000.0
    valid = normalized_depth < max_depth_frac
    baseline, image_width, image_fov = 0.5, 1392, 72
    f = image_width / (2.0 * math.tan(image_fov * math.pi / 360.0))
    with np.errstate(divide="ignore"):
        disp = f * baseline / depth
    disp[~valid] = 0
    return disp, valid


def read_disp_argoverse(filename):
    disp = _imread_anydepth(filename).astype(np.float32) / 256.0
    return disp, disp > 0


def read_disp_sintel(file_name):
    """Sintel RGB-packed disparity and occlusion mask
    (reference frame_utils.py:187-193)."""
    Image = _pil_image()
    a = np.array(Image.open(file_name))
    d_r, d_g, d_b = np.split(a, axis=2, indices_or_sections=3)
    disp = (d_r * 4 + d_g / (2 ** 6) + d_b / (2 ** 14))[..., 0]
    mask = np.array(Image.open(file_name.replace("disparities", "occlusions")))
    valid = (mask == 0) & (disp > 0)
    return disp, valid


def read_disp_fallingthings(file_name):
    a = np.array(_pil_image().open(file_name))
    with open(os.path.join(os.path.dirname(file_name), "_camera_settings.json")) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a.astype(np.float32)
    return disp, disp > 0


def read_disp_tartanair(file_name):
    depth = np.load(file_name)
    disp = 80.0 / depth
    return disp, disp > 0


def read_disp_middlebury(file_name):
    if basename(file_name) == "disp0GT.pfm":
        disp = read_pfm(file_name).astype(np.float32)
        nocc = file_name.replace("disp0GT.pfm", "mask0nocc.png")
        if not exists(nocc):
            raise FileNotFoundError(nocc)
        valid = np.asarray(_pil_image().open(nocc)) == 255
        return disp, valid
    if basename(file_name) == "disp0.pfm":
        disp = read_pfm(file_name).astype(np.float32)
        return disp, disp < 1e3
    raise ValueError(file_name)


def write_disp_kitti(filename, disp):
    """KITTI submission writer: uint16 x256 (reference
    frame_utils.py:237-239), OpenCV where installed, else PIL."""
    out = np.round(np.asarray(disp) * 256).astype(np.uint16)
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(filename, out)
    else:
        _pil_image().fromarray(out).save(filename)


def read_gen(file_name):
    """Generic reader (reference frame_utils.py:242-256)."""
    ext = splitext(file_name)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return _pil_image().open(file_name)
    if ext in (".bin", ".raw"):
        return np.load(file_name)
    if ext == ".flo":
        return read_flow(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(file_name).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []


class InputPadder:
    """Pad [.., H, W(, C)] arrays to divisibility.

    Channel-last variant with numpy edge-replication (``pad_tensor``: the
    same on a torch tensor, on its device).  mode='proposal' pads
    right/bottom only (the NMRF eval mode).
    """

    def __init__(self, dims, mode="sintel", divis_by=8):
        self.ht, self.wd = dims[:2]
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        elif mode == "proposal":
            self._pad = [0, pad_wd, 0, pad_ht]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        """inputs: [H, W, C] or [B, H, W, C] numpy arrays."""
        out = []
        for x in inputs:
            h_axis = x.ndim - 3 if x.ndim >= 3 else 0
            pads = [(0, 0)] * x.ndim
            pads[h_axis] = (self._pad[2], self._pad[3])
            pads[h_axis + 1] = (self._pad[0], self._pad[1])
            out.append(np.pad(x, pads, mode="edge"))
        return out

    def pad_tensor(self, x):
        """x: a [B, H, W, C] tensor of any dtype.  The float32 tensor on its
        device that ``pad`` makes of ``x`` cast to float32: the cast into a
        new tensor's middle, then the edge rows and the edge columns, each
        side one slice copy (three launches in proposal mode)."""
        left, right, top, bottom = self._pad
        B, H, W, C = x.shape
        out = x.new_empty((B, top + H + bottom, left + W + right, C),
                          dtype=torch.float32)
        cols = slice(left, left + W)
        out[:, top:top + H, cols] = x
        out[:, :top, cols] = out[:, top:top + 1, cols]
        out[:, top + H:, cols] = out[:, top + H - 1:top + H, cols]
        out[:, :, :left] = out[:, :, left:left + 1]
        out[:, :, left + W:] = out[:, :, left + W - 1:left + W]
        return out

    def unpad(self, x):
        """x: [..., H, W] array (disparity)."""
        ht, wd = x.shape[-2:]
        return x[..., self._pad[2]:ht - self._pad[3],
                 self._pad[0]:wd - self._pad[1]]
