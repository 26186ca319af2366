"""Input padding for evaluation (the port's copy of ``InputPadder`` from
``nmrf_tpu/data/frame_io.py``; reference ``frame_utils.py:259-281``)."""

import numpy as np


class InputPadder:
    """Pad [.., H, W(, C)] arrays to divisibility.

    Channel-last variant with numpy edge-replication.  mode='proposal' pads
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

    def unpad(self, x):
        """x: [..., H, W] array (disparity)."""
        ht, wd = x.shape[-2:]
        return x[..., self._pad[2]:ht - self._pad[3],
                 self._pad[0]:wd - self._pad[1]]
