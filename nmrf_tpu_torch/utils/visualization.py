"""Disparity visualization, the port's copy of
``nmrf_tpu/utils/visualization.py`` (reference
``nmrf/utils/visualization.py``): the KITTI disparity colormap
(``kitti``), the 10-band KITTI error colormap, log-contrast-enhanced
disparity rendering with percentile clipping, the uncertainty heatmap.

matplotlib and OpenCV are imported at first use, and the ``kitti``
colormap is registered then, so the KITTI-submission CLI and the server
load without either.
"""

import numpy as np


def _mpl():
    """matplotlib with the ``kitti`` colormap registered."""
    import matplotlib as mpl

    if "kitti" not in mpl.colormaps:
        mpl.colormaps.register(gen_kitti_cmap())
    return mpl


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def plot_disparity(savename, data, max_disp):
    _mpl()
    import matplotlib.pyplot as plt

    plt.imsave(savename, data, vmin=0, vmax=max_disp, cmap="turbo")


def gen_error_colormap():
    """10-band KITTI-style error colormap (reference visualization.py:21-34)."""
    return np.array(
        [[0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
         [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
         [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
         [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
         [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
         [3 / 3.0, 6 / 3.0, 254, 224, 144],
         [6 / 3.0, 12 / 3.0, 253, 174, 97],
         [12 / 3.0, 24 / 3.0, 244, 109, 67],
         [24 / 3.0, 48 / 3.0, 215, 48, 39],
         [48 / 3.0, np.inf, 165, 0, 38]], dtype=np.float32)


def disp_error_img(save_name, pred, gt, abs_thres=3.0, rel_thres=0.05):
    """Save a KITTI-style error visualization (reference visualization.py:37-61)."""
    _mpl()
    import matplotlib.pyplot as plt

    pred_np = np.asarray(pred)
    gt_np = np.asarray(gt)
    H, W = pred_np.shape
    mask = gt_np > 0
    error = np.abs(gt_np - pred_np)
    error[~mask] = 0
    error[mask] = np.minimum(error[mask] / abs_thres,
                             (error[mask] / gt_np[mask]) / rel_thres)
    cols = gen_error_colormap()
    error_image = np.zeros([H, W, 3], dtype=np.float32)
    for i in range(cols.shape[0]):
        error_image[(error >= cols[i][0]) & (error < cols[i][1])] = cols[i, 2:]
    error_image[~mask] = 0.0
    for i in range(cols.shape[0]):
        error_image[:10, i * 20:(i + 1) * 20, :] = cols[i, 2:]
    plt.imsave(save_name, error_image.astype(np.uint8))


def gen_kitti_cmap():
    """KITTI disparity colormap (reference visualization.py:64-80)."""
    import matplotlib as mpl

    table = np.array([[0, 0, 0, 114], [0, 0, 1, 185], [1, 0, 0, 114],
                      [1, 0, 1, 174], [0, 1, 0, 114], [0, 1, 1, 185],
                      [1, 1, 0, 114], [1, 1, 1, 0]])
    bins = table[:-1, 3]
    cbins = np.cumsum(bins)
    cbins = cbins[:-1] / cbins[-1]
    nodes = np.concatenate([[0], cbins, [1]])
    colors = table[:, :3]
    return mpl.colors.LinearSegmentedColormap.from_list(
        name="kitti", colors=list(zip(nodes, colors)))


class VisImage:
    """Matplotlib-canvas image container (reference visualization.py:86-156)."""

    def __init__(self, img, scale=1.0):
        _mpl()
        import matplotlib.figure as mplfigure
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        self.img = img
        self.scale = scale
        self.width, self.height = img.shape[1], img.shape[0]
        fig = mplfigure.Figure(frameon=False, dpi=600)
        self.dpi = fig.get_dpi()
        fig.set_size_inches((self.width * scale + 1e-2) / self.dpi,
                            (self.height * scale + 1e-2) / self.dpi)
        self.canvas = FigureCanvasAgg(fig)
        ax = fig.add_axes([0.0, 0.0, 1.0, 1.0])
        ax.axis("off")
        self.fig = fig
        self.ax = ax
        self.ax.imshow(img.astype("uint8"), extent=(0, self.width, self.height, 0),
                       interpolation="nearest")

    def save(self, filepath):
        self.fig.savefig(filepath)

    def get_image(self):
        s, (width, height) = self.canvas.print_to_buffer()
        buffer = np.frombuffer(s, dtype="uint8")
        img_rgba = buffer.reshape(height, width, 4)
        rgb, _ = np.split(img_rgba, [3], axis=2)
        return rgb.astype("uint8")


class Visualizer:
    """Draws disparity/error/uncertainty over an RGB image
    (reference visualization.py:159-260)."""

    def __init__(self, img_rgb, scale=1.0):
        self.img = np.asarray(img_rgb).clip(0, 255).astype(np.uint8)
        self.output = VisImage(self.img, scale=scale)

    def draw_uncertainty(self, uncertainty, alpha=0.8):
        uncertainty = (np.asarray(uncertainty) * 255).astype("uint8")
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("OpenCV is required for the uncertainty heatmap")
        heatmap = cv2.applyColorMap(uncertainty, cv2.COLORMAP_JET)
        heatmap = cv2.cvtColor(heatmap, cv2.COLOR_BGR2RGB)
        blended = cv2.addWeighted(heatmap, alpha, self.img, 1.0 - alpha, 0.0)
        self.output.ax.imshow(blended, extent=(0, self.output.width, self.output.height, 0))
        return self.output

    def draw_error_map(self, error):
        error = np.asarray(error) / 3
        H, W = error.shape
        cols = gen_error_colormap()
        error_image = np.zeros([H, W, 3], dtype=np.float32)
        for i in range(cols.shape[0]):
            error_image[(error >= cols[i][0]) & (error < cols[i][1])] = cols[i, 2:]
        self.output.ax.imshow(error_image.astype(np.uint8),
                              extent=(0, self.output.width, self.output.height, 0))
        return self.output

    def draw_disparity(self, disparity_map, colormap="kitti", enhance=True,
                       percentile=0.01):
        d = np.asarray(disparity_map, dtype=np.float32)
        norm = (d - d.min()) / (d.max() - d.min() + 1e-12)
        if enhance:
            log_disp = np.log(1.0 - norm + 1e-8)
            mi, ma = np.quantile(log_disp, [percentile, 1 - percentile])
            log_disp = (log_disp - mi) / (ma - mi + 1e-10)
            norm = np.clip(1.0 - log_disp, 0, 1)
        if isinstance(colormap, str):
            cm = _mpl().colormaps[colormap]
            img = (255 * cm(norm)).astype(np.uint8)
        else:
            cv2 = _cv2()
            if cv2 is None:
                raise RuntimeError("OpenCV is required for an OpenCV colormap")
            img = cv2.applyColorMap(cv2.convertScaleAbs(norm, 1), colormap)
        self.output.ax.imshow(img, extent=(0, self.output.width, self.output.height, 0))
        return self.output
