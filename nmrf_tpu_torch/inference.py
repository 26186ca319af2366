"""Demo and KITTI-submission CLI of the port, and single-pair prediction
(root ``inference.py``; reference ``inference.py``).

    python -m nmrf_tpu_torch.inference --dataset-name kitti_2015 \\
        --output OUT [--device cpu] [KEY VALUE ...]
    python -m nmrf_tpu_torch.inference --input 'left/*.png' 'right/*.png'
    python -m nmrf_tpu_torch.inference --dataset-name eth3d --show-attr error

``--dataset-name`` kitti_2012 or kitti_2015 writes a KITTI submission
(uint16 ×256 PNGs, ``data.frame_io.write_disp_kitti``); another dataset name
(eth3d, middlebury_<split>, ...) renders each pair's disparity or error map
with ``utils.visualization.Visualizer``; ``--input LEFT_GLOB RIGHT_GLOB``
renders the disparity of each matched pair.  ``SOLVER.RESUME`` restores an
upstream ``.pth`` (``utils/checkpoint.py:load_torch_checkpoint``; unmatched
keys raise under ``SOLVER.STRICT_RESUME``) or a checkpoint directory of
``python -m nmrf_tpu_torch.train`` (its model weights).  ``--device``
defaults to cuda and raises without a card; ``cpu`` runs the plain
versions.  matplotlib is imported only by the two rendering modes.
"""

import argparse
import glob
import os

import numpy as np
import torch
from torch.profiler import record_function

from .data.frame_io import InputPadder


def get_args_parser():
    parser = argparse.ArgumentParser("NMRF inference (PyTorch)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--dataset-name", default=None, type=str,
                        help="eth3d | middlebury_<split> | kitti_2012 | kitti_2015")
    parser.add_argument("--input", nargs="+", default=None,
                        help="two glob patterns: left right")
    parser.add_argument("--output", default="demo_output", type=str)
    parser.add_argument("--show-attr", default="disparity",
                        choices=["disparity", "error"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def build(args):
    """(cfg, model) of the CLI's arguments: the config merged from
    ``--config-file`` and the overrides, the model on ``args.device`` in
    eval mode with ``SOLVER.RESUME``'s weights when set."""
    from .config import get_cfg
    from .models import build_model
    from .utils.checkpoint import (load_torch_checkpoint, load_train_state,
                                   restore_checkpoint)

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()

    model = build_model(cfg, device=getattr(args, "device", None))
    resume = cfg.SOLVER.RESUME
    if resume:
        if resume.endswith(".pth"):
            unmatched = load_torch_checkpoint(model, resume)
            if unmatched and cfg.SOLVER.STRICT_RESUME:
                raise ValueError(f"unmatched torch keys: {unmatched[:10]}")
        else:
            state, _ = restore_checkpoint(resume)
            load_train_state(state, model)
    return cfg, model


class FrameStaging:
    """How a request's two frames reach the model's device in the dtype
    the caller gave: one [2, H, W, 3] host tensor, uint8 where both frames
    are, else float32.  For a card the tensor is a pinned buffer, one per
    (device, shape, dtype), reused across requests: allocated only on a
    miss, inside the profiler range ``nmrf::predict.stage_alloc``, and
    written only after the event recorded behind its last copy (a wait
    that is free after a request that synchronised, and that keeps the
    buffer safe after one that raised).  A buffer is out of the keep from
    its filling until its copy is issued, so concurrent requests never
    share one."""

    def __init__(self):
        self._kept = {}  # (device, shape, dtype) -> (buffer, event)

    def fill(self, device, img1, img2):
        """The host tensor that holds both frames, and its staging entry
        to hand to ``send`` (None off a card).  numpy copies the frames in,
        on the calling thread: torch's copy on its intra-op threads is
        faster alone (a KITTI uint8 pair in 0.19 ms against 0.60 on an H100
        machine's host) but served 11% fewer frames a second there, beside
        the forward's launch-bound issue."""
        img1, img2 = np.asarray(img1), np.asarray(img2)
        if img1.shape != img2.shape:
            raise ValueError(f"frames of two shapes: {img1.shape}, "
                             f"{img2.shape}")
        dtype = np.uint8 if img1.dtype == img2.dtype == np.uint8 \
            else np.float32
        shape = (2,) + img1.shape
        staged = None
        if device.type != "cuda":
            host = torch.from_numpy(np.empty(shape, dtype))
        else:
            key = (device, shape, dtype)
            entry = self._kept.pop(key, None)
            if entry is None:
                with record_function("nmrf::predict.stage_alloc"):
                    entry = (torch.from_numpy(np.empty(shape, dtype))
                             .pin_memory(), torch.cuda.Event())
            host, copied = entry
            copied.synchronize()
            staged = (key, entry)
        view = host.numpy()
        view[0], view[1] = img1, img2
        return host, staged

    def send(self, host, staged, device):
        """``host`` on ``device``; from a pinned buffer an asynchronous
        copy, behind which the buffer's event is recorded and the buffer
        goes back to the keep."""
        x = host.to(device, non_blocking=True)
        if staged is not None:
            key, entry = staged
            entry[1].record(torch.cuda.current_stream(device))
            self._kept[key] = entry
        return x


def predict(model, img1, img2, divis_by=None):
    """img1/img2: [H, W, 3] arrays (0..255) of one shape, uint8 or float32
    (another dtype is cast to float32 on the host).  Pads to ``divis_by``
    (the model's ``divis_by``, recorded by ``build_model`` from the config,
    unless given), runs on the model's device under ``torch.inference_mode``
    and returns the [H, W] float32 numpy disparity.  The frames travel in
    their own dtype (``FrameStaging``, kept on the model as
    ``frame_staging``); the float32 cast and the edge pad run on the device
    (``InputPadder.pad_tensor``), so the model's input is the same, bit for
    bit, as numpy's cast and ``np.pad`` of it.

    The request runs inside the profiler range ``nmrf::predict``, its
    phases in order inside ``nmrf::predict.prep`` (both frames into one
    host tensor: on a card the reused pinned buffer, with
    ``nmrf::predict.stage_alloc`` inside on a miss), ``.copy_in`` (the
    frames to the device, asynchronous from a pinned buffer, and the cast
    and pad there), ``.forward`` (the model and the disparity's cast: the
    host's issue of the request's launches), ``.wait`` (on a card, a
    synchronise of the current stream, which the copy back would wait for
    anyway) and ``.copy_out`` (the disparity to the host and the unpad)."""
    device = next(model.parameters()).device
    divis_by = model.divis_by if divis_by is None else divis_by
    staging = getattr(model, "frame_staging", None)
    if staging is None:
        staging = model.frame_staging = FrameStaging()
    with record_function("nmrf::predict"):
        with record_function("nmrf::predict.prep"):
            padder = InputPadder(img1.shape, mode="proposal",
                                 divis_by=divis_by)
            host, staged = staging.fill(device, img1, img2)
        with torch.inference_mode():
            with record_function("nmrf::predict.copy_in"):
                a, b = padder.pad_tensor(
                    staging.send(host, staged, device)).split(1)
            with record_function("nmrf::predict.forward"):
                disp = model(a, b)["disp"].float()
            with record_function("nmrf::predict.wait"):
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
            with record_function("nmrf::predict.copy_out"):
                return padder.unpad(disp.cpu().numpy())[0]


def main(argv=None):
    """Run the CLI on ``argv`` (``sys.argv[1:]`` unless given); returns the
    list of files written."""
    args = get_args_parser().parse_args(argv)
    cfg, model = build(args)
    os.makedirs(args.output, exist_ok=True)
    written = []

    from .data import KITTI, build_val_dataset
    from .data.frame_io import read_gen, write_disp_kitti

    if args.dataset_name in ("kitti_2012", "kitti_2015"):
        # KITTI submission (reference inference.py:104-126)
        ds = KITTI(root=os.path.join(cfg.DATASETS.ROOT, "KITTI"),
                   split="testing", image_set=args.dataset_name)
        for i in range(len(ds)):
            sample = ds[i]
            disp = predict(model, sample["img1"], sample["img2"])
            written.append(os.path.join(args.output, sample["meta"]))
            write_disp_kitti(written[-1], disp)
            print(f"[{i + 1}/{len(ds)}] {sample['meta']}")
        return written

    from .utils.visualization import Visualizer

    if args.dataset_name is not None:
        ds = build_val_dataset(cfg, args.dataset_name)
        for i in range(len(ds)):
            sample = ds[i]
            disp = predict(model, sample["img1"], sample["img2"])
            vis = Visualizer(sample["img1"])
            if args.show_attr == "error":
                err = np.abs(disp - sample["disp"]) * sample["valid"]
                out = vis.draw_error_map(err)
            else:
                out = vis.draw_disparity(disp, colormap="kitti")
            written.append(os.path.join(args.output, f"{i:06d}.png"))
            out.save(written[-1])
            print(f"[{i + 1}/{len(ds)}]")
        return written

    if not args.input or len(args.input) != 2:
        raise SystemExit("--input LEFT_GLOB RIGHT_GLOB (or --dataset-name)")
    lefts = sorted(glob.glob(args.input[0]))
    rights = sorted(glob.glob(args.input[1]))
    for i, (lf, rf) in enumerate(zip(lefts, rights)):
        img1 = np.array(read_gen(lf)).astype(np.float32)[..., :3]
        img2 = np.array(read_gen(rf)).astype(np.float32)[..., :3]
        disp = predict(model, img1, img2)
        out = Visualizer(img1).draw_disparity(disp, colormap="kitti")
        name = os.path.splitext(os.path.basename(lf))[0]
        written.append(os.path.join(args.output, f"{name}_disp.png"))
        out.save(written[-1])
        print(f"[{i + 1}/{len(lefts)}] {name}")
    return written


if __name__ == "__main__":
    main()
