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


def predict(model, img1, img2, divis_by=None):
    """img1/img2: [H, W, 3] arrays (0..255).  Pads to ``divis_by`` (the
    model's ``divis_by``, recorded by ``build_model`` from the config, unless
    given), runs on the model's device under ``torch.inference_mode`` and
    returns the [H, W] float32 numpy disparity.

    The request runs inside the profiler range ``nmrf::predict``, its
    phases in order inside ``nmrf::predict.prep`` (the float32 cast and
    the pad), ``.copy_in`` (both frames to the device), ``.forward`` (the
    model and the disparity's cast: the host's issue of the request's
    launches), ``.wait`` (on a card, a synchronise of the current stream,
    which the copy back would wait for anyway) and ``.copy_out`` (the
    disparity to the host and the unpad)."""
    device = next(model.parameters()).device
    divis_by = model.divis_by if divis_by is None else divis_by
    with record_function("nmrf::predict"):
        with record_function("nmrf::predict.prep"):
            padder = InputPadder(img1.shape, mode="proposal",
                                 divis_by=divis_by)
            p1, p2 = padder.pad(np.asarray(img1, np.float32),
                                np.asarray(img2, np.float32))
        with torch.inference_mode():
            with record_function("nmrf::predict.copy_in"):
                a = torch.from_numpy(p1[None]).to(device)
                b = torch.from_numpy(p2[None]).to(device)
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
