"""Checkpoints of the port (``nmrf_tpu/utils/checkpoint.py``): the training
state saved and restored with ``torch.save``/``torch.load``, upstream torch
checkpoints loaded into the model, and a torch Swin-T ``state_dict`` merged
into the swin backbone.

Layout, as the JAX package's: ``<dir>/step_{step:08d}/`` per save (here
one file, ``state.pt``), ``<dir>/latest.txt`` naming the newest, and the
reference's retention (``prune_stale_latest``).  Tensors are saved from the
CPU, so a checkpoint is topology-free: a restore places them on the
model's device, with or without a mesh.

The training state (``train_state``) is everything a resumed run needs to
continue the saved one exactly: the model's and AdamW's ``state_dict``,
the step, the drop-path generator's state (``models.layers.DropPathMasks``)
and the train step's accumulation state (``solver.step``: the micro-step
count and, between micro-steps, the gradients summed so far).  The learning
-rate schedule is not saved: like the JAX package, a resumed run rebuilds
it from its config at the saved number of updates
(``solver.build_scheduler``).
"""

import os
import re
import shutil

import torch

STATE_FILE = "state.pt"


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir: str, step: int, state, keep_latest: bool = True):
    """Save ``state`` (nested dicts and lists of tensors and numbers) as
    ``step_{step:08d}/state.pt`` with every tensor on the CPU; the
    directory appears whole or not at all.  Returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(state), os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if keep_latest:
        latest = os.path.join(ckpt_dir, "latest.txt")
        with open(latest + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(latest + ".tmp", latest)
    return path


def prune_stale_latest(ckpt_dir: str, keep_step: int, periodic_every: int):
    """Delete ``step_*`` checkpoints that were only ever "latest" saves.

    The reference overwrites one ``checkpoint_latest.pth`` every
    ``LATEST_CHECKPOINT_PERIOD`` (main.py:449) and keeps full snapshots only
    every ``CHECKPOINT_PERIOD``; saves here are per-step directories, so
    this removes the step directories that are neither the newest save nor
    a ``CHECKPOINT_PERIOD`` multiple."""
    for name in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        m = re.fullmatch(r"step_(\d{8})", name)
        if not m:
            continue
        step = int(m.group(1))
        if step != keep_step and (periodic_every <= 0
                                  or step % periodic_every != 0):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def restore_checkpoint(ckpt_dir: str, step: int = None):
    """(state, step) of a save of ``save_checkpoint``: the newest
    (``latest.txt``) unless ``step`` is given; tensors on the CPU."""
    if step is None:
        with open(os.path.join(ckpt_dir, "latest.txt")) as f:
            step = int(f.read().strip())
    path = os.path.join(ckpt_dir, f"step_{step:08d}", STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), step


def train_state(model, optimizer, step, train_step=None):
    """The training state to save at ``step`` (module docstring).  On a
    mesh with ``train_step`` between micro-steps this is a collective
    (``train_step.state_dict``): every rank calls it, rank 0 saves."""
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "step": int(step)}
    masks = getattr(model, "drop_path_masks", None)
    if masks is not None:
        state["drop_path_generator"] = masks.generator.get_state()
    if train_step is not None:
        state["train_step"] = train_step.state_dict()
    return state


def load_train_state(state, model, optimizer=None):
    """Restore a ``train_state`` into the model, its drop-path generator and,
    given, the optimizer; returns the saved step.  The optimizer keeps its
    hyperparameters (those of the current config, as the JAX package
    rebuilds its optimizer from the config) and takes the saved moments and
    step counts.  Rebuild the schedule after this (``solver.build_scheduler``)
    and give the train step ``state["train_step"]``."""
    model.load_state_dict(state["model"])
    masks = getattr(model, "drop_path_masks", None)
    if masks is not None and "drop_path_generator" in state:
        masks.generator.set_state(state["drop_path_generator"])
    if optimizer is not None:
        saved = state["optimizer"]
        current = optimizer.state_dict()["param_groups"]
        if len(current) != len(saved["param_groups"]):
            raise ValueError(f"the checkpoint has {len(saved['param_groups'])} "
                             f"parameter groups, the optimizer {len(current)}")
        optimizer.load_state_dict({
            "state": saved["state"],
            "param_groups": [dict(cur, params=old["params"]) for cur, old
                             in zip(current, saved["param_groups"])]})
    return int(state["step"])


# ---- upstream torch checkpoints ---- #

# buffers of upstream checkpoints that hold no weight (the JAX package's
# converter skips the same keys)
_SKIP = re.compile(
    r"(relative_position_index|attn_mask|device_indicator_tensor|"
    r"num_batches_tracked|\.mean$|\.std$)")


def load_torch_checkpoint(model, path: str):
    """Load an upstream NMRF ``.pth`` (its ``model`` entry, or a bare
    ``state_dict``) into the model, whose parameters carry the upstream
    names.  ``image_encoder.`` keys (upstream ``COMPAT False``) are read as
    ``backbone.``; buffers that hold no weight are skipped.  Returns the
    unmatched keys: the model's keys the file lacks and the file's keys the
    model lacks (``SOLVER.STRICT_RESUME`` makes the caller raise on them)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    weights = ckpt.get("model", ckpt)
    own = model.state_dict()
    state = {}
    for key, value in weights.items():
        if key.startswith("image_encoder."):
            key = "backbone." + key[len("image_encoder."):]
        if _SKIP.search(key) and key not in own:
            continue
        state[key] = value
    result = model.load_state_dict(state, strict=False)
    return list(result.missing_keys) + list(result.unexpected_keys)


# ---- pretrained Swin-T (reference backbone.py:161-196) ---- #

_SWIN_SKIP = re.compile(r"(attn_mask|relative_position_index)")
# the key families of a torch Swin-T checkpoint that the swin backbone
# takes (the JAX package's ``_SWIN_RULES``); its names are the port's own
_SWIN_KEYS = [re.compile(p) for p in (
    r"patch_embed\.proj\.(weight|bias)",
    r"patch_embed\.norm\.(weight|bias)",
    r"layers\.\d\.blocks\.\d+\.norm\d\.(weight|bias)",
    r"layers\.\d\.blocks\.\d+\.attn\.qkv\.(weight|bias)",
    r"layers\.\d\.blocks\.\d+\.attn\.proj\.(weight|bias)",
    r"layers\.\d\.blocks\.\d+\.attn\.relative_position_bias_table",
    r"layers\.\d\.blocks\.\d+\.mlp\.fc\d\.(weight|bias)",
    r"layers\.\d\.downsample\.norm\.(weight|bias)",
    r"layers\.\d\.downsample\.reduction\.weight",
)]


def convert_swin_state_dict(state_dict):
    """A torch Swin-T checkpoint (e.g. swin_tiny_patch4_window7_224) ->
    ({key: tensor} of the swin backbone ``models.swin.SwinTransformer``,
    unmatched keys).  The reference's ``checkpoint_filter_fn``
    (backbone.py:161-173): drops the attn_mask and index buffers and the
    top-level ``norm.*``/``head.*`` classifier weights."""
    state_dict = state_dict.get("model", state_dict)
    state_dict = state_dict.get("state_dict", state_dict)
    out, unmatched = {}, []
    for key, value in state_dict.items():
        if _SWIN_SKIP.search(key) or key.startswith(("norm", "head")):
            continue
        if any(p.fullmatch(key) for p in _SWIN_KEYS):
            out[key] = torch.as_tensor(value)
        else:
            unmatched.append(key)
    return out, unmatched


def load_pretrained_swin(model, weight_path: str):
    """Merge a torch Swin-T checkpoint into the swin variant's backbone
    (``model.backbone.backbone``, reference create_backbone,
    backbone.py:186-196); raises on a key it cannot place or a shape that
    differs."""
    ckpt = torch.load(weight_path, map_location="cpu", weights_only=True)
    weights, unmatched = convert_swin_state_dict(ckpt)
    if unmatched:
        raise ValueError(f"unmatched swin keys: {unmatched[:8]}")
    target = model.backbone.backbone.state_dict()
    for key, value in weights.items():
        if key not in target:
            raise ValueError(f"swin param {key} missing in model")
        if tuple(target[key].shape) != tuple(value.shape):
            raise ValueError(f"swin param {key}: model {tuple(target[key].shape)}, "
                             f"checkpoint {tuple(value.shape)}")
    model.backbone.backbone.load_state_dict(weights, strict=False)
    return model
