"""Metric gathering across processes (the port's ``nmrf_tpu/utils/dist.py``):
each process's variable-length float list goes out as one float64 tensor
padded to the longest list, over ``torch.distributed``."""

from typing import List, Sequence

import torch
import torch.distributed as dist


def all_gather_float_lists(values: Sequence[float]) -> List[List[float]]:
    """Gather a variable-length float list from every process.

    Returns a list of per-process lists (rank order).  Without an
    initialised process group, or in a world of one: ``[list(values)]``.
    """
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [list(values)]
    world = dist.get_world_size()
    # NCCL moves CUDA tensors only; gloo takes CPU tensors
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    n = torch.tensor([len(values)], dtype=torch.int64, device=device)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    if not max(counts):
        return [[] for _ in counts]
    padded = torch.zeros(max(counts), dtype=torch.float64, device=device)
    padded[:len(values)] = torch.tensor(list(values), dtype=torch.float64)
    rows = [torch.zeros_like(padded) for _ in range(world)]
    dist.all_gather(rows, padded)
    return [row[:c].cpu().tolist() for row, c in zip(rows, counts)]


def metrics_gather_fn(values):
    """DispEvaluator.gather_fn adapter (see evalx.DispEvaluator.evaluate)."""
    return all_gather_float_lists(values)
