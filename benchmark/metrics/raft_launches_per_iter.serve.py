"""Kernel-launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``, on any
thread) inside the program's range ``nmrf::raft.update`` over the update
iterations the traced requests ran (the model's ``iterations`` counter
after each request)."""

from benchmark import spans


def read(rec):
    if not rec.get("raft_iterations") or not rec["trace"].device:
        return None
    n = spans.launches(rec["trace"], "nmrf::raft.update")
    return None if n is None else n / rec["raft_iterations"]
