"""The device memory a training step holds at its peak:
``max_memory_allocated`` over the traced steps after
``reset_peak_memory_stats``, in GB."""


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 1e9
