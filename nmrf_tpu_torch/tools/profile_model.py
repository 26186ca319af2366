"""A ``torch.profiler`` trace of the NMRF forward on the card, summarised by
device kernel (``tools/profile_model.py``).

    python -m nmrf_tpu_torch.tools.profile_model [--out DIR] [--top K]
        [--config-file FILE] [--device cuda] [KEY VALUE ...]

Profiles a chain of 4 KITTI frames (375x1242 padded; ``PROFILE_SIZE HxW``
overrides it) after a warm-up, bf16, and writes the chrome trace
``DIR/trace.json`` (open it in Perfetto or ``chrome://tracing``).  The
summary (:func:`summarize_trace`) reads that file: device time by kernel
name, by kernel group (``KERNEL_GROUPS``: the port's hand-written kernels
by name, then the library kernels by kind), the busy time (the union of the
device intervals) and the idle share of the traced window.  A profiler can
lose events; the summary reports what the trace holds, and launch counts
come from the wrappers' counters, not from a trace.
"""

import argparse
import collections
import gzip
import json
import os
import tempfile

# the port's kernels by the names of their CUDA functions (csrc/*.cu)
K1B_MAIN = ("window_bwd_mma_kernel", "window_attention_bwd_kernel")
K1B_DVE = ("window_dve_",)
B7_MAIN = ("window_pos_bwd_mma_kernel", "window_pos_bwd_kernel")
B7_SUM = ("window_pos_bwd_sum_kernel",)

# (group, substrings of a kernel's name): the first match names its group
KERNEL_GROUPS = (
    ("msda_taps_bwd (B5b)", ("msda_bwd_",)),
    ("msda_taps (B5)", ("msda_taps_kernel", "msda_taps_vec_kernel")),
    ("masked_attention_bwd (B6b)", ("masked_bwd_",)),
    ("masked_attention (B6)", ("masked_attention_kernel",
                               "masked_attention_mma_kernel")),
    ("window_attention_pos_bwd (B7)", B7_MAIN + B7_SUM),
    ("window_attention_bwd (K1b)", K1B_MAIN + K1B_DVE),
    ("stripe_attention_bwd (K2b)", ("stripe_bwd_dq", "stripe_bwd_dkv")),
    ("window_attention (K1)", ("window_attention_kernel",
                               "window_attention_mma_kernel")),
    ("stripe_attention (K2)", ("stripe_attention_kernel",
                               "stripe_attention_mma_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit",
                     "winograd")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas")),
    ("memcpy", ("Memcpy", "Memset")),
    ("layer_norm", ("layer_norm",)),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("reduction", ("reduce_kernel",)),
    ("copy/cast", ("copy", "cast")),
    ("sort/index", ("sort", "gather", "index", "scatter", "argmax", "argmin")),
)
OTHER_GROUP = "other elementwise"

# chrome-trace categories of device work (kernels, copies, memsets)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_group(name):
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), OTHER_GROUP)


def _union_ms(spans):
    """Length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _events(trace_path):
    opener = gzip.open if str(trace_path).endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device_events(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def summarize_trace(trace_path, top=40):
    """Summary of a chrome trace (``torch.profiler`` ``export_chrome_trace``,
    optionally gzipped): ``(rows, busy_ms, idle_share, groups)``.

    rows: the ``top`` kernel names by device time, each (total ms, count,
    name, group); busy_ms: the union of the device intervals; idle_share:
    1 - busy over the traced window (the first event's start to the last
    event's end, host and device); groups: {group: (ms, count)} over every
    device event."""
    events = _events(trace_path)
    device = _device_events(events)
    dur, cnt = collections.Counter(), collections.Counter()
    for e in device:
        dur[e["name"]] += float(e["dur"]) / 1e3
        cnt[e["name"]] += 1
    rows = sorted(((dur[k], cnt[k], k, kernel_group(k)) for k in dur),
                  key=lambda r: (-r[0], r[2]))
    groups = collections.defaultdict(lambda: [0.0, 0])
    for ms, count, _, group in rows:
        groups[group][0] += ms
        groups[group][1] += count
    busy = _union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in device])
    window = 0.0
    if events:
        window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
                  - min(float(e["ts"]) for e in events)) / 1e3
    idle = 1.0 - busy / window if window > 0 else 0.0
    return (rows[:top], busy, idle,
            {g: tuple(v) for g, v in sorted(groups.items(),
                                            key=lambda kv: -kv[1][0])})


def split_by_ranges(trace_path, names):
    """Device ms of each ``record_function`` range in ``names``: a kernel
    belongs to the range whose host interval holds its launch (the runtime
    call with the same correlation id, whichever thread made it: autograd
    launches the backward from its own thread); a kernel whose launch the
    trace lacks takes the range of the kernel before it on the device (one
    stream runs kernels in issue order).  Returns {name: ms}, with
    "unattributed" for kernels before any range."""
    events = _events(trace_path)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in names)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    current = "unattributed"
    out = dict.fromkeys((*names, current), 0.0)
    for e in sorted(_device_events(events), key=lambda e: float(e["ts"])):
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None:
            current = next((n for a, b, n in ranges if a <= t <= b), current)
        out[current] += float(e["dur"]) / 1e3
    return out


def print_summary(summary, divisor=1, unit="ms/frame", label=""):
    """The summary as text: the rows, then the groups."""
    rows, busy, idle, groups = summary
    print(f"# {label}device busy {busy:.3f} ms ({busy / divisor:.3f} {unit}), "
          f"idle share {idle:.4f}")
    print(f"{'ms_total':>9}  {unit:>9} {'n':>6}  kernel   [group]")
    for ms, count, name, group in rows:
        print(f"{ms:9.3f}  {ms / divisor:9.3f} {count:6d}  {name[:100]}   "
              f"[{group}]")
    print("# by group: " + "  ".join(f"{g}={ms / divisor:.3f}"
                                     for g, (ms, _) in groups.items()))


def profile(fn, trace_path, device):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity on a
    card), synchronise, and export the chrome trace to ``trace_path``."""
    import torch
    from torch.profiler import ProfilerActivity

    from ..utils.benchmarks import sync

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        sync(device)
    prof.export_chrome_trace(trace_path)
    return trace_path


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "nmrf_profile"))
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--config-file", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Profile and print; returns the summary."""
    import torch

    from ..config import get_cfg
    from ..models import build_model, resolve_device
    from ..utils.benchmarks import KITTI_HW, chain, kitti_inputs, parse_hw

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    model = build_model(cfg, device=device)
    hw = parse_hw(os.environ["PROFILE_SIZE"]) \
        if os.environ.get("PROFILE_SIZE") else KITTI_HW
    inputs = kitti_inputs(cfg, device, hw)
    K = 4

    def frames():
        return chain(lambda a, b: model(a, b)["disp"], inputs, K)

    with torch.inference_mode():
        frames()  # warm-up
        path = profile(frames, os.path.join(args.out, "trace.json"), device)
    summary = summarize_trace(path, args.top)
    print_summary(summary, K, "ms/frame", f"trace {path}, {K} frames: ")
    return summary


if __name__ == "__main__":
    main()
