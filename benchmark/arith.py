"""The benchmark's yardstick arithmetic, frozen here so that a change to
the measured package cannot move it: the timing window, percentiles and
rates; the reading of a ``torch.profiler`` chrome trace (busy time as the
union of device intervals, the idle share of the traced window, device
time by ``record_function`` range, the longest idle gaps); and the
window-attention roofline against the H100's published peaks.

Copied from ``nmrf_tpu_torch``: ``Window`` (``utils/benchmarks.py``),
``summarize_trace``'s busy and idle arithmetic and ``split_by_ranges``
(``tools/profile_model.py``; one change: a kernel launched outside every
range named counts as unattributed, where the original gives it the
range of the kernel before it), ``window_attention_flops`` and
``window_bound`` (``tools/flops.py``)."""

import collections
import gzip
import json
import time

import torch

# NVIDIA's data sheet of the H100 SXM: dense rates at its 700 W limit
HBM_BYTES_PER_S = 3.35e12   # HBM3
BF16_OPS_PER_S = 989e12     # bf16 tensor-core peak


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #

class Window:
    """Device and wall milliseconds of the work issued inside a ``with``
    block: CUDA events on a card, the host clock around a final sync
    everywhere.  ``ms`` and ``wall_ms`` are set when the block exits."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms = self.wall_ms = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._events[1].record()
            torch.cuda.synchronize(self.device)
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        self.ms = (self._events[0].elapsed_time(self._events[1])
                   if self.device.type == "cuda" else self.wall_ms)
        return False


def percentile(values, q):
    """The q-th percentile of ``values``, linear between the closest ranks
    (numpy's default rule)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count, seconds):
    """``count`` completed over a window of ``seconds``."""
    return count / seconds


# --------------------------------------------------------------------------- #
# chrome traces
# --------------------------------------------------------------------------- #

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host-device copies: the memcpy events named by their direction
HOST_COPY = {"cats": ("gpu_memcpy",), "keys": ("HtoD", "DtoH")}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def _union_ms(spans):
    """Length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


class Trace:
    """The complete events of one exported chrome trace (optionally
    gzipped), and what the benchmark reads from them."""

    def __init__(self, path):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        self.events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATS]

    def busy_ms(self):
        """The union of the device intervals."""
        return _union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                          for e in self.device])

    def window_ms(self):
        """The traced window: the first event's start to the last event's
        end, host and device."""
        if not self.events:
            return 0.0
        return (max(float(e["ts"]) + float(e["dur"]) for e in self.events)
                - min(float(e["ts"]) for e in self.events)) / 1e3

    def idle_share(self):
        """1 - busy over the traced window."""
        window = self.window_ms()
        return 1.0 - self.busy_ms() / window if window > 0 else 0.0

    def kernel_ms(self, keys=None, cats=DEVICE_CATS):
        """Device ms of the events of ``cats`` whose name holds one of
        ``keys`` (every one without keys)."""
        return sum(float(e["dur"]) for e in self.device
                   if e.get("cat") in cats
                   and (keys is None
                        or any(k in e["name"] for k in keys))) / 1e3

    def top_ops(self, n=10):
        """[[name, seconds]] of the n device operations that took most time,
        summed by name."""
        dur = collections.Counter()
        for e in self.device:
            dur[e["name"]] += float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(dur.items(),
                                          key=lambda kv: (-kv[1], kv[0]))[:n]]

    def idle_gaps(self, n=10):
        """[[host op, seconds]] of the n longest gaps between device
        intervals, each named by the innermost host operation or range
        running at the gap's middle."""
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        host = [e for e in self.events if e.get("cat") in HOST_CATS]
        out = []
        for length, a, b in sorted(gaps, reverse=True)[:n]:
            mid = (a + b) / 2
            inside = [e for e in host if float(e["ts"]) <= mid
                      <= float(e["ts"]) + float(e["dur"])]
            name = min(inside, key=lambda e: float(e["dur"]))["name"] \
                if inside else "host, outside any traced op"
            out.append([name, length / 1e6])
        return out

    def split_by_ranges(self, names):
        """Device ms of each ``record_function`` range in ``names``: a
        kernel belongs to the range whose host interval holds its launch
        (the runtime call with the same correlation id, whichever thread
        made it); a kernel whose launch the trace lacks takes the range of
        the kernel before it on the device.  Returns {name: ms}, with
        "unattributed" for kernels outside any range."""
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in self.events
                        if e.get("cat") == "user_annotation"
                        and e["name"] in names)
        launch = {e["args"]["correlation"]: float(e["ts"])
                  for e in self.events if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        current = "unattributed"
        out = dict.fromkeys((*names, current), 0.0)
        for e in sorted(self.device, key=lambda e: float(e["ts"])):
            t = launch.get(e.get("args", {}).get("correlation"))
            if t is not None:
                current = next((n for a, b, n in ranges if a <= t <= b),
                               "unattributed")
            out[current] += float(e["dur"]) / 1e3
        return out


# --------------------------------------------------------------------------- #
# roofline of the NMP window attention
# --------------------------------------------------------------------------- #

def window_attention_flops(B, Hp, Wp, N, ws, C, heads):
    """FLOPs of the window attention on qkv [B, Hp, Wp, N, 3C]: per window
    and head the T x T products q.k and a.v (T = P N tokens, P = ws^2) and
    the three T x P positional and value-table products,
    ``G h hd (4 T^2 + 6 T P)``."""
    P = ws * ws
    T = P * N
    G = B * (Hp // ws) * (Wp // ws)
    return G * heads * (C // heads) * (4 * T * T + 6 * T * P)


def window_bound(B, Hp, Wp, N, ws, C, heads, backward=False):
    """(bytes ms, ops ms) of the window attention on bf16 qkv [B, Hp, Wp,
    N, 3C].  Forward: qkv read and the output written once, the f32 table
    read once; q.k, a.v, the two positional terms and the value-table term.
    Backward: qkv and g read, d(qkv) written, the f32 table read and
    d(table) written once; the five T x T products (q.k and g.v recomputed,
    dq, dk, dv) and eight T x P products."""
    T, P = ws * ws * N, ws * ws
    nwin = B * (Hp // ws) * (Wp // ws)
    hd = C // heads
    tokens = B * Hp * Wp * N
    table = (2 * ws - 1) ** 2 * 3 * C * 4
    if backward:
        nbytes = tokens * (3 * C + C + 3 * C) * 2 + 2 * table
        ops = nwin * heads * (10 * T * T * hd + 16 * T * P * hd)
    else:
        nbytes = tokens * (3 * C + C) * 2 + table
        ops = window_attention_flops(B, Hp, Wp, N, ws, C, heads)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def least_ms(calls, backward=False):
    """Sum over window-attention calls, each (qkv shape, window, heads), of
    the larger of its bytes and ops bounds."""
    total = 0.0
    for (B, Hp, Wp, N, C3), ws, heads in calls:
        total += max(window_bound(B, Hp, Wp, N, ws, C3 // 3, heads, backward))
    return total
