"""What a traced run reads from the measured package's own profiler ranges
(``nmrf::*``): the host ms of ``predict``'s phases, kernel launches inside
a range, and the backward's device ms by the forward stage whose op made
each autograd node.

The ranges (``nmrf_tpu_torch``): ``nmrf::predict`` around a request, with
``nmrf::predict.prep``, ``.copy_in``, ``.forward``, ``.wait`` and
``.copy_out`` inside it; ``nmrf::step`` around a training step, with
``nmrf::forward``, ``nmrf::loss``, ``nmrf::backward`` and
``nmrf::optimizer`` inside it; the model's stages ``nmrf::backbone``,
``nmrf::cost_volume``, ``nmrf::dpn``, ``nmrf::inference`` and
``nmrf::refinement``, which hold every op of its forward.  A program
without them reads None here.

The backward's attribution.  Autograd runs the backward outside every
forward range, but the profiler records on a forward op the sequence
number of the autograd node it made, and the same number on that node's
``autograd::engine::evaluate_function`` event.  So a backward kernel goes
to a stage by a chain: its launch (the runtime call with its correlation
id), the innermost ``evaluate_function`` event on the launching thread
that holds the launch, that event's sequence number, the forward op that
made the node (of the forward ops that record the number, the last to
start: an op records the number the next node will take, so the ops
before it made none), and the stage range that holds that op.  A kernel
is ``unattributed`` when its node has no sequence number
(``AccumulateGrad``), when no forward op records the number, or when that
op lies in no stage range and not in ``nmrf::loss``.  The kernels are
those ``arith.Trace.split_by_ranges`` puts in ``nmrf::backward`` (a kernel
whose launch the trace lacks goes where the kernel before it went), so
the parts sum to what ``bwd_ms.train`` reads."""

import bisect
import collections
import weakref

from benchmark import arith, harness

STAGES = ("nmrf::backbone", "nmrf::cost_volume", "nmrf::dpn",
          "nmrf::inference", "nmrf::refinement")
LOSS = "nmrf::loss"
BACKWARD = "nmrf::backward"
UNATTRIBUTED = "unattributed"
NODE = "autograd::engine::evaluate_function"
PHASES = ("prep", "copy_in", "forward", "wait", "copy_out")
# the runtime and driver calls that launch a kernel
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SEQ = "Sequence number"

# what each trace read, computed once for the readers that share it
_phases = weakref.WeakKeyDictionary()
_backward = weakref.WeakKeyDictionary()


def _start(e):
    return float(e["ts"])


def _end(e):
    return float(e["ts"]) + float(e["dur"])


def _thread(e):
    return e.get("pid"), e.get("tid")


def ranges(trace, names):
    """The ``record_function`` ranges of the trace named in ``names``."""
    return [e for e in trace.events
            if e.get("cat") == "user_annotation" and e["name"] in names]


def innermost(intervals, points):
    """For each (t, key) of ``points``, the value of the innermost of
    ``intervals`` ((start, end, value), nested or apart, as one thread's
    ranges are) that holds t, or None: {key: value}."""
    out, stack = {}, []
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    j = 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while j < len(intervals) and intervals[j][0] <= t:
            while stack and stack[-1][1] < intervals[j][0]:
                stack.pop()
            stack.append(intervals[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _by_thread(events, value):
    """{thread: [(start, end, value(e))]} of ``events``."""
    out = collections.defaultdict(list)
    for e in events:
        out[_thread(e)].append((_start(e), _end(e), value(e)))
    return out


def _innermost_on_thread(intervals, events):
    """{id(e): the innermost of ``intervals`` ({thread: [(start, end,
    value)]}) on e's thread that holds e's start} for each of ``events``."""
    points = collections.defaultdict(list)
    for e in events:
        points[_thread(e)].append((_start(e), id(e)))
    out = {}
    for thread, pts in points.items():
        out.update(innermost(intervals.get(thread, []), pts))
    return out


# --------------------------------------------------------------------------- #
# the request's phases and launches
# --------------------------------------------------------------------------- #

def predict_phases(rec):
    """Host ms a request in each phase of ``predict`` (``PHASES``) and in
    the whole ``predict`` range, over the traced requests; None without
    device events or without the ranges.  Logged on stderr once a trace."""
    if "traced_frames" not in rec or not rec["trace"].device:
        return None
    trace = rec["trace"]
    if trace not in _phases:
        names = {f"nmrf::predict.{p}": p for p in PHASES}
        names["nmrf::predict"] = "predict"
        found = ranges(trace, names)
        ms = None
        if found:
            ms = dict.fromkeys(names.values(), 0.0)
            for e in found:
                ms[names[e["name"]]] += (float(e["dur"]) / 1e3
                                         / rec["traced_frames"])
            harness.log("host ms a request by phase of predict: "
                        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
        _phases[trace] = ms
    return _phases[trace]


def launches(trace, name):
    """Kernel-launch calls (``LAUNCHES``, runtime or driver, on any
    thread) that start inside the ranges named ``name``; None without
    such a range."""
    spans = sorted((_start(e), _end(e)) for e in ranges(trace, (name,)))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    count = 0
    for e in trace.events:
        if e.get("cat") in arith.LAUNCH_CATS and e["name"].startswith(
                LAUNCHES):
            i = bisect.bisect_right(starts, _start(e)) - 1
            if i >= 0 and _start(e) <= spans[i][1]:
                count += 1
    return count


# --------------------------------------------------------------------------- #
# the backward by stage
# --------------------------------------------------------------------------- #

def node_stages(trace):
    """[(evaluate_function event, stage)] of every autograd node the
    trace ran: the stage range (``STAGES``) or ``nmrf::loss`` that holds
    the forward op that made the node, else ``unattributed``."""
    nodes = [e for e in trace.events if e["name"].startswith(NODE)]
    node_spans = _by_thread(nodes, lambda e: e)
    ops = [e for e in trace.events if e.get("cat") == "cpu_op"
           and SEQ in e.get("args", {}) and not e["name"].startswith(NODE)]
    inside = _innermost_on_thread(node_spans, ops)
    made = {}  # (pid, sequence number): the forward op that made the node
    for e in sorted(ops, key=_start):
        if inside[id(e)] is None:
            made[(e.get("pid"), e["args"][SEQ])] = e
    stage_spans = _by_thread(ranges(trace, (*STAGES, LOSS)),
                             lambda e: e["name"])
    stage = _innermost_on_thread(stage_spans, made.values())
    out = []
    for e in nodes:
        op = made.get((e.get("pid"), e.get("args", {}).get(SEQ)))
        out.append((e, (stage[id(op)] or UNATTRIBUTED) if op is not None
                    else UNATTRIBUTED))
    return out


def backward_ms(trace):
    """{stage range, ``nmrf::loss``, ``unattributed``: device ms} of the
    kernels launched inside ``nmrf::backward``, summed over the trace; None
    without device events or without stage ranges."""
    if not trace.device or not ranges(trace, STAGES):
        return None
    if trace in _backward:
        return _backward[trace]
    nodes = node_stages(trace)
    node_spans = _by_thread([e for e, _ in nodes], lambda e: e)
    stage_of = {id(e): s for e, s in nodes}
    launch = {e["args"]["correlation"]: e for e in trace.events
              if e.get("cat") in arith.LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    node_of = _innermost_on_thread(node_spans, launch.values())
    backward = sorted((_start(e), _end(e)) for e in ranges(trace, (BACKWARD,)))
    starts = [a for a, _ in backward]

    def in_backward(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= backward[i][1]

    out = dict.fromkeys((*STAGES, LOSS, UNATTRIBUTED), 0.0)
    current = (False, UNATTRIBUTED)
    for k in sorted(trace.device, key=_start):
        e = launch.get(k.get("args", {}).get("correlation"))
        if e is not None:
            node = node_of[id(e)]
            current = (in_backward(_start(e)),
                       UNATTRIBUTED if node is None else stage_of[id(node)])
        if current[0]:
            out[current[1]] += float(k["dur"]) / 1e3
    _backward[trace] = out
    return out


def backward_per_step(rec):
    """``backward_ms`` over the traced steps, a step; None where it reads
    nothing.  Logged on stderr once a trace, beside what ``nmrf::backward``
    holds by ``split_by_ranges``."""
    if "traced_steps" not in rec:
        return None
    trace = rec["trace"]
    logged = trace in _backward
    ms = backward_ms(trace)
    if ms is None:
        return None
    n = rec["traced_steps"]
    ms = {k: v / n for k, v in ms.items()}
    if not logged:
        whole = trace.split_by_ranges((BACKWARD,))[BACKWARD] / n
        harness.log("backward device ms a step by stage: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
                    + f"; sum {sum(ms.values()):.3f}, {BACKWARD} {whole:.3f}")
    return ms
