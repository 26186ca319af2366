"""CUDA graphs split at module boundaries.

A forward whose host issues many small launches can replay the chains of
kernels between its module calls from CUDA graphs (``torch.cuda.CUDAGraph``)
while every module call stays a Python call: forward hooks fire on each
call, and no tensor that crosses a call belongs to a graph.  A graph reads
static input buffers and writes static outputs; its caller copies the
inputs in (``copy_in``) and hands on fresh copies of the outputs
(``copy_out``), which no later replay overwrites.

``capturable`` says whether work on a tensor may replay from a graph,
``Captured`` is one graph, and ``GraphCache`` keeps a model's graphs by key
and lends them to one call at a time."""

import contextlib
import threading

import torch
from torch.profiler import record_function


def capturable(x):
    """Whether work on ``x`` may replay from a CUDA graph: x on a card, no
    gradient recorded, no tracing by ``torch.compile`` or ``torch.export``,
    and no capture already under way on the current stream."""
    return (x.is_cuda and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


def static_like(x):
    """A zeroed buffer of x's shape, strides and dtype on x's device."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device).zero_()


def _by_dtype(pairs):
    groups = {}
    for dst, src in pairs:
        groups.setdefault(src.dtype, ([], []))
        groups[src.dtype][0].append(dst)
        groups[src.dtype][1].append(src)
    return groups.values()


def copy_in(buffers, tensors):
    """Copies each of ``tensors`` into its static buffer: one launch a
    dtype where every pair is dense with the same strides."""
    for dst, src in _by_dtype(zip(buffers, tensors)):
        torch._foreach_copy_(dst, src)


def copy_out(tensors):
    """New tensors equal to ``tensors`` (static outputs), with their
    strides: one launch a dtype."""
    out = [torch.empty_like(t) for t in tensors]
    copy_in(out, tensors)
    return out


class Captured:
    """``fn(*inputs)`` captured once as a CUDA graph over the static buffers
    ``inputs``, after one eager run of it on a side stream (the warm-up
    that ``torch.cuda.graphs`` asks for), into the memory pool ``pool``.
    ``replay()`` runs the graph on the current stream and returns its
    static outputs, as ``fn`` structures them.  Call under ``no_grad``."""

    def __init__(self, fn, inputs, pool):
        device = inputs[0].device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn(*inputs)
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self.outputs = fn(*inputs)

    def replay(self):
        self.graph.replay()
        return self.outputs


class GraphCache:
    """A model's captured graphs by key, lent to one call at a time: a call
    that finds them lent out runs eagerly.  A key's entry is built on its
    first call, inside the profiler range ``capture_range`` (which opens
    only then), with the gradient off and outside inference mode, so that
    its static buffers take in-place copies in either mode."""

    def __init__(self, capture_range):
        self.capture_range = capture_range
        self._lock = threading.Lock()
        self._kept = {}

    @contextlib.contextmanager
    def hold(self, key, build):
        """The entry of ``key`` (``build()`` on a miss) for the ``with``
        block, or None while another call holds the cache."""
        if not self._lock.acquire(blocking=False):
            yield None
            return
        try:
            entry = self._kept.get(key)
            if entry is None:
                with record_function(self.capture_range), \
                        torch.inference_mode(False), torch.no_grad():
                    entry = self._kept[key] = build()
            yield entry
        finally:
            self._lock.release()

    def __len__(self):
        return len(self._kept)

    def __reduce__(self):
        # a copy of the model (deepcopy, pickle) starts with no graph: the
        # graphs read the original's parameters
        return GraphCache, (self.capture_range,)
