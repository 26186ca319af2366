"""CUDA graphs split at module boundaries.

A forward whose host issues many small launches can replay the chains of
kernels between its module calls from CUDA graphs (``torch.cuda.CUDAGraph``)
while every module call stays a Python call: forward hooks fire on each
call, and no tensor that crosses a call belongs to a graph.  A graph reads
static input buffers and writes static outputs; its caller copies the
inputs in (``copy_in``) and hands on fresh copies of the outputs
(``copy_out``), which no later replay overwrites.

``capturable`` says whether work on a tensor may replay from a graph,
``Captured`` is one graph, ``Segments`` the graphs of one forward, captured
where the forward first reaches each, and ``GraphCache`` keeps a model's
graphs by key and lends them to one call at a time.  A replay counts the
port's kernels that its capture launched (``ops/_native.py:recording``), so
``_native.launch_counts()`` counts the kernels that ran either way: on the
graph path those counts are inferred from the capture, not observed."""

import contextlib
import threading

import torch
from torch.profiler import record_function

from ..ops import _native


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


def _leaves(outputs):
    return [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)


def fresh(outputs):
    """``copy_out`` of a tensor or a flat tuple or list of them, in the same
    structure (a list for a sequence)."""
    out = copy_out(_leaves(outputs))
    return out[0] if isinstance(outputs, torch.Tensor) else out


class Captured:
    """``fn(*inputs)`` captured once as a CUDA graph over the static buffers
    ``inputs``, after one eager run of it on a side stream (the warm-up
    that ``torch.cuda.graphs`` asks for), into the memory pool ``pool``.
    ``replay()`` runs the graph on the current stream and returns its
    static outputs, as ``fn`` structures them, and adds the launches of the
    port's kernels that the capture recorded (``launches``) to
    ``_native``'s counts; the warm-up and the capture count none there.
    Call under ``no_grad``."""

    def __init__(self, fn, inputs, pool):
        self.inputs = inputs
        device = inputs[0].device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with _native.recording(), torch.cuda.stream(side):
            fn(*inputs)
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with _native.recording() as self.launches, \
                torch.cuda.graph(self.graph, pool=pool, stream=side):
            self.outputs = fn(*inputs)

    def replay(self):
        self.graph.replay()
        if self.launches:
            _native.add_counts(self.launches)
        return self.outputs


class Segments:
    """The CUDA graphs of one forward at one key (shape), each the chain of
    kernels between two of the forward's module calls, in the order the
    forward runs them, over one memory pool.  ``start()`` begins a forward;
    ``run(tag, fn, *inputs)`` then stands for ``fn(*inputs)`` (tensors in,
    a tensor or a flat tuple of them out): the first forward captures each
    chain where it reaches it (inside the profiler range
    ``capture_range``) and every forward replays them in that order, which
    ``tag`` checks.  ``run`` returns the graph's static outputs, which a
    later chain of the forward takes in place, without a copy, where it is
    handed the same tensor; any other input is copied into the graph's own
    buffer.  ``call`` returns fresh copies, for tensors that a module call
    takes or returns, so that nothing a hook keeps is overwritten by a
    later replay."""

    def __init__(self, capture_range):
        self.capture_range = capture_range
        self.pool = torch.cuda.graph_pool_handle()
        self._chains = []   # (tag, Captured) in the order of the forward
        self._static = {}   # id -> every chain's static output
        self._next = 0

    def start(self):
        self._next = 0
        return self

    def run(self, tag, fn, *inputs):
        i = self._next
        self._next += 1
        if i == len(self._chains):
            # as GraphCache's builds: buffers that take in-place copies in
            # inference mode and out of it
            with record_function(self.capture_range), \
                    torch.inference_mode(False), torch.no_grad():
                buffers = [t if self._static.get(id(t)) is t
                           else static_like(t) for t in inputs]
                self._load(buffers, inputs)
                chain = Captured(fn, buffers, self.pool)
            self._chains.append((tag, chain))
            self._static.update((id(t), t) for t in _leaves(chain.outputs))
        captured, chain = self._chains[i]
        if captured != tag:
            raise RuntimeError(f"graph {i} of the forward was captured as "
                               f"{captured!r}, replayed as {tag!r}")
        self._load(chain.inputs, inputs)
        return chain.replay()

    def call(self, tag, fn, *inputs):
        return fresh(self.run(tag, fn, *inputs))

    @staticmethod
    def _load(buffers, inputs):
        pairs = [(b, t) for b, t in zip(buffers, inputs) if b is not t]
        if pairs:
            copy_in(*zip(*pairs))


def run(segments, tag, fn, *inputs):
    """``fn(*inputs)``: eagerly where ``segments`` is None, else replayed
    from the forward's :class:`Segments` (its static outputs)."""
    if segments is None:
        return fn(*inputs)
    return segments.run(tag, fn, *inputs)


def call(segments, tag, fn, *inputs):
    """:func:`run`, whose outputs, on the graph path, are fresh copies."""
    if segments is None:
        return fn(*inputs)
    return segments.call(tag, fn, *inputs)


class GraphCache:
    """A model's captured graphs by key, lent to one call at a time: a call
    that finds them lent out runs eagerly.  A key's entry is built on its
    first call, inside the profiler range ``capture_range`` (which opens
    only then), with the gradient off and outside inference mode, so that
    its static buffers take in-place copies in either mode.  It keeps the
    ``keep`` keys used last: a new key beyond them drops the entry used
    longest ago, and with it its graphs' memory pool."""

    def __init__(self, capture_range, keep=8):
        self.capture_range = capture_range
        self.keep = keep
        self._lock = threading.Lock()
        self._kept = {}  # in the order of their last use

    @contextlib.contextmanager
    def hold(self, key, build):
        """The entry of ``key`` (``build()`` on a miss) for the ``with``
        block, or None while another call holds the cache."""
        if not self._lock.acquire(blocking=False):
            yield None
            return
        try:
            entry = self._kept.pop(key, None)
            if entry is None:
                while len(self._kept) >= self.keep:
                    del self._kept[next(iter(self._kept))]
                with record_function(self.capture_range), \
                        torch.inference_mode(False), torch.no_grad():
                    entry = build()
            self._kept[key] = entry
            yield entry
        finally:
            self._lock.release()

    def clear(self):
        """Drop every entry (a call that holds one keeps it to its end)."""
        self._kept.clear()

    def __len__(self):
        return len(self._kept)

    def __reduce__(self):
        # a copy of the model (deepcopy, pickle) starts with no graph: the
        # graphs read the original's parameters
        return GraphCache, (self.capture_range, self.keep)
