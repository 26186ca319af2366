"""NMRF's forward from CUDA graphs (``models/nmrf.py``,
``models/graphs.py:Segments``), off the card: ``graphs.Captured`` stood in
for by an eager replay and ``graphs.capturable`` made true without a
gradient, on a tiny model of each backbone served through ``predict``.

Three requests on one shape capture once; every tensor the benchmark's
six hooks keep (``benchmark/traffic/serve_stream.py:_hooks``) and the
output dict equal the eager forward's to the bit; the first request's
tensors are unchanged after a request on other frames and share no
storage with a graph's buffer; each NMP ``WindowAttention`` is called once
a layer and every ``nmrf::*`` range opens; a new shape captures again; a
request that finds the graphs held runs eagerly (the eager forward here),
and so does one with a hook on a module inside a graph; a forward that
records a gradient, or in train mode, never reaches the graphs.  A tap
radius changed in place captures anew, train mode drops the graphs, and
the cache keeps the keys used last.  And a
forward copies no host array to its device after the first (a capture
cannot), on the plain path too: checked on the meta device."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from nmrf_tpu_torch import build_model, get_cfg, predict
from nmrf_tpu_torch.models import graphs
from nmrf_tpu_torch.models.adaptor import MSDeformAttn
from nmrf_tpu_torch.models.nmp import WindowAttention

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["DPN.MAX_DISP", "64", "SOLVER.MAX_DISP", "48",
         "NMP.NUM_PROP_LAYERS", "2", "NMP.NUM_INFER_LAYERS", "2",
         "NMP.NUM_REFINE_LAYERS", "2", "SOLVER.LOSS_WEIGHTS",
         "[1.0, 1.2, 1.4, 2.0]"]
CAPTURE = "nmrf::graph_capture"
RANGES = ["nmrf::backbone", "nmrf::cost_volume", "nmrf::dpn",
          "nmrf::inference", "nmrf::refinement", "nmrf::predict",
          "nmrf::predict.prep", "nmrf::predict.copy_in",
          "nmrf::predict.forward", "nmrf::predict.wait",
          "nmrf::predict.copy_out"]
# the output dict's tensors
OUT = ["disp", "disp_pred", "prob", "proposal", "initial_proposal"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_of(variant, *opts):
    cfg = get_cfg()
    if variant == "swin":
        cfg.merge_from_file(str(ROOT / "configs" / "sceneflow_swint.yaml"))
    cfg.merge_from_list(SMALL + list(opts))
    torch.manual_seed(0)
    return build_model(cfg, device="cpu").eval()


def frames(h, w, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(2)]


class Replayed:
    """``graphs.Captured`` off the card: ``fn`` run at each replay, its
    outputs written into the buffers the first run returned, as a graph's
    replay writes its static outputs."""

    def __init__(self, fn, inputs, pool):
        self.fn, self.inputs = fn, inputs
        self.outputs = fn(*inputs)

    def replay(self):
        for dst, src in zip(graphs._leaves(self.outputs),
                            graphs._leaves(self.fn(*self.inputs))):
            dst.copy_(src)
        return self.outputs


def keep(model):
    """The benchmark's six hooks, each keeping what it picks of a module's
    output, the whole output dict, and each NMP window attention's calls.
    Returns the list each request appends its dict to."""
    kept = []

    def hook(key, pick):
        def fn(module, args, out):
            kept[-1][key] = pick(out)
        return fn

    model.backbone.register_forward_hook(hook("features", lambda o: o[1]))
    model.inference.register_forward_hook(hook("inference", lambda o: o[0]))
    model.infer_head.register_forward_hook(hook("head", lambda o: o[-1]))
    model.infer_score_head.register_forward_hook(hook("score",
                                                      lambda o: o[-1]))
    model.refinement.register_forward_hook(hook("refinement", lambda o: o[0]))
    model.register_forward_hook(hook("out", lambda o: dict(o)))
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.register_forward_hook(
                lambda m, args, out: kept[-1]["attn"].append(m))
    return kept


def tensors(k):
    """Every kept tensor of one request, by name."""
    out = {key: k[key] for key in ("features", "inference", "head", "score",
                                   "refinement", "disp")}
    out.update((f"out.{key}", k["out"][key]) for key in OUT)
    return out


def request(model, kept, pair):
    """One ``predict``; returns the names of the ranges it opened."""
    kept.append({"attn": []})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kept[-1]["disp"] = torch.from_numpy(predict(model, *pair))
    return [e.name for e in prof.events() if e.name.startswith("nmrf::")]


def same(a, b):
    got, want = tensors(a), tensors(b)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def stand_in(monkeypatch):
    """The graph path on the CPU: ``capturable`` wherever no gradient is
    recorded, ``Captured`` replaced by ``Replayed``."""
    monkeypatch.setattr(graphs, "capturable",
                        lambda x: not torch.is_grad_enabled())
    monkeypatch.setattr(graphs, "Captured", Replayed)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


@pytest.mark.parametrize("variant", ["resnet", "swin"])
def test_graph_path_hands_out_fresh_tensors(variant, monkeypatch):
    """The graph path's data flow (module docstring): requests on two
    frame pairs of one shape, each against the eager forward's."""
    model = model_of(variant)
    attns = [m for m in model.modules() if isinstance(m, WindowAttention)]
    kept = keep(model)
    pairs = [frames(60, 124, 1), frames(60, 124, 2)]
    stand_in(monkeypatch)
    with model.forward_graphs.hold("another call", object):
        for pair in pairs:
            assert CAPTURE not in request(model, kept, pair)
    eager = [kept.pop(0) for _ in pairs]
    assert len(model.forward_graphs) == 1  # "another call"'s

    order = [0, 1, 0]
    opened = [request(model, kept, pairs[i]) for i in order]
    assert [CAPTURE in names for names in opened] == [True, False, False]
    assert len(model.forward_graphs) == 2
    for names in opened:
        assert set(RANGES) <= set(names)
    first = {key: t.clone() for key, t in tensors(kept[0]).items()}
    for i, k in zip(order, kept):
        same(k, eager[i])
        assert k["attn"] == attns  # each window attention once, in order
    for key, t in tensors(kept[0]).items():
        assert torch.equal(t, first[key]), key

    (entry,) = [e for e in model.forward_graphs._kept.values()
                if isinstance(e, graphs.Segments)]
    # 7 chains outside the NMP stages, one a window attention and 2 more
    assert len(entry._chains) == 7 + len(attns) + 2
    static = {t.untyped_storage().data_ptr()
              for _, chain in entry._chains
              for t in [*chain.inputs, *graphs._leaves(chain.outputs)]}
    assert not static & {t.untyped_storage().data_ptr() for k in kept
                         for t in tensors(k).values()}

    assert CAPTURE in request(model, kept, frames(92, 180, 3))
    assert len(model.forward_graphs) == 3


class Untouchable:
    def hold(self, key, build):
        raise AssertionError("the forward reached the graphs")

    def clear(self):  # train mode drops the graphs
        pass


@pytest.mark.parametrize("mode", ["grad", "train"])
def test_graphs_left_alone_by_training_forwards(mode, monkeypatch):
    """A forward that records a gradient, or one in train mode, runs
    eagerly without reaching the graph cache, and gives the eager
    forward's outputs."""
    stand_in(monkeypatch)
    model = model_of("resnet")
    x = [torch.from_numpy(f.astype(np.float32)[None, :56, :120])
         for f in frames(60, 124, 3)]
    with torch.no_grad(), model.forward_graphs.hold("eager", object):
        want = model(*x)
    model.forward_graphs = Untouchable()
    if mode == "train":
        model.train()
        with torch.no_grad():
            got = model(*x)
        for key in ("disp", "prob", "proposal"):
            assert torch.equal(got[key], want[key]), key
    else:
        got = model(*x)
        assert got["disp"].requires_grad
        for key in OUT:
            assert torch.equal(got[key].detach(), want[key]), key


def test_hook_inside_a_graph_keeps_the_forward_eager(monkeypatch):
    """A hook on a module whose call a graph would replay (``concatconv``,
    4 calls a forward) keeps the forward eager, so the hook sees every
    call; without it the next request captures."""
    stand_in(monkeypatch)
    model = model_of("resnet")
    kept = keep(model)
    calls = []
    handle = model.concatconv.register_forward_hook(
        lambda m, args, out: calls.append(out))
    pair = frames(60, 124, 4)
    assert CAPTURE not in request(model, kept, pair)
    assert CAPTURE not in request(model, kept, pair)
    assert len(calls) == 8 and len(model.forward_graphs) == 0
    handle.remove()
    assert CAPTURE in request(model, kept, pair)
    same(kept[-1], kept[0])


def test_tap_radius_changed_in_place_captures_anew(monkeypatch):
    """The deformable attentions' tap radius, which the train step's tap
    guard sets to 0 in place (``solver/step.py:read_oob``), is part of the
    graphs' key: a request after the change captures anew and equals the
    eager exact path; train mode drops every graph."""
    stand_in(monkeypatch)
    model = model_of("swin")
    kept = keep(model)
    pair = frames(60, 124, 5)
    assert CAPTURE in request(model, kept, pair)
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.tap_radius = 0
    with model.forward_graphs.hold("another call", object):
        assert CAPTURE not in request(model, kept, pair)
    assert CAPTURE in request(model, kept, pair)
    same(kept[-1], kept[-2])
    assert len(model.forward_graphs) == 3
    model.train()
    assert len(model.forward_graphs) == 0
    model.eval()
    assert CAPTURE in request(model, kept, pair)
    same(kept[-1], kept[-2])


def test_graph_cache_keeps_the_keys_used_last():
    """``GraphCache`` keeps its ``keep`` keys used last: a new key drops
    the one used longest ago, which its next use builds again."""
    cache = graphs.GraphCache("range", keep=2)
    built = []

    def use(key):
        with cache.hold(key, lambda: built.append(key) or key) as entry:
            assert entry == key

    for key in "abaca":
        use(key)
    assert built == ["a", "b", "c"]
    use("b")
    assert built == ["a", "b", "c", "b"] and len(cache) == 2
    use("a")
    assert len(built) == 4
    cache.clear()
    assert len(cache) == 0


class HostCopies(TorchDispatchMode):
    """The ops that take a host tensor (not a scalar) into a meta one."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in [*args, *(kwargs or {}).values()]
               if isinstance(a, torch.Tensor)]
        outs = out if isinstance(out, (tuple, list)) else [out]
        if any(isinstance(o, torch.Tensor) and o.is_meta for o in outs) \
                and any(a.device.type == "cpu" and a.dim() for a in ins):
            self.seen.add(str(func))
        return out


@pytest.mark.parametrize("variant", ["resnet", "swin"])
def test_forward_copies_nothing_from_the_host(variant):
    """The eval forward's second call on the meta device (the plain
    versions: the kernels run on a card only) takes no host array in."""
    model = model_of(variant, "TPU.USE_PALLAS", "False").to("meta")
    x = [torch.zeros(1, 64, 128, 3, device="meta") for _ in range(2)]
    with torch.no_grad():
        model(*x)
        with HostCopies() as copies:
            model(*x)
    assert not copies.seen
