"""RAFT-Stereo in the port (``models/raft_stereo.py``) against the plain
float32 reference that the benchmark runs (``benchmark/reference/
raft_stereo.py``) on the reference's seeded weights, at 64x128 with 4
iterations: each encoder's outputs, the correlation pyramid and its
lookup (also against a direct formula with taps beyond the row), one
update step, the whole forward and ``predict``.  Ops at 1e-5, modules at
1e-4.  And ``build_model`` under ``MODEL.ARCH nmrf`` builds the NMRF
model it built before RAFT-Stereo came, to the bit.  The update loop's
CUDA graphs off the card: the CPU forward, with or without a gradient,
captures nothing and is the eager loop's to the bit; the graph path's
data flow, its capture stood in for, hands every hook fresh tensors with
the eager loop's bits; ``GraphCache`` lends its graphs to one call at a
time."""

import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import frames, harness
from benchmark.reference import raft_stereo as ref_raft
from nmrf_tpu_torch import get_cfg, predict
from nmrf_tpu_torch.models import NMRF, RAFTStereo, build_model
from nmrf_tpu_torch.models.raft_stereo import CorrBlock1D, convex_upsample

H, W, ITERS, SEED = 64, 128, 4, 7
SPEC = {"MODEL.ARCH": "raft_stereo", "RAFT.HIDDEN_DIMS": [128, 128, 128],
        "RAFT.N_DOWNSAMPLE": 2, "RAFT.CORR_LEVELS": 4, "RAFT.CORR_RADIUS": 4,
        "RAFT.VALID_ITERS": ITERS, "DATASETS.DIVIS_BY": 32}
# the reference's keys the port leaves out: biases an instance norm cancels
DROPPED = {"fnet.conv1.bias"} | {
    f"fnet.layer{i}.{j}.conv{k}.bias" for i in (1, 2, 3) for j in (0, 1)
    for k in (1, 2)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    ref = ref_raft.init_weights(ref_raft.build(SPEC, "cpu"), SEED)
    port = build_model(harness.port_cfg(SPEC, SEED), device="cpu")
    state = ref.state_dict()
    assert set(state) - set(port.state_dict()) == DROPPED
    assert set(port.state_dict()) <= set(state)
    port.load_state_dict({k: v for k, v in state.items() if k not in DROPPED})
    return port, ref


@pytest.fixture(scope="module")
def pair():
    a, b, _, _ = frames.stereo_pair(frames.rng(SEED, 0), H, W, 48)
    return [torch.from_numpy(f[None].astype(np.float32)) for f in (a, b)]


def nchw(x):
    return x.permute(0, 3, 1, 2)


def close(port, ref, tol):
    torch.testing.assert_close(port.float(), ref.float(), rtol=tol, atol=tol)


def normed(x):
    return 2 * (x / 255.0) - 1.0


def test_build_model_dispatch(models):
    port, _ = models
    assert isinstance(port, RAFTStereo) and not port.training
    assert port.divis_by == 32 and port.valid_iters == ITERS
    with pytest.raises(NotImplementedError):
        port.train()
    cfg = harness.port_cfg(SPEC, SEED)
    with pytest.raises(ValueError, match="one device"):
        build_model(cfg, device="cpu", mesh=object())
    bad = harness.port_cfg(dict(SPEC, **{"MODEL.ARCH": "psmnet"}), SEED)
    with pytest.raises(ValueError, match="psmnet"):
        build_model(bad, device="cpu")


# sha256 over (key, bytes) of the state_dict, from the tree before MODEL.ARCH
NMRF_DIGESTS = {
    "resnet": "c9454ababe252274fedf4477db3edf5e3270689786a991505d922003558125b8",
    "swin": "1992060ce9746f7c371789f787d4ecd5bf5e31c5cf6701ce4212be5a9d47a0f3",
}


@pytest.mark.parametrize("variant", sorted(NMRF_DIGESTS))
@pytest.mark.parametrize("explicit", [False, True])
def test_nmrf_weights_unchanged(variant, explicit):
    cfg = get_cfg()
    opts = ["NMP.NUM_PROP_LAYERS", 2, "NMP.NUM_INFER_LAYERS", 2,
            "NMP.NUM_REFINE_LAYERS", 2]
    if variant == "swin":
        opts += ["BACKBONE.MODEL_TYPE", "swin", "DATASETS.DIVIS_BY", 32]
    if explicit:
        opts += ["MODEL.ARCH", "nmrf"]
    cfg.merge_from_list(opts)
    assert cfg.MODEL.ARCH == "nmrf"
    model = build_model(cfg, device="cpu")
    assert isinstance(model, NMRF)
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    assert h.hexdigest() == NMRF_DIGESTS[variant]


def test_fnet_matches(models, pair):
    port, ref = models
    x = normed(torch.cat(pair))
    with torch.no_grad():
        close(port.fnet(x), ref.fnet(nchw(x)).permute(0, 2, 3, 1), 1e-4)


def test_cnet_and_context_match(models, pair):
    port, ref = models
    x = normed(pair[0])
    with torch.no_grad():
        p, r = port.cnet(x), ref.cnet(nchw(x))
        for lp, lr, cp, cr in zip(p, r, port.context_zqr_convs,
                                  ref.context_zqr_convs):
            for a, b in zip(lp, lr):
                close(a, b.permute(0, 2, 3, 1), 1e-4)
            close(cp(torch.relu(lp[1])),
                  cr(torch.relu(lr[1])).permute(0, 2, 3, 1), 1e-4)


def direct_lookup(levels, coords, radius):
    """The lookup by its definition, a tap at a time: at level i the row at
    coords / 2^i + d linearly interpolated, 0 beyond the row."""
    B, h, w = coords.shape
    out = torch.zeros(B, h, w, len(levels) * (2 * radius + 1),
                      dtype=torch.float64)
    for b in range(B):
        for y in range(h):
            for x in range(w):
                c = 0
                for i, level in enumerate(levels):
                    row = level[b, y, x].double()
                    for d in range(-radius, radius + 1):
                        t = float(coords[b, y, x]) / 2 ** i + d
                        x0 = int(np.floor(t))
                        f = t - x0

                        def at(k):
                            return row[k] if 0 <= k < len(row) else 0.0
                        out[b, y, x, c] = (1 - f) * at(x0) + f * at(x0 + 1)
                        c += 1
    return out


@pytest.fixture(scope="module")
def volume():
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(1, 2, 16, 16, generator=g) for _ in range(2))
    # matches inside the row, at its edges, and beyond it on both sides
    coords = torch.rand(1, 2, 16, generator=g) * 32.0 - 8.0
    coords[0, 0, :4] = torch.tensor([-4.5, -0.25, 15.0, 15.75])
    return f1, f2, coords


def test_pyramid_matches_the_reference_and_the_definition(volume):
    f1, f2, _ = volume
    block = CorrBlock1D(4, 4)
    pyramid = block(f1, f2)
    corr = torch.einsum("bhic,bhjc->bhij", f1.double(), f2.double()) / 4.0
    widths = block.widths(16)
    assert widths == [16, 8, 4, 2] and pyramid.shape[-1] == sum(widths)
    close(pyramid[..., :16], corr, 1e-5)
    ref = ref_raft.CorrBlock1D(nchw(f1), nchw(f2), 4, 4)
    close(pyramid[..., :16], ref.level0, 1e-5)
    start = 0
    for i, w in enumerate(widths):
        level = ref.corr_pyramid[i].reshape(1, 2, 16, w)
        close(pyramid[..., start:start + w], level, 1e-5)
        start += w


@pytest.mark.parametrize("radius", [1, 4])
def test_lookup_matches_the_definition(volume, radius):
    f1, f2, coords = volume
    block = CorrBlock1D(4, radius)
    pyramid = block(f1, f2)
    taps = block.lookup(pyramid, coords, block.grid(16, coords.device))
    starts = np.cumsum([0] + block.widths(16))
    levels = [pyramid[..., a:b] for a, b in zip(starts[:-1], starts[1:])]
    close(taps, direct_lookup(levels, coords, radius), 1e-5)
    # the reference's lookup (grid_sample) at the same matches
    ref = ref_raft.CorrBlock1D(nchw(f1), nchw(f2), 4, radius)
    grid = torch.stack([coords, torch.zeros_like(coords)], 1)
    close(taps, ref(grid).permute(0, 2, 3, 1), 1e-5)


def test_update_step_matches(models, pair):
    port, ref = models
    g = torch.Generator().manual_seed(5)
    h4, h8, h16 = (H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16)
    net = [torch.tanh(torch.randn(1, *s, 128, generator=g))
           for s in (h4, h8, h16)]
    inp = [tuple(torch.randn(1, *s, 128, generator=g) * 0.5 for _ in range(3))
           for s in (h4, h8, h16)]
    corr = torch.randn(1, *h4, 36, generator=g) * 3.0
    flow = torch.stack([torch.randn(1, *h4, generator=g) * 2.0,
                        torch.zeros(1, *h4)], -1)
    with torch.no_grad():
        pn, pm, pd = port.update_block(net, inp, corr, flow)
        rn, rm, rd = ref.update_block(
            [nchw(n) for n in net], [[nchw(t) for t in level] for level in inp],
            nchw(corr), nchw(flow))
    for a, b in zip(pn, rn):
        close(a, b.permute(0, 2, 3, 1), 1e-4)
    close(pm, rm.permute(0, 2, 3, 1), 1e-4)
    close(pd, rd.permute(0, 2, 3, 1), 1e-4)


def test_convex_upsample_matches(models):
    _, ref = models
    g = torch.Generator().manual_seed(9)
    flow = torch.randn(1, 4, 6, generator=g)
    mask = torch.randn(1, 4, 6, 144, generator=g)
    up = convex_upsample(flow, mask, 4)
    r = ref.upsample_flow(torch.stack([flow, torch.zeros_like(flow)], 1),
                          nchw(mask))
    close(up, r[:, 0], 1e-5)


def test_forward_matches(models, pair):
    port, ref = models
    with torch.no_grad():
        p = port(*pair)
        r = ref(*pair, keep_disp=(ITERS,))
    assert port.iterations == ITERS
    assert p["disp"].dtype == torch.float32 and p["disp"].shape == (1, H, W)
    close(p["disp"], r["disp"], 1e-4)
    close(p["disp_lowres"], r["disp_lowres"][ITERS], 1e-4)
    assert float(p["disp_lowres"].min()) > 0.0


def test_predict_serves_it(models):
    port, ref = models
    a, b, _, _ = frames.stereo_pair(frames.rng(SEED, 1), 60, 124, 40)
    disp = predict(port, a, b)
    assert disp.shape == (60, 124) and disp.dtype == np.float32
    x = [torch.from_numpy(frames.pad_to(f, 32)[None].astype(np.float32))
         for f in (a, b)]
    with torch.no_grad():
        r = ref(*x)["disp"][0, :60, :124]
    close(torch.from_numpy(disp), r, 1e-4)


# ---- the update loop's CUDA graphs, off the card ---- #

CAPTURE = "nmrf::raft.graph_capture"


def eager_forward(model, img1, img2):
    """``RAFTStereo.forward`` as it ran before the loop's graphs came, a
    step at a time (hooks on the update block left out)."""
    net, inp, fmap1, fmap2 = model.encode(img1, img2)
    pyramid = model.corr_block(fmap1, fmap2)
    B, h, w, _ = fmap1.shape
    columns = torch.arange(w, device=fmap1.device, dtype=torch.float32)
    flow = fmap1.new_zeros((B, h, w), dtype=torch.float32)
    zero = torch.zeros_like(flow)
    grid = model.corr_block.grid(w, fmap1.device)
    for _ in range(model.valid_iters):
        corr = model.corr_block.lookup(pyramid, columns + flow, grid)
        net, mask, delta = model.update_block.forward(
            net, inp, corr, torch.stack([flow, zero], dim=-1))
        flow = flow + delta[..., 0]
    disp = -convex_upsample(flow, mask, 2 ** model.n_downsample)
    return {"disp": disp, "disp_lowres": -flow}


def captures(fn):
    """fn()'s result and how often the capture range opened in it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == CAPTURE for e in prof.events())


@pytest.fixture
def port(models):
    model = build_model(harness.port_cfg(SPEC, SEED), device="cpu")
    model.load_state_dict(models[0].state_dict())
    return model


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_forward_runs_the_eager_loop(port, pair, grad):
    """On the CPU, with or without a gradient recorded, no graph is
    captured and the forward is the eager loop's, to the bit."""
    with torch.no_grad():
        want = eager_forward(port, *pair)
    with torch.set_grad_enabled(grad):
        got, opened = captures(lambda: port(*pair))
    assert opened == 0 and len(port.update_graphs) == 0
    assert port.iterations == ITERS
    for key in want:
        assert torch.equal(got[key].detach(), want[key]), key


class Replayed:
    """``graphs.Captured`` off the card: ``fn`` run at each replay, its
    outputs written into the buffers the first run returned, as a graph's
    replay writes its static outputs."""

    def __init__(self, fn, inputs, pool):
        self.fn, self.inputs = fn, inputs
        self.outputs = fn(*inputs)

    def replay(self):
        for dst, src in zip(leaves(self.outputs),
                            leaves(self.fn(*self.inputs))):
            dst.copy_(src)
        return self.outputs


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in leaves(item)]


def keep_iterations(model):
    """Hooks as the benchmark's: every update call's taps and flow
    (``args[2:]``) and returned states, mask and delta; the model's
    output.  Returns the list each request appends its dict to."""
    kept = []

    def update(module, args, out):
        kept[-1]["calls"].append((*args[2:], *out[0], out[1], out[2]))

    def whole(module, args, out):
        kept[-1]["out"] = out

    model.update_block.register_forward_hook(update)
    model.register_forward_hook(whole)
    return kept


def request(model, kept, frames_):
    kept.append({"calls": []})
    disp, opened = captures(lambda: predict(model, *frames_))
    kept[-1]["disp"] = torch.from_numpy(disp)
    return opened


def same(a, b):
    assert len(a["calls"]) == len(b["calls"]) == ITERS
    for x, y in zip(a["calls"], b["calls"]):
        assert all(torch.equal(s, t) for s, t in zip(x, y))
    for key in ("disp", "disp_lowres"):
        assert torch.equal(a["out"][key], b["out"][key]), key
    assert torch.equal(a["disp"], b["disp"])


def test_graph_path_hands_out_fresh_tensors(port, monkeypatch):
    """The graph path's data flow on the CPU, ``graphs.Captured`` replaced
    by ``Replayed``: three requests on the same frames capture once and
    equal the eager loop's every hooked tensor, at every iteration, to the
    bit; the tensors kept from the first request are unchanged after the
    others and none is a static buffer; a new shape captures again; a
    request that finds the graphs held by another call runs eagerly."""
    from nmrf_tpu_torch.models import graphs

    kept = keep_iterations(port)
    frames_ = frames.stereo_pair(frames.rng(SEED, 2), 60, 124, 40)[:2]
    assert request(port, kept, frames_) == 0
    eager = kept.pop()

    monkeypatch.setattr(graphs, "capturable",
                        lambda x: not torch.is_grad_enabled())
    monkeypatch.setattr(graphs, "Captured", Replayed)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    opened = [request(port, kept, frames_) for _ in range(3)]
    assert opened == [1, 0, 0] and len(port.update_graphs) == 1
    first = [[t.clone() for t in call] for call in kept[0]["calls"]]
    for k in kept:
        same(k, eager)
    for call, copy in zip(kept[0]["calls"], first):
        assert all(torch.equal(t, c) for t, c in zip(call, copy))
    (entry,) = port.update_graphs._kept.values()
    static = {t.data_ptr() for t in [
        entry.pyramid, entry.flow, *entry.update_in,
        *leaves(entry._lookup.outputs), *leaves(entry._update.outputs)]}
    assert not static & {t.data_ptr() for k in kept
                         for call in k["calls"] for t in call}

    other = frames.stereo_pair(frames.rng(SEED, 3), 92, 180, 40)[:2]
    assert request(port, kept, other) == 1
    assert len(port.update_graphs) == 2
    with port.update_graphs.hold("another call", object):
        assert request(port, kept, frames_) == 0
    same(kept[-1], eager)


def test_graph_cache_lends_to_one_call(monkeypatch):
    """``GraphCache``: an entry built once a key inside its range, None
    to a call while another holds the cache, the lock given back when the
    block or a build raises; a copy starts empty."""
    import copy

    from nmrf_tpu_torch.models.graphs import GraphCache

    cache = GraphCache(CAPTURE)
    built = []

    def build():
        built.append(object())
        return built[-1]

    def use(key):
        with cache.hold(key, build) as entry:
            with cache.hold(key, build) as inner:
                assert inner is None
            return entry

    got, opened = captures(lambda: [use("a"), use("a"), use("b")])
    assert opened == 2 and got == [built[0], built[0], built[1]]
    with pytest.raises(RuntimeError):
        with cache.hold("c", lambda: (_ for _ in ()).throw(RuntimeError())):
            pass
    with pytest.raises(KeyError):
        with cache.hold("a", build):
            raise KeyError("a")
    assert use("a") is built[0] and len(cache) == 2
    clone = copy.deepcopy(cache)
    assert len(clone) == 0 and clone.capture_range == CAPTURE
