"""IGEV-Stereo in the port (``models/igev_stereo.py``) against the plain
float32 reference that the benchmark runs (``benchmark/reference/
igev_stereo.py``) on the reference's seeded weights, at 64x128 (48
disparities over a 32-wide 1/4 row) with the published channel widths and
4 iterations: the MobileNetV2 trunk and its decoder, the group-wise volume
(against ``correlation_volume`` and upstream's loop), the hourglass and the
starting disparity, the combined lookup (against ``grid_sample``, with taps
beyond both volumes), one update step, ``context_upsample``, the whole
forward, its profiler ranges and ``predict``.  Tolerances: an op 1e-5 and
a module 1e-4 (float32 summation order, as RAFT-Stereo's tests); the
volume stage and what follows it 2e-4 (16 3-D convolutions and batch norms
in a row), the full-resolution disparity 1e-3 (4 times the 1/4 one, over
about 90 pixels).  ``build_model`` dispatches
``MODEL.ARCH igev_stereo`` and refuses a mesh.  The update loop's CUDA
graphs off the card, as RAFT-Stereo's tests hold them: the CPU forward
captures nothing; the graph path's data flow, its capture stood in for,
gives every hook fresh tensors with the eager loop's bits."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import frames, harness
from benchmark.reference import igev_stereo as ref_igev
from nmrf_tpu_torch import predict
from nmrf_tpu_torch.models import IGEVStereo, build_model
from nmrf_tpu_torch.models.igev_stereo import context_upsample
from nmrf_tpu_torch.ops.correlation import correlation_volume

H, W, ITERS, SEED = 64, 128, 4, 7
SPEC = {"MODEL.ARCH": "igev_stereo", "RAFT.HIDDEN_DIMS": [128, 128, 128],
        "RAFT.N_DOWNSAMPLE": 2, "RAFT.CORR_LEVELS": 2, "RAFT.CORR_RADIUS": 4,
        "RAFT.VALID_ITERS": ITERS, "IGEV.MAX_DISP": 192,
        "DATASETS.DIVIS_BY": 32}
CAPTURE = "nmrf::igev.graph_capture"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    ref = ref_igev.init_weights(ref_igev.build(SPEC, "cpu"), SEED)
    port = build_model(harness.port_cfg(SPEC, SEED), device="cpu")
    assert set(ref.state_dict()) == set(port.state_dict())
    port.load_state_dict(ref.state_dict())
    return port, ref


@pytest.fixture(scope="module")
def pair():
    a, b, _, _ = frames.stereo_pair(frames.rng(SEED, 0), H, W, 96)
    return [torch.from_numpy(f[None].astype(np.float32)) for f in (a, b)]


@pytest.fixture(scope="module")
def stages(models, pair):
    """Each side's features, matching features and volume stage."""
    port, ref = models
    with torch.no_grad():
        x, left, stem_2x, match = port.features(*pair)
        img = [nchw(normed(t)) for t in pair]
        rl, rr = ref.feature(img[0]), ref.feature(img[1])
        s2 = [ref.stem_2(t) for t in img]
        rl[0] = torch.cat([rl[0], ref.stem_4(s2[0])], 1)
        rr[0] = torch.cat([rr[0], ref.stem_4(s2[1])], 1)
        rmatch = [ref.desc(ref.conv(f[0])) for f in (rl, rr)]
    return {"port": (x, left, stem_2x, match), "ref": (rl, s2[0], rmatch)}


def nchw(x):
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x.permute(0, 4, 1, 2, 3)


def last(x):
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x.permute(0, 2, 3, 4, 1)


def close(port, ref, tol):
    torch.testing.assert_close(port.float(), ref.float(), rtol=tol, atol=tol)


def normed(x):
    return 2 * (x / 255.0) - 1.0


def test_build_model_dispatch(models):
    port, _ = models
    assert isinstance(port, IGEVStereo) and not port.training
    assert port.divis_by == 32 and port.valid_iters == ITERS
    assert port.max_disp == 192
    assert sum(p.numel() for p in port.parameters()) == 12598114
    with pytest.raises(NotImplementedError):
        port.train()
    cfg = harness.port_cfg(SPEC, SEED)
    with pytest.raises(ValueError, match="one device"):
        build_model(cfg, device="cpu", mesh=object())
    bad = harness.port_cfg(dict(SPEC, **{"MODEL.ARCH": "psmnet"}), SEED)
    with pytest.raises(ValueError, match="'igev_stereo'"):
        build_model(bad, device="cpu")


def test_trunk_and_decoder_match(models, stages):
    port, ref = models
    _, left, stem_2x, match = stages["port"]
    rl, rs2, rmatch = stages["ref"]
    assert [f.shape[-1] for f in left] == [96, 64, 192, 160]
    for a, b in zip(left, rl):
        close(a, last(b), 1e-4)
    close(stem_2x, last(rs2), 1e-4)
    for a, b in zip(match, rmatch):
        close(a, last(b), 1e-4)


def test_volume_matches_correlation_volume_and_the_loop():
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(1, 96, 6, 20, generator=g) for _ in range(2))
    ours = correlation_volume(last(f1), last(f2), 24, 8)     # [B,H,W,G,D]
    theirs = ref_igev.build_gwc_volume(f1, f2, 24, 8)         # [B,G,D,H,W]
    close(ours.permute(0, 3, 4, 1, 2), theirs, 1e-5)
    direct = torch.zeros(1, 8, 24, 6, 20, dtype=torch.float64)
    a, b = f1.double().view(1, 8, 12, 6, 20), f2.double().view(1, 8, 12, 6, 20)
    for d in range(24):
        for w in range(d, 20):
            direct[..., d, :, w] = (a[..., w] * b[..., w - d]).mean(2)
    close(theirs, direct, 1e-5)


def test_hourglass_and_starting_disparity_match(models, stages):
    port, ref = models
    _, left, _, match = stages["port"]
    rl, _, rmatch = stages["ref"]
    with torch.no_grad():
        geo, init = port.volume(*match, left)
        rgeo, rinit = ref.volume(rl, *rmatch)
    assert geo.shape == (1, 48, H // 4, W // 4, 8)
    close(geo, last(rgeo), 2e-4)
    close(init, rinit[:, 0], 2e-4)
    assert 0.0 < float(init.min()) and float(init.max()) < 47.0


@pytest.mark.parametrize("radius", [1, 4])
def test_combined_lookup_matches_grid_sample(radius):
    g = torch.Generator().manual_seed(5)
    port = IGEVStereo(corr_levels=2, corr_radius=radius, valid_iters=1,
                      max_disp=96)
    f1, f2 = (torch.randn(1, 2, 16, 12, generator=g) for _ in range(2))
    geo = torch.randn(1, 24, 2, 16, 8, generator=g)          # [B,D,h,w,C]
    # disparities inside the volume, at its edges and beyond it both ways
    disp = torch.rand(1, 2, 16, generator=g) * 40.0 - 8.0
    disp[0, 0, :4] = torch.tensor([-4.5, -0.25, 23.0, 23.75])
    with torch.no_grad():
        consts = port.lookup_consts(16, disp.device)
        taps = port.lookup(port.geo_block(geo), port.corr_block(f1, f2),
                           disp, consts)
    fn = ref_igev.Combined_Geo_Encoding_Volume(
        nchw(f1), nchw(f2), nchw(geo), num_levels=2, radius=radius)
    coords = torch.arange(16.0).reshape(1, 1, 16, 1).repeat(1, 2, 1, 1)
    want = fn(disp.unsqueeze(1), coords)
    assert taps.shape[-1] == 2 * (2 * radius + 1) * 9
    close(taps, last(want), 1e-5)


def test_update_step_matches(models):
    port, ref = models
    g = torch.Generator().manual_seed(5)
    h4, h8, h16 = (H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16)
    net = [torch.tanh(torch.randn(1, *s, 128, generator=g))
           for s in (h4, h8, h16)]
    inp = [tuple(torch.randn(1, *s, 128, generator=g) * 0.5 for _ in range(3))
           for s in (h4, h8, h16)]
    corr = torch.randn(1, *h4, 162, generator=g)
    disp = torch.rand(1, *h4, 1, generator=g) * 40.0
    with torch.no_grad():
        pn, pm, pd = port.update_block(net, inp, corr, disp)
        rn, rm, rd = ref.update_block(
            [nchw(n) for n in net],
            [[nchw(t) for t in level] for level in inp],
            nchw(corr), nchw(disp))
    for a, b in zip(pn, rn):
        close(a, last(b), 1e-4)
    close(pm, last(rm), 1e-4)
    close(pd, last(rd), 1e-4)


def test_context_upsample_matches():
    g = torch.Generator().manual_seed(9)
    disp = torch.randn(1, 4, 6, generator=g) * 10.0
    weights = torch.softmax(torch.randn(1, 16, 24, 9, generator=g), -1)
    close(context_upsample(disp, weights),
          ref_igev.context_upsample(disp.unsqueeze(1), nchw(weights)), 1e-5)


def test_forward_matches(models, pair):
    port, ref = models
    with torch.no_grad():
        p = port(*pair)
        r = ref(*pair, keep_disp=(ITERS,))
    assert port.iterations == ITERS
    assert p["disp"].dtype == torch.float32 and p["disp"].shape == (1, H, W)
    close(p["init_disp"], r["init_disp"], 2e-4)
    close(p["disp_lowres"], r["disp_lowres"][ITERS], 2e-4)
    close(p["disp"], r["disp"], 1e-3)
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
    close(torch.from_numpy(disp), r, 1e-3)


RANGES = ["nmrf::igev.features", "nmrf::igev.volume", "nmrf::igev.context",
          "nmrf::igev.corr", "nmrf::igev.update", "nmrf::igev.upsample"]


def test_every_forward_op_in_one_range(models, pair):
    """Every op of the forward lies in exactly one of the six ranges, in
    order; the lookups in ``nmrf::igev.lookup`` inside ``.update``, one an
    iteration; the model counts the iterations it ran."""
    port, _ = models

    def spans(events, names):
        return sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in events if e.name in names)

    def inside(t, span):
        return span[0] <= t[0] and t[1] <= span[1]

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        port(*pair)
    events = list(prof.events())
    top = spans(events, set(RANGES))
    assert [s[2] for s in top] == RANGES
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    lookups = spans(events, {"nmrf::igev.lookup"})
    assert len(lookups) == ITERS
    assert all(inside(s, top[4]) for s in lookups)
    ops = [e for e in events if e.name.startswith("aten::")]
    assert len(ops) > 300
    for e in ops:
        t = (e.time_range.start, e.time_range.end)
        holders = [s[2] for s in top if inside(t, s)]
        assert len(holders) == 1, (e.name, holders)
    assert port.iterations == ITERS


# ---- the update loop's CUDA graphs, off the card ---- #

class Replayed:
    """``graphs.Captured`` off the card: ``fn`` run at each replay, its
    outputs written into the buffers the first run returned."""

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


def request(model, kept, frames_):
    kept.append({"calls": []})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        disp = predict(model, *frames_)
    kept[-1]["disp"] = torch.from_numpy(disp)
    return sum(e.name == CAPTURE for e in prof.events())


def same(a, b):
    assert len(a["calls"]) == len(b["calls"]) == ITERS
    for x, y in zip(a["calls"], b["calls"]):
        assert all(torch.equal(s, t) for s, t in zip(x, y))
    for key in ("disp", "disp_lowres", "init_disp"):
        assert torch.equal(a["out"][key], b["out"][key]), key
    assert torch.equal(a["disp"], b["disp"])


def test_graph_path_hands_out_fresh_tensors(models, monkeypatch):
    """The CPU forward captures nothing; with ``graphs.Captured`` replaced
    by ``Replayed``, three requests capture once and equal the eager
    loop's every hooked tensor (the taps and disparity passed to
    ``update_block``, the states, ``mask_feat_4`` and delta returned) to
    the bit; the first request's tensors are unchanged after the others
    and none is a static buffer; a request that finds the graphs held runs
    eagerly."""
    from nmrf_tpu_torch.models import graphs

    port = build_model(harness.port_cfg(SPEC, SEED), device="cpu")
    port.load_state_dict(models[0].state_dict())
    kept = []
    port.update_block.register_forward_hook(
        lambda m, args, out: kept[-1]["calls"].append(
            (*args[2:], *out[0], out[1], out[2])))
    port.register_forward_hook(lambda m, args, out: kept[-1].update(out=out))
    frames_ = frames.stereo_pair(frames.rng(SEED, 2), 60, 124, 40)[:2]
    assert request(port, kept, frames_) == 0
    assert len(port.update_graphs) == 0
    eager = kept.pop()

    monkeypatch.setattr(graphs, "capturable",
                        lambda x: not torch.is_grad_enabled())
    monkeypatch.setattr(graphs, "Captured", Replayed)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    assert [request(port, kept, frames_) for _ in range(3)] == [1, 0, 0]
    first = [[t.clone() for t in call] for call in kept[0]["calls"]]
    for k in kept:
        same(k, eager)
    for call, copy in zip(kept[0]["calls"], first):
        assert all(torch.equal(t, c) for t, c in zip(call, copy))
    (entry,) = port.update_graphs._kept.values()
    static = {t.data_ptr() for t in [
        *entry.held, entry.x, *entry.update_in,
        *leaves(entry._lookup.outputs), *leaves(entry._update.outputs)]}
    assert not static & {t.data_ptr() for k in kept
                         for call in k["calls"] for t in call}
    with port.update_graphs.hold("another call", object):
        assert request(port, kept, frames_) == 0
    same(kept[-1], eager)
