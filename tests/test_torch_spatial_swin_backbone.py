"""The swin backbone on a rank's H tile against the whole-image backbone
(CPU, float32, gloo, worlds of 2 and 4 processes).

Under a spatial mesh each rank feeds only its H tile of the images into
the swin backbone (Swin-T and the deformable neck): Swin-T's windows take
the rows they need from the neighbour tiles, stages too short for a tile
run whole on every rank, and the neck's stem, queries, depthwise
convolutions and value maps work on the tile with halo rows
(``nmrf_tpu_torch/models/swin.py``, ``models/adaptor.py``).  The test
model (``swin_backbone_cfg``: OUT_CHANNELS 128, drop-path 0.4 with the
same masks on both sides) at 192 x 64, one pair, on 1 x 2 and 1 x 4 grids:

* each rank's features of both levels and both views equal the whole-image
  backbone's rows of its tile within 2e-5 (the resnet tile's tolerance,
  ``tests/test_torch_spatial_backbone.py``);
* the world-summed gradients of every backbone parameter for
  ``sum(feature * cotangent) / size`` equal the whole-image backbone's at
  that file's tolerance (|d| / max |g| over the backbone < 1e-2), the same
  sum on every rank;
* the collectives by site, forward and backward, are the count and bytes
  worked out here from the shapes (``expected_counts``).

The cases (``test_the_cases_are_held`` checks the geometry): at 2 ranks
stages 1 and 2 (48 and 24 rows) run on tiles of 24 and 12 rows and stages
3 and 4 whole, with a window cut by the tile edge in plain and shifted
blocks, every shifted block's wrap window, and the bottom pad to a
multiple of 7 on the last rank; at 4 ranks stage 1 runs on tiles of 12
rows (windows cut in plain and shifted blocks), stages 2-4 run whole, and
the neck's 1/32 level (f 8) is read from query rows starting at 12, not a
multiple of 8.  The tap radius is 5 (the config's) on both grids, 0 (the
exact gather path, the value maps all-gathered) at 2 ranks and 2 at 4
ranks.

The process body is ``swin_backbone_worker`` in
``tests/test_torch_spatial_workers.py``; both worlds spawn while this
process computes the whole-image backbone.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from nmrf_tpu_torch import build_model
from nmrf_tpu_torch.parallel import spawn

from . import test_torch_spatial_workers as W

WORLDS = {2: (5, 0), 4: (5, 2)}   # world -> tap radii
RADII = (5, 0, 2)
H, WIDTH = W.SWIN_BACKBONE_HW
DEPTHS, DIMS = (2, 2, 6, 2), (96, 192, 384, 768)
WS, SHIFT = 7, 3
V_DIM, HIDDEN = 64, 32   # the neck's value width and ConvFFN's hidden width
F32 = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(W.swin_backbone_cfg(), device="cpu")


@pytest.fixture(scope="module")
def runs(model, tmp_path_factory):
    """{world: [rank's result]} of both worlds, and {radius: whole-image
    features and gradients}, the worlds spawned while the whole-image
    backbone runs here."""
    tmp = tmp_path_factory.mktemp("spatial_swin_backbone")
    torch.save(model.state_dict(), tmp / "weights.pt")
    for world in WORLDS:
        (tmp / str(world)).mkdir()
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        jobs = [pool.submit(spawn, W.swin_backbone_worker, world, "gloo",
                            (str(tmp), str(tmp / str(world)), radii), 300)
                for world, radii in WORLDS.items()]
        whole = {radius: whole_image(model, radius) for radius in RADII}
        for job in jobs:
            job.result()
    return ({world: [torch.load(tmp / str(world) / f"swin_backbone_{r}.pt")
                     for r in range(world)] for world in WORLDS}, whole)


def whole_image(model, radius):
    (img1, img2), cots = W.swin_backbone_inputs()

    def features():
        f1, f2 = model.extract_feature(torch.from_numpy(img1),
                                       torch.from_numpy(img2))
        W.backbone_loss(f1, f2, cots).backward()
        return f1, f2

    f1, f2 = W.swin_backbone_run(model, features, radius)
    return ([[f.detach() for f in f1], [f.detach() for f in f2]],
            {k: p.grad for k, p in model.backbone.named_parameters()})


def cases():
    return [(world, radius) for world, radii in WORLDS.items()
            for radius in radii]


def stage_rows(world):
    """Each Swin stage's rows a tile and whether it runs on tiles (at least
    7 rows, even where a merge follows, every earlier stage on tiles)."""
    rows, out, tiled = H // world // 4, [], True
    for k in range(4):
        tiled = tiled and rows >= WS and (k == 3 or rows % 2 == 0)
        out.append((rows, tiled))
        rows //= 2
    return out


def window_halo(world, rows, shift):
    """The rows each tile of a stage takes above and below for the whole
    windows over its rows (windows from ``shift`` + 7 k of the map padded
    to a multiple of 7, the pad on the last tile), and their maximum."""
    Hp = -(-rows * world // WS) * WS
    need = []
    for i in range(world):
        top, bottom = i * rows, Hp if i == world - 1 else (i + 1) * rows
        need.append(((top - shift) % WS, (shift - bottom) % WS))
    return need, max(max(n) for n in need)


def expected_counts(world, radius):
    """The collectives of one forward and backward of the tiled backbone,
    by site, from the shapes: {kind: {"count", "bytes", "sites"}} as
    ``CollectiveCounts.summary`` gives them (an all-gather's bytes its
    result's, an all-reduce's its buffer's)."""
    B = 2 * W.SWIN_BACKBONE_PAIRS  # both views
    h = H // world
    calls = {}

    def add(kind, site, n, nbytes):
        row = calls.setdefault((kind, site), [0, 0])
        row[0] += n
        row[1] += n * nbytes

    # the stem: its first convolution's halo (the image needs no gradient),
    # the other two and the max pool's forward and backward, 1 row each side
    add("all_gather", "stem_halo", 1, world * B * 2 * WIDTH * 3 * F32)
    add("all_gather", "stem_halo", 6, world * B * 2 * (WIDTH // 2) * 64 * F32)
    add("all_reduce", "stem_moments", 12, B * 64 * F32)
    for k, (rows, tiled) in enumerate(stage_rows(world)):
        cols = WIDTH // 4 >> k
        if not tiled:  # the first stage run whole gathers its input
            if k and stage_rows(world)[k - 1][1]:
                nbytes = world * B * rows * cols * DIMS[k] * F32
                add("all_gather", "swin_stage", 1, nbytes)
                add("all_reduce", "swin_stage", 1, nbytes)
            continue
        Wp = -(-cols // WS) * WS
        for j in range(DEPTHS[k]):
            halo = window_halo(world, rows, SHIFT if j % 2 else 0)[1]
            if halo:
                add("all_gather", "swin_halo", 2,
                    world * B * 2 * halo * Wp * DIMS[k] * F32)
    hq, wq = h // 4, WIDTH // 4
    for level, (rows, tiled) in enumerate(stage_rows(world)):
        if not tiled:
            continue
        n, cols = hq >> level, wq >> level
        if radius and radius + 1 <= n:
            add("all_gather", "msda_halo", 2,
                world * B * 2 * (radius + 1) * cols * V_DIM * F32)
        else:
            nbytes = world * B * n * cols * V_DIM * F32
            add("all_gather", "msda_value", 1, nbytes)
            add("all_reduce", "msda_value", 1, nbytes)
    add("all_gather", "ffn_halo", 8, world * B * 2 * wq * HIDDEN * F32)
    out = {}
    for (kind, site), (count, nbytes) in sorted(calls.items()):
        row = out.setdefault(kind, {"count": 0, "bytes": 0, "sites": {}})
        row["count"] += count
        row["bytes"] += nbytes
        row["sites"][site] = {"count": count, "bytes": nbytes}
    return out


def test_the_cases_are_held():
    two, four = stage_rows(2), stage_rows(4)
    assert [t for _, t in two] == [True, True, False, False]
    assert [t for _, t in four] == [True, False, False, False]
    # a window cut by a tile edge in plain and shifted blocks
    for world, k in ((2, 1), (4, 0)):
        rows = stage_rows(world)[k][0]
        for shift in (0, SHIFT):
            need, halo = window_halo(world, rows, shift)
            assert halo > 0 and any(a and b for a, b in zip(
                [n[1] for n in need[:-1]], [n[0] for n in need[1:]])), (world, k)
    # the wrap window: the first tile's shifted windows reach above it, the
    # last tile's below it
    need, _ = window_halo(2, stage_rows(2)[0][0], SHIFT)
    assert need[0][0] > 0 and need[-1][1] > 0
    # the bottom pad on the last rank: stage 1 at 2 ranks, 48 rows
    assert (stage_rows(2)[0][0] * 2) % WS
    # an unaligned tap offset: the 1/32 level (f 8) at 4 ranks, query rows
    # from 12 on rank 1
    assert (H // 4 // 4) % 8


@pytest.mark.parametrize("world,radius", cases())
def test_features_are_the_whole_image_tiles(runs, world, radius):
    got, whole = runs
    want = whole[radius][0]
    for rank, result in enumerate(got[world]):
        assert result[radius]["tiled"] == tuple(t for _, t in stage_rows(world))
        for view_got, view_want in zip(result[radius]["features"], want):
            for f, g in zip(view_got, view_want):
                n = g.shape[1] // world
                assert f.shape[1] == n
                torch.testing.assert_close(f, g[:, rank * n:(rank + 1) * n],
                                           atol=2e-5, rtol=0)


@pytest.mark.parametrize("world,radius", cases())
def test_summed_gradients_are_the_whole_image_gradients(runs, world, radius):
    got, whole = runs
    want = whole[radius][1]
    scale = max(g.abs().max().item() for g in want.values() if g is not None)
    ranks = [r[radius]["grads"] for r in got[world]]
    for grads in ranks:
        assert grads.keys() == want.keys()
        for key, g in want.items():
            assert (g is None) == (grads[key] is None), key
            if g is not None:
                err = (grads[key] - g).abs().max().item() / scale
                assert err < 1e-2, (key, err)
    for key, g in ranks[0].items():  # the same sum everywhere
        if g is not None:
            assert all(torch.equal(r[key], g) for r in ranks[1:]), key


@pytest.mark.parametrize("world,radius", cases())
def test_collectives_by_site(runs, world, radius):
    got, _ = runs
    want = expected_counts(world, radius)
    for result in got[world]:
        assert result[radius]["counts"] == want
