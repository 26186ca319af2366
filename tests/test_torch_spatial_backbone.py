"""The halo-exchanged resnet backbone against the unsharded one (CPU,
float32, gloo, two processes).

Under a spatial mesh each rank feeds only its H tile of the images into the
resnet backbone (``nmrf_tpu_torch/models/backbone.py``): each convolution
takes the rows its outputs read beyond the tile from the neighbour tiles,
with zero rows at the global edges, and every instance norm takes the
group's global moments.  On a 1 x 2 grid, batch 2, width 64 and tiles of
12 and 24 rows at 1/8 resolution (96 and 192 image rows), the test model's
weights on both sides:

* each rank's features of both levels and both views equal the unsharded
  backbone's rows of its tile within 2e-5 (fifteen instance norms in
  float32, one-pass moments unsharded and two-pass sharded: the sharded
  features are up to 1.5e-5 from the unsharded ones, and the unsharded
  float32 features themselves up to 1.7e-5 from their float64
  evaluation, at values up to 8);
* the world-summed gradients of every backbone parameter for
  ``sum(feature * cotangent) / size`` equal the unsharded backbone's at
  the backbone tolerance of ``tests/test_torch_spatial.py`` (|d| / max |g|
  over the backbone < 1e-2): a ReLU input within float32 rounding of 0
  routes the gradient differently, and through the instance norms' global
  moments that moves every earlier leaf (the unsharded float32 gradients
  are up to 2% of a leaf's largest value from their float64 evaluation);
  the halo exchange's backward is what puts the edge rows' gradients
  back, and without it the stem's gradient is off by far more;
* the 7x7 stem's convolution receives the tile plus its 3 halo rows above
  and 2 below, not the whole image, so a relapse to whole images fails;
* images whose tile height is not a multiple of 8 raise.

The process body is ``backbone_worker`` in
``tests/test_torch_spatial_workers.py``.
"""

import pytest
import torch

from nmrf_tpu_torch import build_model
from nmrf_tpu_torch.parallel import spawn

from . import test_torch_spatial_workers as W

WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(W.small_cfg(), device="cpu").train()


@pytest.fixture(scope="module")
def ranks(model, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_backbone")
    torch.save(model.state_dict(), tmp / "weights.pt")
    spawn(W.backbone_worker, WORLD, "gloo", args=(str(tmp), str(tmp)),
          timeout_s=180)
    return [torch.load(tmp / f"backbone_{r}.pt") for r in range(WORLD)]


def unsharded(model, tile):
    """The whole images' features and the backbone's gradients."""
    (img1, img2), cots = W.backbone_inputs(tile, WORLD)
    model.zero_grad(set_to_none=True)
    f1, f2 = model.extract_feature(torch.from_numpy(img1), torch.from_numpy(img2))
    W.backbone_loss(f1, f2, cots).backward()
    return ([[f.detach() for f in f1], [f.detach() for f in f2]],
            {k: p.grad for k, p in model.backbone.named_parameters()})


@pytest.mark.parametrize("tile", W.BACKBONE_TILES)
def test_features_are_the_unsharded_tiles(model, ranks, tile):
    want, _ = unsharded(model, tile)
    for rank, got in enumerate(ranks):
        for view_got, view_want in zip(got[tile]["features"], want):
            for level, (f, g) in enumerate(zip(view_got, view_want)):
                n = g.shape[1] // WORLD
                assert f.shape[1] == n == tile * (1 if level == 0 else 2)
                torch.testing.assert_close(f, g[:, rank * n:(rank + 1) * n],
                                           atol=2e-5, rtol=0)


@pytest.mark.parametrize("tile", W.BACKBONE_TILES)
def test_summed_gradients_are_the_unsharded_gradients(model, ranks, tile):
    _, want = unsharded(model, tile)
    scale = max(g.abs().max().item() for g in want.values())
    for got in ranks:
        assert got[tile]["grads"].keys() == want.keys()
        for key, g in want.items():
            err = (got[tile]["grads"][key] - g).abs().max().item() / scale
            assert err < 1e-2, (key, err)
    for key, g in ranks[0][tile]["grads"].items():  # the same sum everywhere
        assert all(torch.equal(r[tile]["grads"][key], g) for r in ranks[1:]), key


@pytest.mark.parametrize("tile", W.BACKBONE_TILES)
def test_stem_reads_the_tile_and_its_halo_rows(ranks, tile):
    # one call for both views (extract_feature stacks them); 3 rows above
    # and 2 below the tile of 8 * tile image rows, the whole image 16 * tile
    for got in ranks:
        assert got[tile]["stem_rows"] == [8 * tile + 3 + 2]


def test_tile_height_not_a_multiple_of_8_raises(ranks):
    for got in ranks:
        assert len(got["raised"]) == 2
        assert all(msg is not None and "multiple of 8" in msg
                   for msg in got["raised"])
