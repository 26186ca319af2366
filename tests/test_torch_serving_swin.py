"""The swin variant's serving artifact (CPU): exported, saved, loaded and
run, equal (atol 0) to the live model.  Apart from
``tests/test_torch_serving.py`` because the Swin-T graph takes about a
minute to export, save and load here."""

from pathlib import Path

import numpy as np
import pytest
import torch

from nmrf_tpu_torch import build_model, get_cfg
from nmrf_tpu_torch.tools.export_serving import export_artifact
from nmrf_tpu_torch.utils.export import load_exported, load_meta


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_swin_export_roundtrip(tmp_path):
    """The swin variant (2 layers per NMP stage) exported by
    ``tools/export_serving.py``'s code for 60 x 120 inputs, padded to
    ``DIVIS_BY`` 32: the loaded artifact equals the live model (atol 0)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent.parent / "configs"
                            / "sceneflow_swint.yaml"))
    cfg.merge_from_list(["DPN.MAX_DISP", "64", "SOLVER.MAX_DISP", "48",
                         "NMP.NUM_PROP_LAYERS", "2", "NMP.NUM_INFER_LAYERS", "2",
                         "NMP.NUM_REFINE_LAYERS", "2"])
    cfg.freeze()
    model = build_model(cfg, device="cpu")
    path = str(tmp_path / "swin.pt2")
    _, shape, size, _ = export_artifact(model, cfg, 60, 120, path)
    assert shape == (1, 64, 128, 3) and size > 0
    meta = load_meta(path)
    assert meta["divis_by"] == 32 and meta["model"] == "swin"
    assert meta["input_shape"] == list(shape) and meta["frozen_params"]
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        got = load_exported(path).module()(a, b)
        want = model(a, b)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
