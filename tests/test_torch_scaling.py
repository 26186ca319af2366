"""The port's weak-scaling sweep (``nmrf_tpu_torch/bench_scaling.py``) and
its communication contract (CPU, gloo).

* ``check_comm_contract`` on synthetic collective counts: it accepts the
  port's exact counts and rejects each breach, as
  ``tests/test_scaling_contract.py`` pins the JAX script's contract;
* the sweep for real, ``main(["--device", "cpu", ...])``: the (1, 1),
  (2, 1) and (1, 2) points over gloo, at one layer a stage and a 96 x 64
  crop (so that each tile of the 1 x 2 point holds whole windows).  The
  data-parallel point's counted gradient all-reduce is the parameters'
  float32 bytes (counted here from the model), the spatial point gathers
  halos and stripes and still reduces the gradients in full, the
  efficiency is null (ranks on the CPU) with the raw ratio under the JAX
  script's debug key, and the record has the JAX script's row keys.
"""

import json

import pytest
import torch

from nmrf_tpu_torch import bench_scaling as S
from nmrf_tpu_torch import build_model

PB = 12_041_960     # the test config's parameters, f32 bytes
OUT = 556_032       # its global outputs at batch 2
# the JAX script's row keys (bench_scaling.py:273-282)
JAX_ROW_KEYS = {"mesh", "variant", "devices", "ms_per_step", "global_batch",
                "weak_scaling_efficiency", "collectives_per_step",
                "comm_contract"}
OPTS = ["NMP.NUM_PROP_LAYERS", "1", "NMP.NUM_INFER_LAYERS", "1",
        "NMP.NUM_REFINE_LAYERS", "1", "SOLVER.LOSS_WEIGHTS", "[1.0, 2.0]",
        "DATASETS.CROP_SIZE", "(96, 64)"]


def comm(**sites):
    """{kind: {"count", "bytes", "sites"}} from site=(kind, count, bytes)."""
    out = {}
    for name, (kind, count, nbytes) in sites.items():
        row = out.setdefault(kind, {"count": 0, "bytes": 0, "sites": {}})
        row["count"] += count
        row["bytes"] += nbytes
        row["sites"][name] = {"count": count, "bytes": nbytes}
    return out


GRADS = ("all_reduce", 1, PB)
OUTPUTS = ("all_gather", 8, OUT)


class TestSingleRank:
    def test_silent(self):
        assert S.check_comm_contract({}, PB, 1, 1) == {"param_bytes": PB}

    def test_any_collective_rejected(self):
        with pytest.raises(AssertionError, match="1 x 1"):
            S.check_comm_contract(comm(gradients=GRADS), PB, 1, 1)


class TestDataParallel:
    def test_exact_counts_pass(self):
        res = S.check_comm_contract(comm(gradients=GRADS, outputs=OUTPUTS),
                                    PB, 2, 1, OUT)
        assert res["gradient_allreduce_bytes"] == PB
        S.check_comm_contract(comm(gradients=GRADS, outputs=OUTPUTS,
                                   tap_metric=("all_reduce", 1, 16)),
                              PB, 4, 1, OUT)

    @pytest.mark.parametrize("grads", [("all_reduce", 1, PB // 2),
                                       ("all_reduce", 1, 2 * PB),
                                       ("all_reduce", 2, PB)])
    def test_gradient_reduction_not_one_of_the_parameter_bytes(self, grads):
        with pytest.raises(AssertionError, match="gradient all-reduce"):
            S.check_comm_contract(comm(gradients=grads, outputs=OUTPUTS),
                                  PB, 2, 1, OUT)

    def test_missing_gradient_reduction_rejected(self):
        with pytest.raises(AssertionError, match="gradient all-reduce"):
            S.check_comm_contract(comm(outputs=OUTPUTS), PB, 2, 1, OUT)

    def test_spatial_collective_rejected(self):
        with pytest.raises(AssertionError, match="gathers"):
            S.check_comm_contract(comm(gradients=GRADS, outputs=OUTPUTS,
                                       halo=("all_gather", 2, 4096)),
                                  PB, 2, 1, OUT)
        with pytest.raises(AssertionError, match="unexpected all-reduces"):
            S.check_comm_contract(comm(gradients=GRADS, outputs=OUTPUTS,
                                       moments=("all_reduce", 2, 64)),
                                  PB, 2, 1, OUT)

    def test_output_gather_other_than_the_outputs_rejected(self):
        with pytest.raises(AssertionError, match="output all-gather"):
            S.check_comm_contract(comm(gradients=GRADS,
                                       outputs=("all_gather", 8, 2 * OUT)),
                                  PB, 2, 1, OUT)

    def test_metric_scalars_bounded(self):
        with pytest.raises(AssertionError, match="scalars"):
            S.check_comm_contract(comm(gradients=GRADS, outputs=OUTPUTS,
                                       tap_metric=("all_reduce", 1, 1 << 20)),
                                  PB, 2, 1, OUT)


class TestSpatial:
    SP = {"halo": ("all_gather", 43, 2_312_192),
          "stripe": ("all_gather", 2, 196_608),
          "moments": ("all_reduce", 96, 64_512)}

    def test_exact_counts_pass(self):
        res = S.check_comm_contract(
            comm(gradients=GRADS, outputs=("all_gather", 8, OUT // 2),
                 **self.SP), PB, 1, 2, OUT // 2)
        assert res["halo_roll_stripe_bytes"] == 2_312_192 + 196_608

    def test_halo_required(self):
        sp = {k: v for k, v in self.SP.items() if k != "halo"}
        with pytest.raises(AssertionError, match="halo"):
            S.check_comm_contract(comm(gradients=GRADS, outputs=OUTPUTS, **sp),
                                  PB, 2, 2, OUT)

    def test_gradients_still_reduced_in_full(self):
        with pytest.raises(AssertionError, match="gradient all-reduce"):
            S.check_comm_contract(
                comm(gradients=("all_reduce", 1, PB // 4), outputs=OUTPUTS,
                     **self.SP), PB, 2, 2, OUT)

    def test_unknown_gather_rejected(self):
        with pytest.raises(AssertionError, match="unexpected all-gathers"):
            S.check_comm_contract(
                comm(gradients=GRADS, outputs=OUTPUTS,
                     features=("all_gather", 1, 1 << 20), **self.SP),
                PB, 2, 2, OUT)


def test_mesh_points_follow_the_jax_sweep():
    assert S.mesh_points(2) == [(1, 1, False), (2, 1, False), (1, 2, False)]
    assert S.mesh_points(8) == [(1, 1, False), (2, 1, False), (4, 1, False),
                                (8, 1, False), (1, 2, False), (4, 2, False),
                                (2, 2, True)]


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = tmp_path_factory.mktemp("scaling") / "SCALING.json"
        rec = S.main(["--device", "cpu", "--iters", "1", "--out", str(out),
                      *OPTS])
        with open(out) as f:
            assert json.load(f) == json.loads(json.dumps(rec))
        return rec
    finally:
        torch.set_num_threads(n)


def test_param_bytes_are_the_models():
    model = build_model(S.sweep_cfg(OPTS), device="cpu")
    assert sum(p.numel() * 4 for p in model.parameters()) == PB


def test_record_keys(record):
    assert record["platform"] == "cpu" and record["crop"] == [96, 64]
    assert record["per_device_batch"] == 1 and "note" in record
    assert [r["mesh"] for r in record["sweep"]] == [
        "data=1x spatial=1", "data=2x spatial=1", "data=1x spatial=2"]
    for row in record["sweep"]:
        assert JAX_ROW_KEYS <= set(row), row.keys()
        assert row["weak_scaling_efficiency"] is None
        assert row["wallclock_ratio_cpu_debug"] > 0
        assert row["backend"] == "gloo" and row["ms_per_step"] > 0


def test_single_rank_is_silent(record):
    assert record["sweep"][0]["collectives_per_step"] == {}
    assert record["sweep"][0]["wallclock_ratio_cpu_debug"] == 1.0


def test_data_parallel_reduces_the_parameter_bytes_once(record):
    c = record["sweep"][1]["collectives_per_step"]
    assert c["all_reduce"]["sites"] == {"gradients": {"count": 1, "bytes": PB}}
    assert c["all_reduce"]["bytes"] == PB
    assert set(c["all_gather"]["sites"]) == {"outputs"}
    assert c["all_gather"]["bytes"] == OUT
    assert record["sweep"][1]["global_batch"] == 2


def test_spatial_point_gathers_halos_and_reduces_gradients(record):
    c = record["sweep"][2]["collectives_per_step"]
    sites = c["all_gather"]["sites"]
    assert sites["halo"]["bytes"] > 0 and sites["stripe"]["bytes"] > 0
    assert c["all_reduce"]["sites"]["gradients"] == {"count": 1, "bytes": PB}
    assert record["sweep"][2]["comm_contract"]["halo_roll_stripe_bytes"] > 0
