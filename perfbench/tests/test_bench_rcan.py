"""The rcan.roi cell and dsen2.tile.default on the CPU: RCAN's counts
against counts made by hand, the configuration's cut, tiny runs of the
harness (sound, control, altered answer), the metric readers on a made-up
trace, and the reference against the program's RCAN."""

import copy
import types

import numpy as np
import pytest
import torch

from perfbench import controls, counts, counts_rcan, frozen, harness
from perfbench.generators.tile import nested
from perfbench.reference import rcan as refrcan
from perfbench.reference.net import no_tf32
from perfbench.tests import tiny
from perfbench.trace import TraceData

RCAN = harness.load_cell("rcan.roi").config["nets"]["2x"]
TINY = dict(RCAN, n_resgroups=2, n_resblocks=2, n_feats=16, reduction=4)


def test_flops_at_published_widths():
    # 411 body convs of 64 -> 64, the head 10 -> 64 and the tail 64 -> 6.
    assert counts_rcan.body_convs(RCAN) == 411 and counts_rcan.rcabs(RCAN) == 200
    assert counts_rcan.conv_flops_per_px(RCAN) == 18 * (640 + 411 * 4096 + 384) == 30320640
    # 3660^2: 1830 px at 20 m, patch 64, stride 56: 32 + 1 per axis.
    assert counts.tile_patches(3660, 3660, RCAN) == 33 * 33
    assert counts_rcan.tile_model_flops(3660, 3660, RCAN) == 1089 * 128 * 128 * 30320640


def test_body_and_gate_work():
    flops, nbytes = counts_rcan.body_conv_work(3660, 3660, RCAN, "high")
    assert flops == 1089 * 128 * 128 * 18 * 64 * 64 * 411 * 3
    weights = 411 * (9 * 64 * 64 + 64) * 4
    assert nbytes == 1089 * 2 * 128 * 128 * 64 * 4 + 18 * weights  # ceil(1089 / 64) calls
    assert counts_rcan.body_conv_work(3660, 3660, RCAN, "default")[0] == flops // 3
    assert counts_rcan.gate_bytes(3660, 3660, RCAN) == 1089 * 128 * 128 * 12 * 64 * 200


def test_config_holds_its_cut_and_widths():
    cell = harness.load_cell("rcan.roi")
    assert cell.config["roi_px"] == cell.traffic["side"]
    assert cell.config["reduced"] == ["roi_px"]
    net = cell.config["nets"]["2x"]
    assert (net["n_resgroups"], net["n_resblocks"], net["n_feats"], net["reduction"]) == (
        10, 20, 64, 16)
    assert cell.traffic["batch"] == 64 and cell.traffic["precision"] == "high"
    default = harness.load_cell("dsen2.tile.default")
    tile = harness.load_cell("dsen2.tile")
    assert dict(default.traffic, precision="high", notes="") == dict(tile.traffic, notes="")
    assert default.traffic["precision"] == "default"


def rcan_cell(monkeypatch, tmp_path) -> harness.Cell:
    """rcan.roi cut to a size the CPU runs in seconds."""
    c = harness.load_cell("rcan.roi")
    cfg = copy.deepcopy(c.config)
    cfg["nets"]["2x"] = dict(TINY)
    t = dict(c.traffic, side=240, base=120, warmup_rows={"2x": 240}, sample_block=4, batch=4)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return harness.Cell(c.name, c.chips, cfg, t, c.limits, c.end_to_end, c.per_layer)


def test_sound_run_is_correct(monkeypatch, tmp_path):
    r = tiny.run(rcan_cell(monkeypatch, tmp_path))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"tile_mpx_per_s", "setup_s"}


def test_control_is_not_correct(monkeypatch, tmp_path):
    """The program's own one-pass path ("default") in place of "high"."""
    r = tiny.run(rcan_cell(monkeypatch, tmp_path), precision="default")
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(monkeypatch, tmp_path):
    from perfbench.tests.test_bench_run import altered_interiors

    c = rcan_cell(monkeypatch, tmp_path)
    altered_interiors(monkeypatch)
    assert not tiny.run(c)["correct"]


def test_one_gate_fewer_is_not_correct(monkeypatch, tmp_path):
    """The last RCAB of every group left out of the body."""
    from dsen2_tpu_torch.models import rcan

    c = rcan_cell(monkeypatch, tmp_path)
    orig = rcan._body

    def short(x, p, precision):
        cut = dict(p, blocks={k: v[:, :-1] for k, v in p["blocks"].items()},
                   ca={k: v[:, :-1] for k, v in p["ca"].items()})
        return orig(x, cut, precision)

    monkeypatch.setattr(rcan, "_body", short)
    assert not tiny.run(c)["correct"]


def test_default_cell_runs_correct_and_its_traffic_is_default(monkeypatch, tmp_path):
    c = tiny.cell("dsen2.tile.default", monkeypatch, tmp_path)
    assert c.traffic["precision"] == "default"
    r = tiny.run(c)
    assert r["correct"], r["checks"]


def test_default_cell_fp8_weights_control_is_not_correct(monkeypatch, tmp_path):
    """The control the cell's limit is set against: the program given its
    weights in float8 e4m3, the precision below "default"'s bf16 operands."""
    c = tiny.cell("dsen2.tile.default", monkeypatch, tmp_path)
    with controls.fp8_weights():
        r = tiny.run(c)
    assert not r["correct"], r["checks"]


def test_fp8_e4m3_rounds_to_three_bits_under_a_scale():
    v = torch.tensor([0.0, 1e-3, -0.05, 0.1, 0.07])
    q = controls.fp8_e4m3(v)
    assert q.abs().max() == v.abs().max() and q[0] == 0
    # e4m3 keeps 3 bits of mantissa: at most 2^-4 of each value off.
    assert ((q - v).abs() <= 2 ** -4 * v.abs() + 1e-12).all() and not torch.equal(q, v)
    assert torch.equal(controls.fp8_e4m3(torch.zeros(3)), torch.zeros(3))


def _ctx(kernels, traced_counts, gates):
    trace = TraceData(device=[(0.0, 1.0, "k")], spans=[], host_ops=[], kernel_s=kernels,
                      window=(0.0, 2.0))
    recs = [{"kind": "tile", "gates": g} for g in gates]
    return types.SimpleNamespace(trace=trace, traced_counts=traced_counts, traced_records=recs)


def test_metric_readers_on_a_made_up_trace():
    conv = harness.load_metric("rcan_conv_roofline.rcan")
    gate = harness.load_metric("gate_roofline.rcan")
    per = harness.load_metric("gate_us.rcan")
    names = {"void (anonymous namespace)::conv_kernel<float, 64, 3, 0>(ConvArgs)": 0.5,
             "void (anonymous namespace)::conv_kernel<float, 64, 3, 2>(ConvArgs)": 1.5,
             "void (anonymous namespace)::conv_kernel<float, 128, 3, 0>(ConvArgs)": 9.0,
             "void (anonymous namespace)::ca_gate_kernel<3>(GateArgs)": 0.8}
    c = {"rcan_conv_flops": 989e12, "rcan_conv_bytes": 1.0, "gate_bytes": 3.35e12 * 0.4}
    ctx = _ctx(names, c, [200, 200])
    assert conv(ctx) == pytest.approx(50.0)
    assert gate(ctx) == pytest.approx(50.0)
    assert per(ctx) == pytest.approx(1e6 * 0.8 / 400)
    # No kernels of theirs in the trace (a program without RCAN): no reading.
    bare = _ctx({"void (anonymous namespace)::conv_kernel<float, 128, 3, 0>(ConvArgs)": 1.0},
                c, [0])
    assert conv(bare) is None and gate(bare) is None and per(bare) is None


def test_reference_matches_the_programs_rcan():
    from dsen2_tpu_torch.models import rcan
    from dsen2_tpu_torch.weights import params_to_torch

    w = refrcan.seeded(torch.Generator().manual_seed(3), TINY, "cpu")
    g = torch.Generator().manual_seed(1)
    xs = [torch.rand((2, 24, 24, c), generator=g) * 3 for c in TINY["in_channels"]]
    cfg = rcan.RCANConfig(groups=2, blocks=2, features=16, reduction=4)
    got = rcan.apply(params_to_torch(nested(w), "cpu"), xs, cfg, precision="highest")
    with no_tf32():
        want = refrcan.forward(w, [x.permute(0, 3, 1, 2) for x in xs])
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_mosaic_blocks_match_the_api():
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer import api
    from dsen2_tpu_torch.models import rcan

    rasters = frozen.synthetic_scene(3, 240)[:2]
    w = refrcan.seeded(torch.Generator().manual_seed(9), TINY, "cpu")
    icfg = InferConfig(patch_size=128, border=8, batch_size=4, precision="highest")
    model = rcan.RCANConfig(groups=2, blocks=2, features=16, reduction=4)
    out = api.dsen2_20(*rasters, params=nested(w), infer_cfg=icfg, device="cpu", model=model)
    ref = refrcan.RCANTileReference(rasters, TINY, w, "cpu")
    ids = [(i, j) for i in range(ref.rows) for j in range(ref.cols)]
    covered = np.zeros(out.shape[:2], bool)
    # Both float32, sums in other orders: 1e-5 of the largest DN.
    atol = 1e-5 * float(np.abs(out).max())
    for (i, j), block in zip(ids, ref.blocks(ids)):
        y0, y1, x0, x1 = ref.owned(i, j)
        np.testing.assert_allclose(out[y0:y1, x0:x1], block, rtol=0, atol=atol)
        covered[y0:y1, x0:x1] = True
    assert covered.all()
