"""The hat.roi cell on the CPU: HAT's counts against
counts made by hand, the configuration's cut, tiny runs of the harness
(sound, control, altered answer, a planted fault), the metric readers on a
made-up trace, and the reference against the program's HAT."""

import copy
import types

import numpy as np
import pytest
import torch

from perfbench import counts, counts_hat, faults_hat, frozen, harness
from perfbench.generators.tile import nested
from perfbench.reference import hat as refhat
from perfbench.reference.net import no_tf32
from perfbench.tests import tiny
from perfbench.trace import TraceData

HAT = harness.load_cell("hat.roi").config["nets"]["2x"]
# 12 features, 2 groups of 2 blocks, window 8 (M_o 12) in patches of 32
# with a border of 2: the shifted windows' mask and OCAB's padding reach
# pixels that the mosaic keeps.
TINY = dict(HAT, embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=8,
            squeeze_factor=4, patch_size=32, border=2)


def test_flops_at_published_widths():
    # Per patch pixel: 36 HABs (linears 518,400, CAB convs 388,800,
    # attention 4 * 256 * 180), 6 OCABs (linears, attention 4 * 576 * 180),
    # 6 group convs, the head, the conv after the body and the tail.
    hab = 518_400 + 388_800 + 184_320
    ocab = 518_400 + 414_720
    convs = 18 * (10 * 180 + 7 * 180 * 180 + 180 * 6)
    assert counts_hat.flops_per_px(HAT) == 36 * hab + 6 * ocab + convs == 49_027_680
    # 1830^2: 915 px at 20 m, patch 64, stride 56: 16 + 1 per axis.
    assert counts.tile_patches(1830, 1830, HAT) == 289
    assert counts_hat.tile_model_flops(1830, 1830, HAT) == 289 * 128 * 128 * 49_027_680


def test_attention_work_by_hand():
    px = 289 * 128 * 128
    flops, nbytes = counts_hat.attention_work(1830, 1830, HAT, "high")
    assert flops == px * (36 * 4 * 256 * 180 + 6 * 4 * 576 * 180) * 3
    assert nbytes == px * 42 * 4 * 180 * 4
    f1, b1 = counts_hat.attention_work(1830, 1830, HAT, "default")
    assert (f1, b1) == (flops // 3, nbytes // 2)
    assert counts_hat.launches(1830, 1830, HAT, 64) == 5 * 42


def test_config_holds_its_cut_and_widths():
    cell = harness.load_cell("hat.roi")
    assert cell.config["roi_px"] == cell.traffic["side"] == 1830
    assert cell.config["reduced"] == ["roi_px"]
    net = cell.config["nets"]["2x"]
    assert (net["embed_dim"], net["depths"], net["num_heads"], net["window_size"],
            net["overlap_ratio"], net["mlp_ratio"], net["compress_ratio"],
            net["squeeze_factor"], net["conv_scale"]) == (
        180, [6] * 6, [6] * 6, 16, 0.5, 2, 3, 30, 0.01)
    assert cell.traffic["batch"] == 64 and cell.traffic["precision"] == "high"
    assert cell.traffic["side"] % 6 == 0


def hat_cell(monkeypatch, tmp_path) -> harness.Cell:
    """hat.roi cut to a size the CPU runs in seconds."""
    c = harness.load_cell("hat.roi")
    cfg = copy.deepcopy(c.config)
    cfg["nets"]["2x"] = dict(TINY)
    t = dict(c.traffic, side=120, base=60, warmup_rows={"2x": 120}, sample_block=4, batch=4)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return harness.Cell(c.name, c.chips, cfg, t, c.limits, c.end_to_end, c.per_layer)


def test_sound_run_is_correct(monkeypatch, tmp_path):
    r = tiny.run(hat_cell(monkeypatch, tmp_path))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"tile_mpx_per_s", "setup_s"}


def test_control_is_not_correct(monkeypatch, tmp_path):
    """The program's own one-pass path ("default") in place of "high"."""
    r = tiny.run(hat_cell(monkeypatch, tmp_path), precision="default")
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(monkeypatch, tmp_path):
    from perfbench.tests.test_bench_run import altered_interiors

    c = hat_cell(monkeypatch, tmp_path)
    altered_interiors(monkeypatch)
    assert not tiny.run(c)["correct"]


@pytest.mark.parametrize("fault", faults_hat.FAULTS)
def test_planted_fault_is_not_correct(fault, monkeypatch, tmp_path):
    """dropped_mask: the shifted windows' mask left out of the program's
    attention; masked_padding: OCAB's keys outside the patch left out of
    the softmax instead of taking part in it as zero vectors (on the CPU
    the program runs the plain version, where faults_hat plants both)."""
    c = hat_cell(monkeypatch, tmp_path)
    with faults_hat.planted(fault):
        r = tiny.run(c)
    assert not r["correct"], r["checks"]


def _ctx(kernels, traced_counts, attn):
    trace = TraceData(device=[(0.0, 1.0, "k")], spans=[], host_ops=[], kernel_s=kernels,
                      window=(0.0, 2.0))
    recs = [{"kind": "tile", "attn": a} for a in attn]
    return types.SimpleNamespace(trace=trace, traced_counts=traced_counts, traced_records=recs)


def test_metric_readers_on_a_made_up_trace():
    roof = harness.load_metric("wattn_roofline.hat")
    per = harness.load_metric("wattn_us.hat")
    names = {"void (anonymous namespace)::window_attention_kernel<3, 16>(AttnArgs)": 0.6,
             "void (anonymous namespace)::window_attention_kernel<3, 24>(AttnArgs)": 0.4,
             "void (anonymous namespace)::conv_kernel<float, 128, 3, 0>(ConvArgs)": 9.0}
    c = {"wattn_flops": 989e12 * 0.5, "wattn_bytes": 1.0}
    ctx = _ctx(names, c, [210, 210])
    assert roof(ctx) == pytest.approx(50.0)
    assert per(ctx) == pytest.approx(1e6 * 1.0 / 420)
    # No kernel of its name in the trace (a program without HAT): no reading.
    bare = _ctx({"void (anonymous namespace)::conv_kernel<float, 128, 3, 0>(ConvArgs)": 1.0},
                c, [0])
    assert roof(bare) is None and per(bare) is None


def _program_model():
    from dsen2_tpu_torch.models import hat

    return hat.HATConfig(embed_dim=12, groups=2, blocks=2, heads=2, window=8, squeeze_factor=4)


def test_reference_matches_the_programs_hat():
    from dsen2_tpu_torch.models import hat
    from dsen2_tpu_torch.weights import params_to_torch

    w = refhat.seeded(torch.Generator().manual_seed(3), TINY, "cpu")
    g = torch.Generator().manual_seed(1)
    xs = [torch.rand((2, 32, 32, c), generator=g) * 3 for c in TINY["in_channels"]]
    cfg = _program_model()
    assert hat.param_count(cfg) == sum(v.numel() for v in w.values())
    got = hat.apply(params_to_torch(nested(w), "cpu"), xs, cfg, precision="highest")
    with no_tf32():
        want = refhat.forward(w, [x.permute(0, 3, 1, 2) for x in xs], TINY)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_mosaic_blocks_match_the_api():
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer import api

    rasters = frozen.synthetic_scene(3, 120)[:2]
    w = refhat.seeded(torch.Generator().manual_seed(9), TINY, "cpu")
    icfg = InferConfig(patch_size=32, border=2, batch_size=4, precision="highest")
    out = api.dsen2_20(*rasters, params=nested(w), infer_cfg=icfg, device="cpu",
                       model=_program_model())
    ref = refhat.HATTileReference(rasters, TINY, w, "cpu")
    ids = [(i, j) for i in range(ref.rows) for j in range(ref.cols)]
    covered = np.zeros(out.shape[:2], bool)
    # Both float32, sums in other orders: 1e-5 of the largest DN.
    atol = 1e-5 * float(np.abs(out).max())
    for (i, j), block in zip(ids, ref.blocks(ids)):
        y0, y1, x0, x1 = ref.owned(i, j)
        np.testing.assert_allclose(out[y0:y1, x0:x1], block, rtol=0, atol=atol)
        covered[y0:y1, x0:x1] = True
    assert covered.all()

