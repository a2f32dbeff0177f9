"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports neither JAX nor dsen2_tpu, so it also runs on a machine
without them; there, skip the JAX test harness in tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import conv as conv_mod
from dsen2_tpu_torch.ops import resblock, resblock_chain
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import params_to_torch

pytestmark = pytest.mark.cuda

# Fraction of max|plain| (see chip_smoke.py, KERNEL_TOL, for the reasons).
TOL = {(torch.float32, 3): 1e-4, (torch.float32, 1): 1e-2, (torch.bfloat16, 1): 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _block_args(dev, shape, k, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    ws = (9 * c) ** -0.5
    w1 = torch.randn((k, 3, 3, c, c), generator=gen, device=dev) * ws
    w2 = torch.randn((k, 3, 3, c, c), generator=gen, device=dev) * ws
    b1 = torch.randn((k, c), generator=gen, device=dev) * 0.1
    b2 = torch.randn((k, c), generator=gen, device=dev) * 0.1
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("dtype,passes", [(torch.float32, 3), (torch.float32, 1),
                                          (torch.bfloat16, 1)])
@pytest.mark.parametrize("hw", [(8, 8), (20, 36), (37, 19)])
def test_chain_kernel_matches_plain(dev, c, dtype, passes, hw):
    x, w1, b1, w2, b2 = _block_args(dev, (2, *hw, c), 2, dtype)
    got = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes)
    torch.cuda.synchronize()
    want = resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes)
    assert got.dtype == x.dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[(dtype, passes)] * want.float().abs().max().item(), err


def _check_chain(x, w1, b1, w2, b2, passes):
    got = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes)
    torch.cuda.synchronize()
    want = resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes)
    assert got.dtype == x.dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[(x.dtype, passes)] * want.float().abs().max().item(), err


@pytest.mark.parametrize("passes", [3, 1])
def test_chain_kernel_tile_count_not_a_multiple_of_the_sms(dev, passes):
    """The persistent grid has one cluster of two CTAs per pair of SMs that
    fits; some clusters take one tile more."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clusters = _clusters(128, passes, 0, 1)
    assert 0 < clusters <= sms // 2
    per_image = 4 * 5  # 16 x 16 tiles of a 64 x 80 image
    b = sms // per_image + 1
    assert (b * per_image) % clusters and b * per_image > clusters
    _check_chain(*_block_args(dev, (b, 64, 80, 128), 2, torch.float32), passes)


def _clusters(c, passes, dtype, epilogue):
    from dsen2_tpu_torch.ops._build import load_library

    return load_library().dsen2_conv3x3_clusters(c, passes, dtype, epilogue)


def _check_and_rerun(run, plain, tol):
    """The kernel against its plain version at `tol` of max|plain|, then
    once more: the second run's bits equal the first's."""
    got = run()
    torch.cuda.synchronize()
    want = plain()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _schedule_shape(case, c, passes):
    """Shapes that put the conv kernel's ping-pong schedule at its edges: one
    16-row image whose width gives the number of 16 x 16 x 128 tiles."""
    n = _clusters(c, passes, 0, 1)

    def width(tiles):  # a 16-pixel column gives c / 128 tiles (one at C = 64)
        return 16 * -(-tiles // max(c // 128, 1))

    return {
        # one pixel tile: warpgroup 1 of each CTA has no tile (C = 256: one
        # cluster each for the two channel halves)
        "one_tile": (1, 16, 16, c),
        # 8 rows: CTA 1's half of every tile lies outside the image
        "cta_half_outside": (1, 8, 40, c),
        # n + 1 tiles (n + 2 at C = 256): one or two clusters' warpgroup 1
        # has a tile, the others' none
        "clusters_plus_one": (1, 16, width(n + 1), c),
        # 3 n + 1 tiles (3 n + 2): the warpgroups of one or two clusters take
        # 2 + 2 tiles, of the others 2 + 1
        "three_waves_plus_one": (1, 16, width(3 * n + 1), c),
    }[case]


@pytest.mark.parametrize("case", ["one_tile", "cta_half_outside", "clusters_plus_one",
                                  "three_waves_plus_one"])
@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("dtype,passes", [(torch.float32, 3), (torch.float32, 1),
                                          (torch.bfloat16, 1)])
def test_schedule_edges_match_plain_and_rerun_bit_equal(dev, case, c, dtype, passes):
    shape = _schedule_shape(case, c, passes)
    x, w1, b1, w2, b2 = _block_args(dev, shape, 2, dtype, seed=6)
    _check_and_rerun(
        lambda: resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes),
        lambda: resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes),
        TOL[(dtype, passes)])


@pytest.mark.parametrize("dtype,passes", [(torch.float32, 3), (torch.float32, 1),
                                          (torch.bfloat16, 1)])
def test_schedule_out_aliases_the_residual(dev, dtype, passes):
    """Blocks after the first read their residual from `out` and write `out`
    in place (bf16: also their planes): three blocks."""
    x, w1, b1, w2, b2 = _block_args(dev, (2, 40, 72, 128), 3, dtype, seed=9)
    _check_and_rerun(
        lambda: resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes),
        lambda: resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes),
        TOL[(dtype, passes)])


def _seeded_block_args(shape, k, seed):
    """Inputs from numpy's generator, the same bits on any machine."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    ws = np.float32((9 * c) ** -0.5)
    x = rng.standard_normal(shape, dtype=np.float32)
    w1 = rng.standard_normal((k, 3, 3, c, c), dtype=np.float32) * ws
    w2 = rng.standard_normal((k, 3, 3, c, c), dtype=np.float32) * ws
    b1 = rng.standard_normal((k, c), dtype=np.float32) * np.float32(0.1)
    b2 = rng.standard_normal((k, c), dtype=np.float32) * np.float32(0.1)
    return x, w1, b1, w2, b2


# SHA-256 of B1's float32 output bytes on _seeded_block_args(shape, 2, 11),
# as the earlier schedule of the conv kernel (both warpgroups on one 16 x 16
# tile, the epilogue after the mainloop) computed them on an H100: the
# ping-pong schedule sums the same products in the same order.
SCHEDULE_SHA256 = {
    ((2, 40, 56, 128), 3): "19a7f2435db1b286cacd0c206234a7663568c5d4cb7c8f520c36164933f7626d",
    ((2, 40, 56, 128), 1): "8f3fa35820a2b251690ca7d4b8c736481f215764a72213343a91f8967303a513",
    ((1, 24, 40, 256), 3): "6c4089134487287cb325203bb8b6867ec8dcb2adb47d50653eae4dd2dc270971",
    ((1, 24, 40, 256), 1): "08ac3e658a200a339847c113a646f777bc735132537ee53f230bdb21a482a367",
}


def chain_output_sha256(chain_mod, dev, shape, passes) -> str:
    import hashlib

    args = [torch.from_numpy(a).to(dev) for a in _seeded_block_args(shape, 2, 11)]
    got = chain_mod.fused_resblock_chain(*args, passes=passes)
    return hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("shape,passes", list(SCHEDULE_SHA256))
def test_chain_kernel_bits_equal_the_previous_schedule(dev, shape, passes):
    got = chain_output_sha256(resblock_chain, dev, shape, passes)
    assert got == SCHEDULE_SHA256[(shape, passes)]


@pytest.mark.parametrize("shape", [(1, 5, 11, 128), (1, 7, 3, 256)])
@pytest.mark.parametrize("dtype,passes", [(torch.float32, 3), (torch.float32, 1),
                                          (torch.bfloat16, 1)])
def test_chain_kernel_image_smaller_than_one_tile(dev, shape, dtype, passes):
    """One tile: warpgroup 1 of each CTA idles, CTA 1's half is outside."""
    x, w1, b1, w2, b2 = _block_args(dev, shape, 2, dtype, seed=2)
    _check_and_rerun(
        lambda: resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes),
        lambda: resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes),
        TOL[(dtype, passes)])


@pytest.mark.parametrize("shape,k", [((6, 48, 64, 256), 2), ((12, 64, 256, 256), 1)])
@pytest.mark.parametrize("passes", [3, 1])
def test_chain_kernel_c256_more_tiles_than_sms(dev, shape, k, passes):
    """VDSen2 width: two 128-channel halves per pixel tile; 144 tiles (2 or
    3 per cluster) and 1,536 (23 or 24: many turns of the warpgroups)."""
    x, w1, b1, w2, b2 = _block_args(dev, shape, k, torch.float32, seed=3)
    _check_and_rerun(
        lambda: resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes),
        lambda: resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes),
        TOL[(torch.float32, passes)])


@pytest.mark.parametrize("passes", [3, 1])
def test_chain_kernel_is_deterministic(dev, passes):
    """No atomics: the same call twice gives the same bits."""
    x, w1, b1, w2, b2 = _block_args(dev, (3, 40, 56, 128), 2, torch.float32, seed=4)
    a = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes)
    b = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes)
    assert torch.equal(a, b)


def test_fused_resblock_main_path_shape(dev):
    """B2 at the shape the patch-132 route gives it: 132 = 8 * 16 + 4."""
    x, w1, b1, w2, b2 = _block_args(dev, (64, 132, 132, 128), 1, torch.float32, seed=5)
    _check_and_rerun(
        lambda: resblock.fused_resblock(x, w1[0], b1[0], w2[0], b2[0], tile_rows=4),
        lambda: resblock.fused_resblock_plain(x, w1[0], b1[0], w2[0], b2[0]),
        TOL[(torch.float32, 1)])


def test_zero_weights_identity(dev):
    x, w1, b1, w2, b2 = _block_args(dev, (2, 16, 24, 128), 1, torch.float32)
    z, zb = torch.zeros_like(w1), torch.zeros_like(b1)
    got = resblock_chain.fused_resblock_chain(x, z, zb, z, zb, passes=3)
    assert torch.equal(got, x)


def test_fused_resblock_matches_plain_and_counts(dev):
    x, w1, b1, w2, b2 = _block_args(dev, (3, 132, 40, 128), 1, torch.float32, seed=1)
    before = resblock.fused_resblock.launches
    got = resblock.fused_resblock(x, w1[0], b1[0], w2[0], b2[0], tile_rows=4)
    assert resblock.fused_resblock.launches == before + 1
    want = resblock.fused_resblock_plain(x, w1[0], b1[0], w2[0], b2[0])
    err = (got - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item()


def test_chain_counts_one_launch_per_block(dev):
    x, w1, b1, w2, b2 = _block_args(dev, (1, 16, 16, 128), 3, torch.float32)
    before = resblock_chain.fused_resblock_chain.launches
    resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=1)
    assert resblock_chain.fused_resblock_chain.launches == before + 3


def test_runs_under_inference_mode(dev):
    x, w1, b1, w2, b2 = _block_args(dev, (2, 16, 16, 128), 2, torch.float32)
    with torch.inference_mode():
        a = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=3)
    b = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=3)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["channels", "strided"])
def test_rejects_what_the_kernel_cannot_take(dev, bad):
    c = 48 if bad == "channels" else 128
    x, w1, b1, w2, b2 = _block_args(dev, (1, 16, 16, c), 1, torch.float32)
    if bad == "strided":
        x = x.transpose(1, 2)
    with pytest.raises(ValueError):
        resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2)


@pytest.mark.parametrize("precision,tol", [("high", 2e-4), ("default", 2e-2)])
@pytest.mark.parametrize("h", [32, 36, 33])
def test_s2net_kernels_track_highest(dev, precision, tol, h):
    cfg = ModelConfig(in_channels=(4, 6), num_layers=3, feature_size=128)
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(3), cfg), dev)
    rng = np.random.default_rng(4)
    x10 = torch.as_tensor(rng.random((2, h, 20, 4), np.float32), device=dev)
    x20 = torch.as_tensor(rng.random((2, h, 20, 6), np.float32), device=dev)
    with pytest.warns(UserWarning, match="highest"):
        ref = s2net.apply(params, (x10, x20), cfg, precision="highest", use_kernels=True)
    got = s2net.apply(params, (x10, x20), cfg, precision=precision, use_kernels=None)
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def _engine_case(seed=0):
    """Two 128-feature blocks (the kernels' width) on a 152 x 96 uint16 scene
    whose grid has an edge-flush row; patch 32 runs B1 at "high"."""
    from dsen2_tpu_torch.core.config import InferConfig

    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=128)
    params = s2net.init_params(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    rasters = [(rng.random((152, 96, 4)) * 8000).astype(np.uint16),
               (rng.random((76, 48, 6)) * 8000).astype(np.uint16)]
    return cfg, params, rasters, InferConfig(patch_size=32, border=4, batch_size=8,
                                             precision="high")


@pytest.mark.parametrize("out_dtype", ["float32", "uint16"])
@pytest.mark.parametrize("lookahead", [0, 2])
def test_banded_engine_equals_one_shot_on_card(dev, out_dtype, lookahead):
    """Windows staged through pinned memory on the copy stream and bands read
    back on the other give the one-shot mosaic bit for bit."""
    import dataclasses

    from dsen2_tpu_torch.infer import api, engine

    cfg, params, rasters, icfg = _engine_case()
    icfg = dataclasses.replace(icfg, output_dtype=out_dtype)
    before = resblock_chain.fused_resblock_chain.launches
    got = engine.sr_banded(rasters, 2, cfg, params, icfg, rows_per_band=2,
                           stage_lookahead=lookahead)
    assert resblock_chain.fused_resblock_chain.launches > before
    one = api._run(rasters, 2, cfg, params, icfg, device_output=True).cpu()
    np.testing.assert_array_equal(got, api._host_view(one, np.dtype(out_dtype)))


def test_banded_generator_closed_early_on_card(dev):
    from dsen2_tpu_torch.infer import engine

    cfg, params, rasters, icfg = _engine_case(1)
    bands = engine.sr_banded(rasters, 2, cfg, params, icfg, rows_per_band=1,
                             device_output=True)
    band, y0, h = next(bands)
    bands.close()
    assert band.is_cuda and y0 == 0 and band.shape[0] == h


@pytest.mark.parametrize("threshold", [1, 10**9])
def test_ensemble_on_card_is_the_mean_of_its_transforms(dev, threshold, monkeypatch):
    from dsen2_tpu_torch.infer import api
    from dsen2_tpu_torch.ops.dihedral import dihedral_np, inverse_code

    cfg, params, rasters, icfg = _engine_case(2)
    monkeypatch.setattr(api, "_BANDED_THRESHOLD_PX", threshold)
    got = api._run_ensembled(rasters, 2, cfg, params, icfg)
    want = np.zeros_like(got)
    for code in range(8):
        tr = [dihedral_np(r, code) for r in rasters]
        out = api._run(tr, 2, cfg, params, icfg, device_output=True).cpu().numpy()
        want += dihedral_np(out, inverse_code[code])
    want /= np.float32(8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def _conv_case(dev, cin, cout, b=4, h=32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, h, cin), generator=gen, device=dev)
    w = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (9 * cin) ** 0.5
    g = torch.randn((b, h, h, cout), generator=gen, device=dev)
    return x, w, g


@pytest.mark.parametrize("cin,cout,hw", [(10, 128, 32), (128, 128, 32), (128, 6, 32),
                                         (12, 128, 96), (128, 2, 96), (12, 256, 32)])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_tf32_plane_convs_are_exact(dev, cin, cout, hw, precision):
    """cuDNN's TF32 convs of bf16-valued planes (forward, dgrad, and the
    batch-chunked wgrad) equal the same plane convs in float64 within
    chip_smoke.PLANE_TOL x max|ref|: no operand is rounded (that would cost
    about 3e-4) and the f32 sums stay short."""
    import chip_smoke

    x, w, g = _conv_case(dev, cin, cout, b=64 if hw == 32 else 16, h=hw)
    ref = chip_smoke.plane_convs_f64(conv_mod, x, w, g, precision)
    planes = conv_mod._operand_planes(x, w, precision)
    got = [conv_mod._forward(x, w, None, precision, planes),
           *conv_mod._backward(g, planes, precision, True, True)]
    for name, a, r in zip(("y", "dx", "dw"), got, ref):
        err = chip_smoke.rel_err(a, r)
        assert err <= chip_smoke.PLANE_TOL, (name, err)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_training_step_gradients_track_highest(dev, precision):
    """One step's parameter gradients of the MAE loss, DSen2 2x at full
    width on the first batch of chip_smoke.py's training set, at each class
    against "highest" (chip_smoke.E2E_TOL)."""
    import chip_smoke
    from dsen2_tpu_torch.core.config import dsen2_2x
    from dsen2_tpu_torch.train.losses import mae

    cfg = dsen2_2x()
    xs, label = chip_smoke.training_set(0, chip_smoke.TRAIN_N + chip_smoke.VAL_N, 32,
                                        cfg.in_channels)
    b = chip_smoke.TRAIN_BATCH
    inputs = [torch.as_tensor(x[:b], device=dev) for x in xs]
    target = torch.as_tensor(label[:b], device=dev)
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(0), cfg), dev)
    leaves = s2net.param_leaves(params)
    for t in leaves:
        t.requires_grad_()

    def grads(p):
        return torch.autograd.grad(mae(s2net.apply(params, inputs, cfg, precision=p), target),
                                   leaves)

    for a, r in zip(grads(precision), grads("highest")):
        assert (a - r).abs().max().item() <= chip_smoke.E2E_TOL[precision] * r.abs().max().item()


def test_fit_on_card_staged_equals_host_fed(dev):
    from dsen2_tpu_torch.core.config import TrainConfig
    from dsen2_tpu_torch.train import fit

    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=128)
    rng = np.random.default_rng(7)
    x10 = rng.random((48, 32, 32, 4), dtype=np.float32)
    x20 = rng.random((48, 32, 32, 6), dtype=np.float32)
    lb = (x20 * 1.2 + 0.1 * x10[..., :1]).astype(np.float32)
    data = (x10[:32], x20[:32]), lb[:32], (x10[32:], x20[32:]), lb[32:]
    tcfg = TrainConfig(batch_size=16, augment=True)
    params = s2net.init_params(torch.Generator().manual_seed(8), cfg)
    _, h_host = fit(cfg, tcfg, *data, params=params, epochs=2, verbose=False)
    _, h_st = fit(cfg, tcfg, *data, params=params, epochs=2, verbose=False, stage_data=True)
    assert np.isfinite(h_host["loss"]).all()
    np.testing.assert_allclose(h_st["loss"], h_host["loss"], rtol=1e-4)
    np.testing.assert_allclose(h_st["val_loss"], h_host["val_loss"], rtol=1e-4)


@pytest.mark.parametrize("out_dtype", ["float32", "uint16"])
def test_s2_supres_on_card_equals_the_api(dev, out_dtype, tmp_path):
    """The CLI on a 360^2 product held in memory (chip_smoke.py's GDAL seam)
    writes, bit for bit, the SR bands the API computes from the same arrays,
    with the product's EPSG code and tiepoint."""
    import chip_smoke
    from dsen2_tpu_torch.cli import s2_supres
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer import api
    from tiff_reader import read_tiff

    d10, d20, d60 = chip_smoke.product_rasters(7, 360)
    gdal, name = chip_smoke.gdal_product(d10, d20, d60)
    tif = str(tmp_path / "out.tif")
    before = resblock_chain.fused_resblock_chain.launches
    with chip_smoke.installed_gdal(gdal):
        assert s2_supres.main([name, tif, "--run_60", "--output-dtype", out_dtype]) == 0
    assert resblock_chain.fused_resblock_chain.launches > before
    sr60 = api.dsen2_60(d10, d20, d60[:, :, :2], infer_cfg=InferConfig(
        patch_size=192, border=12, output_dtype=out_dtype))
    sr20 = api.dsen2_20(d10, d20, infer_cfg=InferConfig(
        patch_size=128, border=8, output_dtype=out_dtype))
    t = read_tiff(tif)
    assert t["geokeys"][3072] == chip_smoke.PRODUCT_EPSG
    assert t["tiepoint"][3:5] == [chip_smoke.PRODUCT_ULX, chip_smoke.PRODUCT_ULY]
    want = np.concatenate([sr20, sr60], axis=2)
    for i, n in enumerate(t["descriptions"]):
        np.testing.assert_array_equal(t["bands"][n], want[:, :, i], err_msg=n)


def test_recompose_on_card_equals_cpu(dev):
    from dsen2_tpu_torch.ops import tiling

    patches = torch.from_numpy(np.random.default_rng(9).random((31, 24, 24, 6), dtype=np.float32))
    want = tiling.recompose(patches, 4, (90, 75))
    got = tiling.recompose(patches.to(dev), 4, (90, 75))
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_tile_sharded_over_a_repeated_gpu_equals_one_device(dev):
    """sr_tile_sharded on [cuda:0] * 2: two host workers launch B1 at once on
    streams of their own; the mosaic is the single-device one bit for bit
    (the chunk batch coincides), and both shards launched the kernel."""
    from dsen2_tpu_torch.infer import api
    from dsen2_tpu_torch.parallel import make_mesh
    from dsen2_tpu_torch.parallel.inference import sr_tile_sharded

    cfg, params, rasters, icfg = _engine_case(3)
    mesh = make_mesh([torch.device("cuda", torch.cuda.current_device())] * 2)
    want = api._run(rasters, 2, cfg, params, icfg)
    before = resblock_chain.fused_resblock_chain.launches
    got = sr_tile_sharded(params, rasters, 2, cfg, icfg, mesh)
    blocks = resblock_chain.fused_resblock_chain.launches - before
    np.testing.assert_array_equal(got, want)
    assert blocks >= 2 * cfg.num_layers
    assert np.array_equal(api._run(rasters, 2, cfg, params, icfg, mesh=mesh), want)


# ------------------------------------------------------------ RCAN (C = 64)

def _c64_args(dev, shape, k, seed):
    return _block_args(dev, shape, k, torch.float32, seed=seed)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 20, 36, 64), (1, 37, 19, 64),
                                   (64, 128, 128, 64)])
@pytest.mark.parametrize("passes", [3, 1])
def test_c64_conv_kernel_matches_plain_and_reruns_bit_equal(dev, shape, passes):
    """The conv kernel at C = 64 (one m64n64k16 tile of all 64 channels)
    with the ReLU and residual epilogues, through B1's wrapper; the last
    shape is a batch of RCAN's patches."""
    x, w1, b1, w2, b2 = _c64_args(dev, shape, 2, seed=12)
    _check_and_rerun(
        lambda: resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes),
        lambda: resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes),
        TOL[(torch.float32, passes)])


@pytest.mark.parametrize("case", ["one_tile", "cta_half_outside", "clusters_plus_one",
                                  "three_waves_plus_one"])
@pytest.mark.parametrize("passes", [3, 1])
def test_c64_schedule_edges_match_plain(dev, case, passes):
    shape = _schedule_shape(case, 64, passes)
    x, w1, b1, w2, b2 = _c64_args(dev, shape, 2, seed=13)
    _check_and_rerun(
        lambda: resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes),
        lambda: resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=passes),
        TOL[(torch.float32, passes)])


def test_c64_rejects_bf16_activations(dev):
    x, w1, b1, w2, b2 = _c64_args(dev, (1, 16, 16, 64), 1, seed=1)
    with pytest.raises(ValueError, match="float32"):
        resblock_chain.fused_resblock_chain(x.bfloat16(), w1, b1, w2, b2, passes=1)


def _pool_conv(dev, shape, passes, seed):
    """conv2 with the pooling epilogue on t of `shape`: (y, pool, plain y)."""
    from dsen2_tpu_torch.ops._build import load_library
    from dsen2_tpu_torch.ops.channel_attention import pool_rows

    t, w, b, _, _ = _c64_args(dev, shape, 1, seed)
    t = torch.relu(t)
    bsz, h, wd, c = shape
    planes = resblock_chain.split_planes(t, passes).contiguous()
    packed = resblock_chain.pack_weights(w[0], passes)
    bias = b[0].contiguous()
    y = torch.empty_like(t)
    pool = torch.full((bsz, pool_rows(h, wd), c), float("nan"), device=dev)
    err = load_library().dsen2_conv3x3_pool(
        planes.data_ptr(), packed.data_ptr(), bias.data_ptr(), y.data_ptr(), pool.data_ptr(),
        bsz, h, wd, c, passes, torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    plain = resblock_chain._conv(t, w[0], passes) + b[0]
    return y, pool, plain


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 37, 21, 64), (64, 128, 128, 64)])
@pytest.mark.parametrize("passes", [3, 1])
def test_pooling_epilogue_matches_plain(dev, shape, passes):
    """y = conv + bias in f32 and each warp's sums of y, in the layout of
    channel_attention.pool_sums_plain, against the plain conv; every row of
    the sums is written (none left NaN)."""
    from dsen2_tpu_torch.ops.channel_attention import pool_sums_plain

    y, pool, plain = _pool_conv(dev, shape, passes, seed=14)
    tol = TOL[(torch.float32, passes)]
    scale = plain.abs().max().item()
    assert (y - plain).abs().max().item() <= tol * scale
    assert torch.isfinite(pool).all()
    want = pool_sums_plain(y)  # the kernel's own y, so the sums alone are compared
    assert (pool - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    y2, pool2, _ = _pool_conv(dev, shape, passes, seed=14)
    assert torch.equal(y, y2) and torch.equal(pool, pool2)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 37, 21, 64), (64, 128, 128, 64)])
@pytest.mark.parametrize("passes", [3, 1])
def test_gate_kernel_matches_plain(dev, shape, passes):
    """x + s * y and its planes against the gate's plain version on the same
    sums; in place (out = x) equals out of place; the same bits twice."""
    from dsen2_tpu_torch.ops import channel_attention as ca

    g = torch.Generator(device=dev).manual_seed(15)
    x, y = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    c = shape[-1]
    wd, bd = torch.randn((c, 4), generator=g, device=dev) * 0.2, torch.randn(4, device=dev)
    wu, bu = torch.randn((4, c), generator=g, device=dev) * 0.5, torch.randn(c, device=dev)
    pool = ca.pool_sums_plain(y)
    before = profiling.counters().get("rcan.gates", 0)
    out, planes = ca.ca_gate(x, y, pool, wd, bd, wu, bu, passes=passes)
    torch.cuda.synchronize()
    assert profiling.counters()["rcan.gates"] == before + 1
    want, want_planes = ca.ca_gate(*(t.cpu() for t in (x, y, pool, wd, bd, wu, bu)),
                                   passes=passes)
    assert (out.cpu() - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    assert planes.shape == want_planes.shape
    recon = planes.float().sum(0).cpu()
    assert (recon - want).abs().max().item() <= (2e-5 if passes == 3 else 8e-3) * \
        want.abs().max().item()
    again, _ = ca.ca_gate(x, y, pool, wd, bd, wu, bu, passes=passes)
    assert torch.equal(out, again)


def _rcan_case(dev, seed=0, groups=2, blocks=3):
    from dsen2_tpu_torch.models import rcan

    cfg = rcan.RCANConfig(groups=groups, blocks=blocks, features=64, reduction=16)
    params = params_to_torch(rcan.init_params(torch.Generator().manual_seed(seed), cfg), dev)
    return cfg, params


@pytest.mark.parametrize("precision,tol", [("high", 1e-4), ("default", 2e-2)])
@pytest.mark.parametrize("hw", [(128, 128), (40, 56)])
def test_rcan_kernels_track_highest(dev, precision, tol, hw):
    """A small RCAN (2 groups x 3 RCABs at 64 features) through the kernels
    against the same net at "highest" on the card; the body is the span
    s2net.rcan and the counters move by the blocks and gates run."""
    from dsen2_tpu_torch.models import rcan

    cfg, params = _rcan_case(dev, seed=5)
    rng = np.random.default_rng(6)
    xs = [torch.as_tensor(rng.random((3, *hw, c), np.float32) * 2, device=dev)
          for c in cfg.in_channels]
    want = rcan.apply(params, xs, cfg, precision="highest", use_kernels=False)
    before = profiling.counters()
    got = rcan.apply(params, xs, cfg, precision=precision, use_kernels=None)
    after = profiling.counters()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    assert after["rcan.blocks"] - before.get("rcan.blocks", 0) == 6
    assert after["rcan.gates"] - before.get("rcan.gates", 0) == 6
    assert after["rcan.convs"] - before.get("rcan.convs", 0) == 6 + 2 + 1
    assert after["b1.tiles"] > before.get("b1.tiles", 0)
    assert torch.equal(got, rcan.apply(params, xs, cfg, precision=precision, use_kernels=None))


@pytest.mark.parametrize("precision", ["high", "default"])
def test_rcan_through_dsen2_20_on_card(dev, precision):
    """dsen2_20 with the RCAN config, one-shot and banded, on the card
    against the same call on the CPU at "highest"."""
    from dsen2_tpu_torch.core.config import InferConfig
    from dsen2_tpu_torch.infer import api, engine
    from dsen2_tpu_torch.models import rcan

    cfg = rcan.RCANConfig(groups=2, blocks=3, features=64, reduction=16)
    params = rcan.init_params(torch.Generator().manual_seed(7), cfg)
    rng = np.random.default_rng(8)
    rasters = [(rng.random((232, 200, 4)) * 8000).astype(np.uint16),
               (rng.random((116, 100, 6)) * 8000).astype(np.uint16)]
    icfg = InferConfig(patch_size=128, border=8, batch_size=8, precision=precision)
    got = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, model=cfg)
    banded = engine.sr_banded(rasters, 2, cfg, params, icfg, rows_per_band=1)
    want = api.dsen2_20(*rasters, params=params, model=cfg, device="cpu",
                        infer_cfg=InferConfig(patch_size=128, border=8, batch_size=8,
                                              precision="highest"))
    tol = {"high": 1e-4, "default": 2e-2}[precision]
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * top
    assert np.abs(banded - want).max() <= tol * top


# Special f32 values for the plane pass: signed zeros, infinities, NaN,
# subnormals, the largest finite values (they round up to inf), ties at
# bf16's last bit in both directions, and lo ties.
_SPECIAL_BITS = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                 0x7FA00001, 0x00000001, 0x80000001, 0x007FFFFF, 0x00408000, 0x807F8000,
                 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x3F808000, 0x3F818000,
                 0xBF808000, 0xBF818000, 0x3F800001, 0x3F80FFFF, 0x33808000, 0x3F808080]


def _plane_input(dev, shape, seed):
    """f32 values of `shape`: normal draws at several scales, random bit
    patterns (every exponent, NaN payloads included) and _SPECIAL_BITS."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(shape, generator=gen, device=dev)
    flat = v.view(-1)
    n = flat.numel()
    flat[: n // 4] *= 10.0 ** torch.randint(-40, 38, (n // 4,), generator=gen, device=dev)
    bits = torch.randint(-2**31, 2**31 - 1, (n // 4,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    flat[n // 4 : n // 4 + n // 4] = bits.view(torch.float32)
    special = torch.tensor(_SPECIAL_BITS, dtype=torch.int64).to(torch.int32).view(torch.float32)
    k = min(n, special.numel())
    flat[-k:] = special[:k].to(dev)
    return v


def _bits_equal(a, b):
    return a.shape == b.shape and a.stride() == b.stride() and \
        torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape,view", [
    ((128, 32, 32, 10), "nchw"), ((128, 32, 32, 128), "nchw"), ((128, 32, 32, 6), "nchw"),
    ((64, 128, 128, 128), "nchw"), ((3, 3, 10, 128), "oihw"), ((3, 3, 128, 128), "oihw"),
    ((3, 3, 128, 6), "oihw"), ((3, 3, 128, 2), "oihw"), ((7, 5, 3), "flat"), ((1, 3, 5, 7), "nchw"),
    ((2, 11, 13, 6), "offset"), ((24,), "flat"), ((128, 32, 32, 10), "sliced"),
    ((16, 32, 32, 128), "strided")])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_plane_pass_bit_equal_to_plain_planes(dev, shape, view, precision):
    """The plane pass (csrc plane_kernel) writes the planes of the plain
    split, bit for bit, in the operand's own layout: the layouts the convs
    take (NHWC as NCHW, HWIO as OIHW), numel % 4 != 0, a start off a 16-byte
    boundary ("offset": the scalar path), views not dense in memory
    ("sliced": NCHW of an NHWC channel slice, "strided": every other row),
    which are copied dense first, and the special values above."""
    v = _plane_input(dev, shape if view != "offset" else (shape[0] + 1, *shape[1:]), seed=3)
    if view == "nchw":
        v = conv_mod._nchw(v)
    elif view == "oihw":
        v = conv_mod._oihw(v)
    elif view == "offset":
        v = v.view(-1)[1 : 1 + int(np.prod(shape))].view(shape)
        assert v.data_ptr() % 16
    elif view == "sliced":
        v = conv_mod._nchw(v[..., :7])
    elif view == "strided":
        v = conv_mod._nchw(v[:, ::2])
    assert conv_mod._dense(v) is (view not in ("sliced", "strided"))
    before = profiling.counters().get("conv.plane_passes", 0)
    got = conv_mod._planes(v, precision)
    torch.cuda.synchronize()
    assert profiling.counters().get("conv.plane_passes", 0) == before + 1
    want = conv_mod._plain_planes(v, precision)
    assert _bits_equal(got[0], want[0])
    if precision == "high":
        assert _bits_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("cin,cout", [(10, 128), (128, 128), (128, 6), (12, 128), (128, 2)])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_conv_with_the_plane_pass_bit_equal_to_plain_planes(dev, cin, cout, precision,
                                                            monkeypatch):
    """conv3x3's y, dx, dw and db with the plane pass are bit-equal to
    those with the plain split in its place (cuDNN held to deterministic
    algorithms on both sides)."""
    x, w, g = _conv_case(dev, cin, cout, b=8, h=32)
    bias = torch.randn((cout,), device=dev)

    def run(conv):
        tx, tw, tb = (t.clone().requires_grad_() for t in (x, w, bias))
        y = conv(tx, tw, tb)
        return [y.detach(), *torch.autograd.grad(y, (tx, tw, tb), g)]

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        passes = profiling.counters().get("conv.plane_passes", 0)
        got = run(lambda *a: conv_mod.conv3x3(*a, precision))
        assert profiling.counters().get("conv.plane_passes", 0) == passes + 3
        monkeypatch.setattr(conv_mod, "_planes", conv_mod._plain_planes)
        want = run(lambda *a: conv_mod.conv3x3(*a, precision))
        assert profiling.counters().get("conv.plane_passes", 0) == passes + 3
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert torch.equal(a, b), name


def test_train_step_counts_plane_passes_and_kept_planes(dev):
    """One DSen2 2x train_step at "high" splits 28 operands in the forward
    (x and w of 14 convs) and 14 gradients in the backward, each in one
    plane pass, and its 14 backward calls take the forward's planes; a
    no_grad forward splits 28 and keeps none."""
    from dsen2_tpu_torch.core.config import TrainConfig, dsen2_2x
    from dsen2_tpu_torch.train import loop
    from dsen2_tpu_torch.train.nadam import make_optimizer

    cfg = dsen2_2x()
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = tuple(torch.rand((4, 32, 32, c), generator=gen, device=dev)
                   for c in cfg.in_channels)
    target = torch.rand((4, 32, 32, cfg.out_channels), generator=gen, device=dev)
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(0), cfg), dev)
    for sub in params.values():
        for t in sub.values():
            t.requires_grad_()
    opt = make_optimizer(params, TrainConfig())

    def counts():
        c = profiling.counters()
        return c.get("conv.plane_passes", 0), c.get("conv.planes_kept", 0)

    before = counts()
    loop.train_step(params, opt, inputs, target, cfg, "high")
    torch.cuda.synchronize()
    after = counts()
    assert (after[0] - before[0], after[1] - before[1]) == (42, 14)
    with torch.no_grad():
        s2net.apply(params, inputs, cfg, precision="high")
    assert counts() == (after[0] + 28, after[1])


# DSen2's head and tail kernels (ops/head_tail.py). Each against the same
# plane products in float64 within chip_smoke.PLANE_TOL x max|ref|: the
# products of bf16 values are exact, only the f32 sums' order differs.
def _edge_ref(x, w, b, passes):
    """conv3x3(x, w) of the class's planes in float64, + b."""
    import torch.nn.functional as F

    xp = resblock_chain.split_planes(x, passes).double()
    wp = resblock_chain.split_planes(w, passes).double()

    def conv(a, k):
        return F.conv2d(a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)

    y = conv(xp[0], wp[0])
    if passes == 3:
        y = y + conv(xp[1], wp[0]) + conv(xp[0], wp[1])
    return y + b.double()


def _edge_case(dev, shape, cin, f, cout, seed):
    """The net's inputs (channels cin) of [B, H, W], head and tail weights,
    and an f32 x of F channels, drawn at He-like scales."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = [torch.rand((*shape, c), generator=gen, device=dev) for c in cin]
    hw = torch.randn((3, 3, sum(cin), f), generator=gen, device=dev) * (9 * sum(cin)) ** -0.5
    hb = torch.randn((f,), generator=gen, device=dev) * 0.1
    tw = torch.randn((3, 3, f, cout), generator=gen, device=dev) * (9 * f) ** -0.5
    tb = torch.randn((cout,), generator=gen, device=dev) * 0.1
    x = torch.randn((*shape, f), generator=gen, device=dev)
    return inputs, hw, hb, tw, tb, x


_EDGE_SHAPES = {"2x": ((64, 128, 128), (4, 6), 6), "6x": ((64, 192, 192), (4, 6, 2), 2),
                "ragged": ((3, 37, 53), (4, 6), 6)}


@pytest.mark.parametrize("case", list(_EDGE_SHAPES))
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_head_kernel_matches_the_plane_products(dev, case, f, precision):
    from chip_smoke import PLANE_TOL
    from dsen2_tpu_torch.ops import head_tail

    shape, cin, cout = _EDGE_SHAPES[case]
    inputs, hw, hb, _, _, _ = _edge_case(dev, shape, cin, f, cout, seed=7)
    passes = 3 if precision == "high" else 1
    x, planes = head_tail.head(inputs, hw, hb, precision, planes=True)
    torch.cuda.synchronize()
    ref = _edge_ref(torch.cat(inputs, dim=-1), hw, hb, passes).clamp_min(0)
    assert x.shape == (*shape, f) and x.dtype == torch.float32
    assert (x.double() - ref).abs().max().item() <= PLANE_TOL * ref.abs().max().item()
    # The planes are split_planes of x, bit for bit.
    want = resblock_chain.split_planes(x, passes)
    assert planes.shape == want.shape
    assert torch.equal(planes.view(torch.int16), want.view(torch.int16))
    del ref, want
    again, none = head_tail.head(inputs, hw, hb, precision)
    assert none is None and torch.equal(again, x)


@pytest.mark.parametrize("case", list(_EDGE_SHAPES))
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_tail_kernel_matches_the_plane_products(dev, case, f, precision):
    from chip_smoke import PLANE_TOL
    from dsen2_tpu_torch.ops import head_tail

    shape, cin, cout = _EDGE_SHAPES[case]
    inputs, _, _, tw, tb, x = _edge_case(dev, shape, cin, f, cout, seed=8)
    passes = 3 if precision == "high" else 1
    got = head_tail.tail(x, tw, tb, inputs[-1], precision)
    torch.cuda.synchronize()
    ref = _edge_ref(x, tw, tb, passes) + inputs[-1].double()
    assert got.shape == (*shape, cout) and got.dtype == torch.float32
    assert (got.double() - ref).abs().max().item() <= PLANE_TOL * ref.abs().max().item()
    assert torch.equal(head_tail.tail(x, tw, tb, inputs[-1], precision), got)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_head_and_tail_give_a_patch_the_same_bits_alone_and_in_a_batch(dev, precision):
    from dsen2_tpu_torch.ops import head_tail

    inputs, hw, hb, tw, tb, x = _edge_case(dev, (64, 128, 128), (4, 6), 128, 6, seed=9)
    xs, planes = head_tail.head(inputs, hw, hb, precision, planes=True)
    ys = head_tail.tail(x, tw, tb, inputs[-1], precision)
    for i in (0, 37, 63):
        one, one_planes = head_tail.head([t[i : i + 1] for t in inputs], hw, hb, precision,
                                         planes=True)
        assert torch.equal(one[0], xs[i])
        assert torch.equal(one_planes[:, 0].view(torch.int16), planes[:, i].view(torch.int16))
        y = head_tail.tail(x[i : i + 1].contiguous(), tw, tb, inputs[-1][i : i + 1], precision)
        assert torch.equal(y[0], ys[i])


@pytest.mark.parametrize("bad", ["cin", "cout", "strided_x", "misaligned_x", "features",
                                 "head_64", "tail_64", "bf16_input"])
def test_head_and_tail_raise_on_what_the_kernels_cannot_take(dev, bad):
    from dsen2_tpu_torch.ops import head_tail

    cin = (4, 6, 8) if bad == "cin" else (4, 6)
    inputs, hw, hb, tw, tb, x = _edge_case(dev, (2, 16, 24), cin, 128, 9 if bad == "cout" else 6,
                                           seed=10)
    with pytest.raises(ValueError):
        if bad == "cin":
            head_tail.head(inputs, hw, hb, "high")
        elif bad == "cout":
            head_tail.tail(x, tw, tb, torch.zeros((2, 16, 24, 9), device=dev), "high")
        elif bad == "strided_x":
            head_tail.tail(x.transpose(1, 2), tw, tb, inputs[-1].transpose(1, 2), "high")
        elif bad == "misaligned_x":
            buf = torch.zeros(x.numel() + 4, device=dev)
            head_tail.tail(buf[1 : 1 + x.numel()].view(x.shape), tw, tb, inputs[-1], "high")
        elif bad == "features":
            head_tail.head(inputs, hw[..., :96], hb[:96], "high")
        elif bad == "head_64":
            head_tail.head(inputs, hw[..., :64], hb[:64], "high")
        elif bad == "tail_64":
            head_tail.tail(x[..., :64].contiguous(), tw[:, :, :64], tb, inputs[-1], "high")
        else:
            head_tail.head([inputs[0].to(torch.bfloat16), inputs[1]], hw, hb, "high")


@pytest.mark.parametrize("precision", ["high", "default"])
def test_head_and_tail_read_strided_inputs_as_their_contiguous_copies(dev, precision):
    """The upsampled inputs arrive as permuted views (ops/resize.py's einsum
    output): the kernels read them in place, bit-equal to contiguous copies."""
    from dsen2_tpu_torch.ops import head_tail
    from dsen2_tpu_torch.ops.resize import upsample_patches

    inputs, hw, hb, tw, tb, x = _edge_case(dev, (8, 64, 64), (4, 6), 128, 6, seed=13)
    gen = torch.Generator(device=dev).manual_seed(14)
    up = upsample_patches(torch.rand((8, 32, 32, 6), generator=gen, device=dev), (64, 64))
    assert not up.is_contiguous()
    strided = [inputs[0][:, :, :, :], up]
    dense = [t.contiguous() for t in strided]
    got, got_planes = head_tail.head(strided, hw, hb, precision, planes=True)
    want, want_planes = head_tail.head(dense, hw, hb, precision, planes=True)
    assert torch.equal(got, want)
    assert torch.equal(got_planes.view(torch.int16), want_planes.view(torch.int16))
    assert torch.equal(head_tail.tail(x, tw, tb, up, precision),
                       head_tail.tail(x, tw, tb, up.contiguous(), precision))


@pytest.mark.parametrize("precision", ["high", "default"])
def test_chain_takes_the_heads_planes_bit_equal(dev, precision):
    """B1 on the head's planes (no split_kernel) gives the bits it gives on
    its own split of the same x."""
    from dsen2_tpu_torch.ops import head_tail

    inputs, hw, hb, _, _, _ = _edge_case(dev, (3, 40, 56), (4, 6), 128, 6, seed=11)
    x, planes = head_tail.head(inputs, hw, hb, precision, planes=True)
    _, w1, b1, w2, b2 = _block_args(dev, (3, 40, 56, 128), 2, torch.float32, seed=12)
    passes = 3 if precision == "high" else 1
    want = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes)
    got = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=passes, planes=planes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("layers,h", [(2, 32), (3, 36)])
def test_s2net_counts_one_head_and_one_tail_a_batch(dev, precision, layers, h):
    """The kernel route launches the head and the tail once a call, on B1's
    route (2 blocks) and on B2's ("default", 3 blocks), and no plane pass;
    "highest" launches neither."""
    cfg = ModelConfig(in_channels=(4, 6), num_layers=layers, feature_size=128)
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(3), cfg), dev)
    rng = np.random.default_rng(4)
    xs = [torch.as_tensor(rng.random((2, h, 20, c), np.float32), device=dev)
          for c in cfg.in_channels]

    def counts():
        c = profiling.counters()
        return tuple(c.get(k, 0) for k in ("s2net.heads", "s2net.tails", "conv.plane_passes"))

    before = counts()
    s2net.apply(params, xs, cfg, precision=precision, use_kernels=None)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0)
    before = counts()
    s2net.apply(params, xs, cfg, precision="highest", use_kernels=None)
    assert counts()[:2] == before[:2]


@pytest.mark.parametrize("precision", ["high", "default"])
def test_s2net_keeps_the_class_conv_head_and_tail_at_64_features(dev, precision):
    """At a width the head and tail kernels do not take (64 features), the
    blocks run on B1 and the head and tail on the class conv: no head or
    tail launch, the class conv's plane passes instead."""
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=64)
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(5), cfg), dev)
    rng = np.random.default_rng(6)
    xs = [torch.as_tensor(rng.random((2, 32, 20, c), np.float32), device=dev)
          for c in cfg.in_channels]

    def counts():
        c = profiling.counters()
        return tuple(c.get(k, 0) for k in ("s2net.heads", "s2net.tails", "conv.plane_passes",
                                           "b1.tiles"))

    before = counts()
    out = s2net.apply(params, xs, cfg, precision=precision, use_kernels=None)
    torch.cuda.synchronize()
    after = counts()
    assert out.shape == (2, 32, 20, cfg.out_channels) and bool(torch.isfinite(out).all())
    assert after[:2] == before[:2]
    assert after[2] > before[2] and after[3] > before[3]
