"""The port's RCAN (models/rcan.py, ops/channel_attention.py) against the
plain reference tests/rcan_reference.py, on the CPU, at a small size (2
groups x 3 RCABs x 16 features, reduction 4) unless a test says otherwise.

Tolerances, as shares of max|reference|:
  - "highest": 1e-5. Both are float32 convs with TF32 off; only the order
    of the sums differs.
  - "high": 5e-5. bf16x3 keeps about 16 significant bits of each operand
    (the lo*lo product is dropped), so each conv strays by about 2^-16 of
    its inputs' scale; the measured gap here is 4e-6.
  - "default": 1e-2. One bf16 pass keeps 8 bits of each operand (2^-9
    relative); the measured gap here is 2e-3, and it must exceed the
    "high" tolerance (test_default_reading_fails_the_high_tolerance).
"""

import numpy as np
import pytest
import torch

import rcan_reference as ref
from dsen2_tpu_torch.core.config import InferConfig
from dsen2_tpu_torch.infer import api, engine
from dsen2_tpu_torch.models import rcan
from dsen2_tpu_torch.ops import channel_attention as ca
from dsen2_tpu_torch.weights import params_to_torch

CFG = rcan.RCANConfig(groups=2, blocks=3, features=16, reduction=4)
TOL = {"highest": 1e-5, "high": 5e-5, "default": 1e-2}
KW = dict(patch_size=32, border=4, batch_size=4)


def _params(cfg=CFG, seed=0):
    return rcan.init_params(torch.Generator().manual_seed(seed), cfg)


def _inputs(n=2, hw=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n, hw, hw, c), generator=g) * 3 for c in CFG.in_channels]


def _reference(tp, xs):
    with ref.no_tf32():
        out = ref.forward(tp, [x.permute(0, 3, 1, 2) for x in xs])
    return out.permute(0, 2, 3, 1)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("use_kernels", [None, True])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_apply_matches_reference(precision, use_kernels):
    """The class convs with the plain gate (use_kernels None on the CPU),
    and the kernels' plain versions (use_kernels True)."""
    tp = params_to_torch(_params(), "cpu")
    xs = _inputs()
    if precision == "highest" and use_kernels:
        with pytest.warns(UserWarning, match="no true-f32 path"):
            got = rcan.apply(tp, xs, CFG, precision=precision, use_kernels=use_kernels)
    else:
        got = rcan.apply(tp, xs, CFG, precision=precision, use_kernels=use_kernels)
    assert _rel(got, _reference(tp, xs)) <= TOL[precision]


def test_default_reading_fails_the_high_tolerance():
    tp = params_to_torch(_params(), "cpu")
    xs = _inputs()
    want = _reference(tp, xs)
    high = _rel(rcan.apply(tp, xs, CFG, precision="high", use_kernels=None), want)
    default = _rel(rcan.apply(tp, xs, CFG, precision="default", use_kernels=None), want)
    assert high <= TOL["high"] < default


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 4)) * 8000).astype(np.uint16),
            (rng.random((h // 2, w // 2, 6)) * 8000).astype(np.uint16)]


def _reference_net(monkeypatch):
    """The API with rcan_reference's net in place of the port's."""
    def apply(params, inputs, cfg, precision, use_kernels):
        return _reference(params, inputs)

    monkeypatch.setattr(api, "net_apply", lambda cfg: apply)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_dsen2_20_runs_rcan_against_reference(precision, monkeypatch):
    rasters = _scene(3, 72, 56)
    params = _params()
    icfg = InferConfig(precision=precision, **KW)
    got = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    assert got.shape == (72, 56, 6) and got.dtype == np.float32
    _reference_net(monkeypatch)
    want = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    gap = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert gap <= TOL[precision]


@pytest.mark.parametrize("rows_per_band", [1, 2, 100])
def test_banded_engine_runs_rcan_against_reference(rows_per_band, monkeypatch):
    rasters = _scene(4, 80, 64)
    params = _params(seed=2)
    icfg = InferConfig(precision="highest", **KW)
    got = engine.sr_banded(rasters, 2, CFG, params, icfg, rows_per_band=rows_per_band,
                           device="cpu")
    _reference_net(monkeypatch)
    want = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["highest"] * np.abs(want).max())


def test_dsen2_20_needs_params_for_rcan():
    with pytest.raises(ValueError, match="no shipped weights"):
        api.dsen2_20(*_scene(5, 64, 64), infer_cfg=InferConfig(**KW), device="cpu", model=CFG)


def test_dsen2_20_default_model_is_unchanged(monkeypatch):
    """model=None still runs s2net, through the same dispatch."""
    from dsen2_tpu_torch.models import s2net

    assert api.net_apply(None) is s2net.apply
    assert api.net_apply(rcan.rcan_2x()) is rcan.apply


def test_param_count_at_published_widths():
    cfg = rcan.rcan_2x()
    assert (cfg.groups, cfg.blocks, cfg.features, cfg.reduction, cfg.squeeze) == (10, 20, 64, 16, 4)
    assert cfg.groups * (2 * cfg.blocks + 1) + 1 == 411  # 3x3 convs of 64 -> 64
    assert rcan.param_count(_params(cfg)) == 15_302_694


def test_init_is_conv2d_default():
    """Weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    cfg = rcan.RCANConfig(groups=2, blocks=4, features=32, reduction=8)
    p = _params(cfg)
    for leaf, fan_in in ((p["head"]["w"], 90), (p["head"]["b"], 90), (p["blocks"]["w1"], 288),
                         (p["blocks"]["b2"], 288), (p["ca"]["wd"], 32), (p["ca"]["bu"], 4),
                         (p["groups"]["w"], 288), (p["tail"]["b"], 288)):
        bound = 1 / np.sqrt(fan_in)
        assert np.abs(leaf).max() <= bound
        assert np.abs(leaf).max() > 0.5 * bound


def test_plain_gate_matches_reference_channel_attention():
    g = torch.Generator().manual_seed(7)
    x, y = torch.randn((3, 9, 13, 16), generator=g), torch.randn((3, 9, 13, 16), generator=g)
    wd, bd = torch.randn((16, 4), generator=g) * 0.25, torch.randn(4, generator=g) * 0.25
    wu, bu = torch.randn((4, 16), generator=g) * 0.5, torch.randn(16, generator=g) * 0.5
    with ref.no_tf32():
        s = ref.channel_attention(y.permute(0, 3, 1, 2), wd, bd, wu, bu)
        want = x + (s * y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = ca.ca_gate_plain(x, y, wd, bd, wu, bu)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # The gate kernel's plain version, from the pooling epilogue's sums.
    out, planes = ca.ca_gate(x, y, ca.pool_sums_plain(y), wd, bd, wu, bu, passes=3)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    assert planes.shape == (2, *x.shape) and planes.dtype == torch.bfloat16
    torch.testing.assert_close(planes[0].float() + planes[1].float(), out, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w", [(16, 16), (37, 21), (8, 40)])
def test_pool_sums_follow_the_epilogue_layout(h, w):
    """Row ((tile * 2 + rank) * 4 + warp) sums rows 16 ty + 8 rank + warp
    and + 4, columns 16 tx .. 16 tx + 15 of its tile, inside the image."""
    y = torch.randn((2, h, w, 8), generator=torch.Generator().manual_seed(h * w),
                    dtype=torch.float64)
    got = ca.pool_sums_plain(y)
    tx = -(-w // 16)
    assert got.shape == (2, ca.pool_rows(h, w), 8) == (2, -(-h // 16) * tx * 8, 8)
    for row in range(got.shape[1]):
        tile, rest = divmod(row, 8)
        rank, warp = divmod(rest, 4)
        ty, tx_i = divmod(tile, tx)
        rows = [r for r in (16 * ty + 8 * rank + warp, 16 * ty + 8 * rank + 4 + warp) if r < h]
        want = y[:, rows, 16 * tx_i:16 * tx_i + 16].sum(dim=(1, 2))
        torch.testing.assert_close(got[:, row].double(), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.sum(1).double(), y.sum((1, 2)), rtol=1e-5, atol=1e-5)


def test_body_plain_versions_agree():
    """rcan_body's plain version (the kernels' arithmetic) against the class
    conv body with the plain gate, at passes 3 and "high"."""
    tp = params_to_torch(_params(), "cpu")
    x = torch.randn((2, 20, 24, 16), generator=torch.Generator().manual_seed(3))
    kern = ca.rcan_body(x, tp, passes=3)
    plain = rcan._body(x, tp, "high")
    assert _rel(kern, plain) <= 1e-5


def test_pool_is_per_patch():
    """A patch's output does not depend on the other patches of its batch:
    the attention pools over each image alone."""
    tp = params_to_torch(_params(), "cpu")
    a, b = _inputs(n=2, seed=5), _inputs(n=2, seed=6)
    alone = rcan.apply(tp, [t[:1] for t in a], CFG, precision="highest")
    mixed = rcan.apply(tp, [torch.cat((t[:1], u[1:])) for t, u in zip(a, b)], CFG,
                       precision="highest")
    torch.testing.assert_close(mixed[:1], alone, rtol=1e-6, atol=1e-6)
    other = rcan.apply(tp, [torch.cat((t[:1], u[:1] * 5)) for t, u in zip(a, b)], CFG,
                       precision="highest")
    torch.testing.assert_close(other[:1], alone, rtol=1e-6, atol=1e-6)


def test_activations_stay_finite_and_order_one_over_200_blocks():
    """Published widths and initialisation: after 10 groups of 20 RCABs
    the body's output is finite and of the inputs' scale."""
    cfg = rcan.rcan_2x()
    tp = params_to_torch(_params(cfg), "cpu")
    g = torch.Generator().manual_seed(2)
    xs = [torch.rand((1, 16, 16, c), generator=g) * 2 for c in cfg.in_channels]
    from dsen2_tpu_torch.ops.conv import conv3x3

    f0 = conv3x3(torch.cat(xs, -1), tp["head"]["w"], tp["head"]["b"], "highest")
    body = rcan._body(f0, tp, "highest")
    assert torch.isfinite(body).all()
    ratio = float(body.std() / f0.std())
    assert 0.2 < ratio < 5.0, ratio
    out = rcan.apply(tp, xs, cfg, precision="highest")
    assert torch.isfinite(out).all() and float(out.abs().max()) < 50


def test_reference_copies_agree():
    """perfbench/reference/rcan.py, the benchmark's copy, equals this one."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perfbench", "reference", "rcan.py")
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read())
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"dsen2_tpu_torch", "dsen2_tpu", "jax"}, tops
    spec = importlib.util.spec_from_file_location("perfbench_rcan_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    net = {"in_channels": [4, 6], "n_resgroups": 2, "n_resblocks": 3, "n_feats": 16,
           "reduction": 4}
    flat = mod.seeded(torch.Generator().manual_seed(4), net, "cpu")
    nested = {}
    for k, v in flat.items():
        top, name = k.split(".")
        nested.setdefault(top, {})[name] = v
    xs = _inputs(seed=8)
    with ref.no_tf32():
        a = mod.forward(flat, [x.permute(0, 3, 1, 2) for x in xs])
    torch.testing.assert_close(a.permute(0, 2, 3, 1), _reference(nested, xs), rtol=0, atol=0)


def test_rcan_body_rejects_what_the_kernels_cannot_take():
    tp = params_to_torch(_params(), "cpu")
    with pytest.raises(ValueError, match="float32"):
        ca.rcan_body(torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16), tp, passes=1)
    with pytest.raises(ValueError, match="passes"):
        ca.rcan_body(torch.zeros((1, 8, 8, 16)), tp, passes=2)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_kernels_with_bf16_activations_raise(precision):
    """With the kernels on, a bf16 compute_dtype raises rather than running
    the body as plain convs; with them off it runs."""
    tp = {top: {k: v.bfloat16() for k, v in sub.items()}
          for top, sub in params_to_torch(_params(), "cpu").items()}
    xs = [x.bfloat16() for x in _inputs()]
    with pytest.raises(ValueError, match="float32 activations"):
        rcan.apply(tp, xs, CFG, precision=precision, use_kernels=True)
    rasters = _scene(4, 48, 48)
    icfg = InferConfig(precision=precision, compute_dtype="bfloat16", use_kernels=True, **KW)
    with pytest.raises(ValueError, match="float32 activations"):
        api.dsen2_20(*rasters, params=_params(), infer_cfg=icfg, device="cpu", model=CFG)
    out = rcan.apply(tp, xs, CFG, precision=precision, use_kernels=False)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_mesh_and_ensemble_take_rcan():
    """The sharded route (a mesh of two CPU devices) equals the one-shot
    one; the ensemble is the mean of the 8 dihedral transforms' runs."""
    from dsen2_tpu_torch.ops.dihedral import dihedral_np, inverse_code
    from dsen2_tpu_torch.parallel import make_mesh

    rasters = _scene(6, 72, 56)
    params = _params(seed=3)
    icfg = InferConfig(precision="highest", **KW)
    one = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    mesh = make_mesh([torch.device("cpu")] * 2)
    sharded = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, mesh=mesh, model=CFG)
    np.testing.assert_allclose(sharded, one, rtol=0, atol=1e-5 * np.abs(one).max())
    ens = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG,
                       ensemble=True)
    runs = [dihedral_np(api.dsen2_20(*(dihedral_np(r, code) for r in rasters), params=params,
                                     infer_cfg=icfg, device="cpu", model=CFG),
                        inverse_code[code]) for code in range(8)]
    np.testing.assert_allclose(ens, np.mean(runs, axis=0), rtol=0, atol=1e-5 * np.abs(one).max())
