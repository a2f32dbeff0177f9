"""The port's HAT (models/hat.py, ops/window_attention.py, ops/linear.py)
against the plain reference tests/hat_reference.py, on the CPU, at a small
size unless a test says otherwise: 12 features, 2 heads, window 4 (M_o =
6), 2 RHAGs x 2 HABs (so shifted and unshifted blocks both run), patches of
16 x 16.

Tolerances, as shares of max|reference|:
  - "highest": 1e-5. Both are float32 with TF32 off; only the order of the
    sums differs (the reference projects each window, the port the image).
  - "high": 5e-5. bf16x3 keeps about 16 significant bits of each operand of
    every conv, linear and attention product (the lo*lo product is dropped),
    so each strays by about 2^-16 of its inputs' scale; the measured gap
    here is 4.0e-6.
  - "default": 1e-2. One bf16 pass keeps 8 bits of each operand (2^-9
    relative); the measured gap here is 2.0e-3, and it must exceed the
    "high" tolerance (test_default_reading_fails_the_high_tolerance).
"""

import numpy as np
import pytest
import torch

import hat_reference as ref
from dsen2_tpu_torch.core.config import InferConfig
from dsen2_tpu_torch.infer import api, engine
from dsen2_tpu_torch.models import hat
from dsen2_tpu_torch.ops import window_attention as wa
from dsen2_tpu_torch.ops.linear import linear
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import params_to_torch

CFG = hat.HATConfig(embed_dim=12, groups=2, blocks=2, heads=2, window=4, squeeze_factor=4)
TOL = {"highest": 1e-5, "high": 5e-5, "default": 1e-2}
KW = dict(patch_size=16, border=2, batch_size=4)


def _params(cfg=CFG, seed=0):
    return hat.init_params(torch.Generator().manual_seed(seed), cfg)


def _inputs(n=2, hw=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n, hw, hw, c), generator=g) * 3 for c in CFG.in_channels]


def _reference(tp, xs, cfg=CFG):
    with ref.no_tf32():
        out = ref.forward(tp, [x.permute(0, 3, 1, 2) for x in xs], heads=cfg.heads,
                          window=cfg.window, overlap=cfg.overlap_window,
                          conv_scale=cfg.conv_scale)
    return out.permute(0, 2, 3, 1)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_param_count_at_published_widths():
    cfg = hat.hat_2x()
    assert (cfg.embed_dim, cfg.heads, cfg.window, cfg.overlap_window, cfg.hidden) == (
        180, 6, 16, 24, 360)
    assert hat.param_count(cfg) == 20_392_674


def test_param_count_is_the_drawn_parameters():
    p = _params()
    assert hat.param_count(CFG) == sum(v.size for sub in p.values() for v in sub.values())
    assert p["hab"]["rpb"].shape == (2, 2, 49, 2) and p["ocab"]["rpb"].shape == (2, 81, 2)
    # Every leaf drawn, biases and LayerNorm affines included: none is constant.
    assert all(np.ptp(v) > 0 for sub in p.values() for v in sub.values())


@pytest.mark.parametrize("use_kernels", [None, True])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_apply_matches_reference(precision, use_kernels):
    """Plain attention at the class (use_kernels None on the CPU), and the
    kernel's wrapper, which runs the same plain version on a CPU tensor
    (use_kernels True)."""
    tp = params_to_torch(_params(), "cpu")
    xs = _inputs()
    if precision == "highest" and use_kernels:
        with pytest.warns(UserWarning, match="no true-f32 path"):
            got = hat.apply(tp, xs, CFG, precision=precision, use_kernels=use_kernels)
    else:
        got = hat.apply(tp, xs, CFG, precision=precision, use_kernels=use_kernels)
    assert got.shape == (2, 16, 16, 6)
    assert _rel(got, _reference(tp, xs)) <= TOL[precision]


def test_default_reading_fails_the_high_tolerance():
    tp = params_to_torch(_params(), "cpu")
    xs = _inputs()
    want = _reference(tp, xs)
    high = _rel(hat.apply(tp, xs, CFG, precision="high", use_kernels=None), want)
    default = _rel(hat.apply(tp, xs, CFG, precision="default", use_kernels=None), want)
    assert high <= TOL["high"] < default


def test_body_counts_blocks_and_spans():
    tp = params_to_torch(_params(), "cpu")
    before = profiling.counters()
    with profiling.spans_on():
        hat.apply(tp, _inputs(n=1), CFG, precision="highest")
        spans = profiling.take_spans()
    after = profiling.counters()
    assert after.get("hat.blocks", 0) - before.get("hat.blocks", 0) == 4
    assert after.get("hat.ocabs", 0) - before.get("hat.ocabs", 0) == 2
    names = [s.name for s in spans]
    assert names.count("hat.rhag") == 2 and names.count("s2net.hat") == 1


def _block_params(seed=5, cfg=CFG):
    """The first HAB's and the first OCAB's leaves, as tensors."""
    tp = params_to_torch(_params(cfg, seed), "cpu")
    return ({k: v[0, 0] for k, v in tp["hab"].items()}, {k: v[0] for k, v in tp["ocab"].items()})


def test_shifted_hab_matches_reference(monkeypatch):
    """One shifted HAB alone on an image of 3 x 2 windows, so that the roll
    wraps and the mask cuts the last window row and column."""
    hp, _ = _block_params()
    x = torch.randn((2, 12, 8, CFG.embed_dim), generator=torch.Generator().manual_seed(2))
    s = CFG.window // 2
    got = hat._hab(x, hp, CFG, s, "highest", False)
    with ref.no_tf32():
        want = ref.hab(x, hp, CFG.heads, CFG.window, s, CFG.conv_scale)
    assert _rel(got, want) <= 1e-5
    # The roll and the mask both count: without either the block differs.
    assert _rel(hat._hab(x, hp, CFG, 0, "highest", False), want) > 1e-3
    orig = wa.shift_mask
    monkeypatch.setattr(wa, "shift_mask", lambda *a: orig(*a) * 0)
    assert _rel(hat._hab(x, hp, CFG, s, "highest", False), want) > 1e-3


@pytest.mark.parametrize("precision", ["high", "default"])
def test_shifted_hab_at_the_class(precision):
    hp, _ = _block_params()
    x = torch.randn((1, 8, 12, CFG.embed_dim), generator=torch.Generator().manual_seed(3))
    got = hat._hab(x, hp, CFG, CFG.window // 2, precision, True)
    with ref.no_tf32():
        want = ref.hab(x, hp, CFG.heads, CFG.window, CFG.window // 2, CFG.conv_scale)
    assert _rel(got, want) <= TOL[precision]


def test_ocab_matches_reference():
    _, op = _block_params()
    x = torch.randn((2, 8, 12, CFG.embed_dim), generator=torch.Generator().manual_seed(4))
    got = hat._ocab(x, op, CFG, "highest", False)
    with ref.no_tf32():
        want = ref.ocab(x, op, CFG.heads, CFG.window, CFG.overlap_window)
    assert _rel(got, want) <= 1e-5


def test_ocab_corner_keys_are_zero_vectors_in_the_softmax():
    """At the patch's corner window, the keys outside the image are zero
    vectors: their scores are the bias alone and they stay in the softmax's
    sum (nn.Unfold's padding), and their values add nothing."""
    m, mo, heads = CFG.window, CFG.overlap_window, CFG.heads
    c, d = CFG.embed_dim, CFG.embed_dim // CFG.heads
    g = torch.Generator().manual_seed(6)
    qkv = torch.randn((1, 8, 8, 3 * c), generator=g, dtype=torch.float64)
    table = torch.randn(((m + mo - 1) ** 2, heads), generator=g, dtype=torch.float64)
    got = wa.window_attention_plain(qkv, table, heads=heads, window=m, overlap=mo)
    pad = (mo - m) // 2
    idx = wa.relative_index(m, mo)
    for qy, qx in ((0, 0), (0, 3), (3, 3)):
        for j in range(heads):
            q = qkv[0, qy, qx, j * d:(j + 1) * d] * d ** -0.5
            scores, values, inside = [], [], []
            for ky in range(mo):
                for kx in range(mo):
                    y, x = ky - pad, kx - pad
                    inside.append(0 <= y < 8 and 0 <= x < 8)
                    k = qkv[0, y, x, c + j * d:c + (j + 1) * d] if inside[-1] else torch.zeros(d)
                    v = (qkv[0, y, x, 2 * c + j * d:2 * c + (j + 1) * d] if inside[-1]
                         else torch.zeros(d))
                    scores.append(q @ k.double() + table[idx[qy * m + qx, ky * mo + kx], j])
                    values.append(v.double())
            scores, values = torch.stack(scores), torch.stack(values)
            want = (torch.softmax(scores, 0)[:, None] * values).sum(0)
            out = got[0, qy, qx, j * d:(j + 1) * d]
            torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
            # Masking the outside keys instead of zeroing them is another answer.
            keep = torch.tensor(inside)
            masked = (torch.softmax(scores[keep], 0)[:, None] * values[keep]).sum(0)
            assert (out - masked).abs().max() > 1e-3


@pytest.mark.parametrize("geometry", [dict(shift=0), dict(shift=2), dict(overlap=6)])
@pytest.mark.parametrize("passes", [3, 1])
def test_window_attention_cpu_route_is_the_plain_version_at_the_class(geometry, passes):
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn((2, 8, 12, 36), generator=g)
    n = (2 * 4 - 1) ** 2 if "shift" in geometry else (4 + 6 - 1) ** 2
    table = torch.randn((n, 2), generator=g) * 0.5
    got = wa.window_attention(qkv, table, heads=2, window=4, passes=passes, **geometry)
    want = wa.window_attention_plain(qkv, table, heads=2, window=4, passes=passes, **geometry)
    assert torch.equal(got, want)
    exact = wa.window_attention_plain(qkv.double(), table.double(), heads=2, window=4,
                                      **geometry)
    # bf16x3: about 2^-16 of the operands' scale; one pass: 2^-9.
    assert _rel(got.double(), exact) <= (2e-5 if passes == 3 else 2e-2)


def test_window_attention_plain_chunks_agree(monkeypatch):
    g = torch.Generator().manual_seed(8)
    qkv = torch.randn((5, 8, 8, 24), generator=g)
    table = torch.randn((49, 2), generator=g)
    whole = wa.window_attention_plain(qkv, table, heads=2, window=4, shift=2)
    monkeypatch.setattr(wa, "_CHUNK_SCORES", 1)
    assert torch.equal(wa.window_attention_plain(qkv, table, heads=2, window=4, shift=2), whole)


def test_relative_index_and_mask_by_hand():
    idx = wa.relative_index(2)
    # Queries and keys (0,0),(0,1),(1,0),(1,1); (dy + 1) * 3 + (dx + 1).
    assert idx.tolist() == [[4, 3, 1, 0], [5, 4, 2, 1], [7, 6, 4, 3], [8, 7, 5, 4]]
    o = wa.relative_index(2, 4)
    # Query (0,0), key (0,0): (0 + 1) * 5 + (0 + 1); key (3,3): 4 * 5 + 4.
    assert o[0, 0] == 6 and o[0, 15] == 24 and o[3, 0] == 0
    mask = wa.shift_mask(4, 4, 2, 1)
    # Window 0 lies in band 0 alone; windows 1 and 2 touch the last column
    # or row of windows, window 3 both.
    assert mask[0].abs().max() == 0
    assert mask[1].tolist()[0] == [0.0, -100.0, 0.0, -100.0]
    assert mask[2].tolist()[0] == [0.0, 0.0, -100.0, -100.0]
    assert mask[3].tolist()[0] == [0.0, -100.0, -100.0, -100.0]


def test_window_attention_rejects_what_it_cannot_take():
    qkv = torch.zeros((1, 8, 8, 36))
    with pytest.raises(ValueError, match="passes"):
        wa.window_attention(qkv, torch.zeros((49, 2)), heads=2, window=4, passes=2)
    with pytest.raises(ValueError, match="float32"):
        wa.window_attention(qkv.bfloat16(), torch.zeros((49, 2)), heads=2, window=4, passes=3)
    with pytest.raises(ValueError, match="no shift"):
        wa.window_attention_plain(qkv, torch.zeros((81, 2)), heads=2, window=4, shift=2,
                                  overlap=6)


@pytest.mark.parametrize("precision,tol", [("highest", 1e-6), ("high", 2e-5),
                                           ("default", 1e-2)])
def test_class_linear_against_float64(precision, tol):
    """highest: f32 sums of 180 terms (about 1e-7 of the scale); high: bf16x3
    operands (2^-16); default: one bf16 pass (2^-9). The readings here are
    3.0e-7, 3.2e-6 and 1.5e-3; default must fail high's tolerance."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((3, 5, 7, 180), generator=g)
    w = torch.randn((180, 60), generator=g) * 0.05
    b = torch.randn((60,), generator=g)
    want = x.double() @ w.double() + b.double()
    got = linear(x, w, b, precision)
    assert got.shape == (3, 5, 7, 60) and got.dtype == torch.float32
    gap = _rel(got.double(), want)
    assert gap <= tol
    if precision == "default":
        assert gap > 2e-5


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 4)) * 8000).astype(np.uint16),
            (rng.random((h // 2, w // 2, 6)) * 8000).astype(np.uint16)]


def _reference_net(monkeypatch):
    """The API with hat_reference's net in place of the port's."""
    def apply(params, inputs, cfg, precision, use_kernels):
        return _reference(params, inputs, cfg)

    monkeypatch.setattr(api, "net_apply", lambda cfg: apply)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_dsen2_20_runs_hat_against_reference(precision, monkeypatch):
    rasters = _scene(3, 40, 32)
    params = _params()
    icfg = InferConfig(precision=precision, **KW)
    got = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    assert got.shape == (40, 32, 6) and got.dtype == np.float32
    _reference_net(monkeypatch)
    want = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    gap = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert gap <= TOL[precision]


@pytest.mark.parametrize("rows_per_band", [1, 3])
def test_banded_engine_runs_hat_against_reference(rows_per_band, monkeypatch):
    rasters = _scene(4, 48, 40)
    params = _params(seed=2)
    icfg = InferConfig(precision="highest", **KW)
    got = engine.sr_banded(rasters, 2, CFG, params, icfg, rows_per_band=rows_per_band,
                           device="cpu")
    _reference_net(monkeypatch)
    want = api.dsen2_20(*rasters, params=params, infer_cfg=icfg, device="cpu", model=CFG)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["highest"] * np.abs(want).max())


def test_dsen2_20_needs_params_for_hat():
    with pytest.raises(ValueError, match="no shipped weights"):
        api.dsen2_20(*_scene(5, 32, 32), infer_cfg=InferConfig(**KW), device="cpu", model=CFG)


def test_window_must_divide_the_patch():
    tp = params_to_torch(_params(), "cpu")
    with pytest.raises(ValueError, match="must divide the patch"):
        hat.apply(tp, _inputs(hw=18), CFG)


def test_kernels_reject_bf16_activations():
    """With the kernel on, a bf16 compute_dtype raises; with it off, the
    plain route runs in bf16."""
    tp = params_to_torch(_params(), "cpu", dtype=torch.bfloat16)
    xs = [x.bfloat16() for x in _inputs(n=1)]
    with pytest.raises(ValueError, match="float32 activations"):
        hat.apply(tp, xs, CFG, precision="high", use_kernels=True)
    out = hat.apply(tp, xs, CFG, precision="high", use_kernels=False)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_pool_and_attention_are_per_patch():
    """A patch's output does not depend on the other patches of its batch:
    the channel attention pools over each image alone, and no window
    reaches across images."""
    tp = params_to_torch(_params(), "cpu")
    a, b = _inputs(n=2, seed=5), _inputs(n=2, seed=6)
    alone = hat.apply(tp, [t[:1] for t in a], CFG, precision="highest")
    other = hat.apply(tp, [torch.cat((t[:1], u[:1] * 5)) for t, u in zip(a, b)], CFG,
                      precision="highest")
    torch.testing.assert_close(other[:1], alone, rtol=1e-6, atol=1e-6)


def test_activations_stay_finite_and_order_one_at_published_widths():
    """hat_2x's widths and initialisation: after 6 RHAGs of 6 HABs the
    output is finite and of the inputs' scale."""
    cfg = hat.hat_2x()
    tp = params_to_torch(_params(cfg), "cpu")
    g = torch.Generator().manual_seed(2)
    xs = [torch.rand((1, 16, 16, c), generator=g) * 2 for c in cfg.in_channels]
    out = hat.apply(tp, xs, cfg, precision="highest")
    assert out.shape == (1, 16, 16, 6) and torch.isfinite(out).all()
    assert 0.05 < float((out - xs[-1]).std()) < 50


def test_reference_copies_agree():
    """perfbench/reference/hat.py, the benchmark's copy (flat weights), equals
    this one, and imports nothing of the port."""
    import ast
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perfbench", "reference", "hat.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"dsen2_tpu_torch", "dsen2_tpu", "jax"}, tops
    spec = importlib.util.spec_from_file_location("perfbench_hat_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    net = {"in_channels": [4, 6], "embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2],
           "window_size": 4, "overlap_ratio": 0.5, "mlp_ratio": 2, "compress_ratio": 3,
           "squeeze_factor": 4, "conv_scale": 0.01}
    flat = mod.seeded(torch.Generator().manual_seed(4), net, "cpu")
    nested = {}
    for k, v in flat.items():
        top, name = k.split(".")
        nested.setdefault(top, {})[name] = v
    assert hat.param_count(CFG) == sum(v.numel() for v in flat.values())
    xs = _inputs(seed=8)
    with ref.no_tf32():
        a = mod.forward(flat, [x.permute(0, 3, 1, 2) for x in xs], net)
    torch.testing.assert_close(a.permute(0, 2, 3, 1), _reference(nested, xs), rtol=0, atol=0)


def test_mesh_and_ensemble_take_hat():
    """The sharded route (a mesh of two CPU devices) equals the one-shot
    one; the ensemble is the mean of the 8 dihedral transforms' runs."""
    from dsen2_tpu_torch.ops.dihedral import dihedral_np, inverse_code
    from dsen2_tpu_torch.parallel import make_mesh

    rasters = _scene(6, 40, 32)
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


@pytest.mark.parametrize("precision", ["high", "default"])
def test_api_with_bf16_activations_and_the_kernel_raises(precision):
    icfg = InferConfig(precision=precision, compute_dtype="bfloat16", use_kernels=True, **KW)
    with pytest.raises(ValueError, match="float32 activations"):
        api.dsen2_20(*_scene(4, 32, 32), params=_params(), infer_cfg=icfg, device="cpu",
                     model=CFG)
