"""The port's class conv (ops/conv.py) and s2net at each accuracy class, on
the CPU: forward and gradients against JAX's conv and jax.grad at HIGHEST,
and the bf16x3 / one-pass formulas computed in float64."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dsen2_tpu.core.config import ModelConfig as JModelConfig
from dsen2_tpu.models import s2net as js2net
from dsen2_tpu_torch.core import device
from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import head_tail
from dsen2_tpu_torch.ops.conv import conv3x3
from dsen2_tpu_torch.weights import params_to_torch

# The classes against true f32, as a fraction of max|reference|
# (chip_smoke.py's KERNEL_TOL for one conv).
CLASS_TOL = {"highest": 1e-5, "high": 1e-4, "default": 1e-2}
# A whole net's output against true f32 (chip_smoke.py's E2E_TOL).
NET_TOL = {"high": 2e-4, "default": 1e-2}
# (C_in, C_out): the 2x head, a block, the 2x and 6x tails.
SHAPES = [(10, 16), (16, 16), (16, 6), (16, 2)]


def _case(rng, cin, cout, b=2, h=12, w=10):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, bias, g


def _port(x, wt, bias, g, precision):
    """y and (dx, dw, db) of conv3x3 for the output gradient g."""
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wt, bias))
    y = conv3x3(tx, tw, tb, precision)
    grads = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    return [y.detach().numpy()] + [a.numpy() for a in grads]


def _jax(x, wt, bias, g):
    """The same from XLA's conv at HIGHEST and jax.vjp."""
    def f(x, w, b):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST) + b

    y, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, wt, bias)))
    return [np.asarray(y)] + [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _split(a: np.ndarray):
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def _formula_f64(x, wt, bias, g, precision):
    """The class's y, dx, dw, db with every product and sum in float64."""
    def conv(a, b):
        return F.conv2d(torch.from_numpy(a).double().permute(0, 3, 1, 2),
                        torch.from_numpy(b).double().permute(3, 2, 0, 1), padding=1)

    def grads(gp, xp, wp):
        tx = torch.from_numpy(xp).double().requires_grad_()
        tw = torch.from_numpy(wp).double().requires_grad_()
        y = F.conv2d(tx.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1), padding=1)
        return [a.numpy() for a in torch.autograd.grad(
            y, (tx, tw), torch.from_numpy(gp).double().permute(0, 3, 1, 2))]

    xh, xl = _split(x)
    wh, wl = _split(wt)
    gh, gl = _split(g)
    if precision == "high":
        y = conv(xh, wh) + conv(xl, wh) + conv(xh, wl)
        a, b, c = grads(gh, xh, wh), grads(gl, xh, wh), grads(gh, xl, wl)
        dx, dw = a[0] + b[0] + c[0], a[1] + b[1] + c[1]
    else:
        y = conv(xh, wh)
        dx, dw = grads(gh, xh, wh)
    y = y.permute(0, 2, 3, 1).numpy() + bias
    return [y, dx, dw, g.astype(np.float64).sum(axis=(0, 1, 2))]


@pytest.mark.parametrize("cin,cout", SHAPES)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_conv_and_grads_track_jax_highest(rng, cin, cout, precision):
    """At "highest" the port is XLA's HIGHEST conv and its VJP (rtol 1e-4);
    at "high" and "default" it stays within the class's tolerance of it
    (XLA on the CPU computes f32 at every precision)."""
    case = _case(rng, cin, cout)
    got, want = _port(*case, precision), _jax(*case)
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert a.shape == b.shape and a.dtype == np.float32, name
        if precision == "highest":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                       err_msg=name)
        else:
            err = np.abs(a - b).max()
            assert err <= CLASS_TOL[precision] * np.abs(b).max(), (name, err)


@pytest.mark.parametrize("cin,cout", SHAPES)
@pytest.mark.parametrize("precision", ["high", "default"])
def test_conv_computes_the_class_formula(rng, cin, cout, precision):
    """Forward and backward equal the class's bf16 products summed in
    float64 (the planes of x, w and the incoming gradient), within f32
    summation error; and they differ from the f32 conv by more than that,
    so the class is really applied."""
    case = _case(rng, cin, cout)
    got = _port(*case, precision)
    want = _formula_f64(*case, precision)
    f32 = _jax(*case)
    for name, a, b, c in zip(("y", "dx", "dw", "db"), got, want, f32):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 2e-6 * scale, name
        if name != "db" and precision == "default":
            assert np.abs(c - b).max() > 1e-4 * scale, name


@pytest.mark.parametrize("precision", ["high", "default"])
def test_wgrad_over_batch_chunks_computes_the_formula(rng, monkeypatch, precision):
    """With one image per wgrad chunk, dw still equals the formula."""
    from dsen2_tpu_torch.ops import conv

    case = _case(rng, 16, 16, b=3)
    monkeypatch.setattr(conv, "_WGRAD_ROWS", 12 * 10)
    got = _port(*case, precision)[2]
    want = _formula_f64(*case, precision)[2]
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_bf16_tensors_take_a_plain_bf16_conv(rng):
    x, wt, bias, _ = _case(rng, 16, 16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    y = conv3x3(tx, torch.from_numpy(wt), torch.from_numpy(bias), "high")
    want = F.conv2d(tx.permute(0, 3, 1, 2), torch.from_numpy(wt).to(torch.bfloat16)
                    .permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1) + \
        torch.from_numpy(bias).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_unknown_precision_raises(rng):
    x, wt, bias, _ = _case(rng, 4, 4)
    with pytest.raises(ValueError, match="precision"):
        conv3x3(*(torch.from_numpy(a) for a in (x, wt, bias)), "fast")


@pytest.mark.parametrize("scope,on", [(device.tf32_disabled, False),
                                      (device.tf32_for_bf16_operands, True)])
def test_tf32_scopes_restore_the_flags(scope, on):
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for start in (True, False):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = start
        with scope():
            assert torch.backends.cudnn.allow_tf32 is on
            assert torch.backends.cuda.matmul.allow_tf32 is on
        assert torch.backends.cudnn.allow_tf32 is start
        assert torch.backends.cuda.matmul.allow_tf32 is start
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _net_case(seed=3):
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
    params = s2net.init_params(torch.Generator().manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    xs = [rng.random((2, 16, 12, c)).astype(np.float32) for c in cfg.in_channels]
    target = rng.random((2, 16, 12, 6)).astype(np.float32)
    return cfg, params, xs, target


def _port_net(cfg, params, xs, target, apply_fn, **kw):
    """apply_fn's output and the MAE loss's parameter gradients."""
    tp = params_to_torch(params, "cpu")
    leaves = s2net.param_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    pred = apply_fn(tp, [torch.from_numpy(x) for x in xs], cfg, **kw)
    grads = torch.autograd.grad(torch.mean(torch.abs(pred - torch.from_numpy(target))), leaves)
    return [pred.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_s2net_apply_tracks_jax_highest(precision):
    """The net's output at each class against JAX's at HIGHEST (rtol 1e-4
    at "highest", NET_TOL otherwise), and at "highest" the MAE loss's
    parameter gradients against jax.grad (rtol 1e-4)."""
    cfg, params, xs, target = _net_case()
    got = _port_net(cfg, params, xs, target, s2net.apply, precision=precision)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))

    def loss(p):
        out = js2net.apply(p, [jnp.asarray(x) for x in xs], jcfg, precision="highest")
        return jnp.mean(jnp.abs(out - target)), out

    (_, jpred), jg = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = [np.asarray(jpred)] + [np.asarray(jg[top][name]) for top, name in s2net.PARAM_NAMES]
    if precision != "highest":
        err = np.abs(got[0] - want[0]).max()
        assert err <= NET_TOL[precision] * np.abs(want[0]).max(), err
        return
    for (top, name), a, b in zip([("out", "")] + list(s2net.PARAM_NAMES), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"{top}.{name}")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_s2net_apply_runs_every_conv_at_the_class(precision, remat):
    """Output and gradients of s2net.apply equal, bit for bit, those of the
    net written out with conv3x3 at the class for the head, every block
    conv and the tail (conv3x3's own formula is held above); remat
    recomputes the same."""
    def written_out(params, inputs, cfg, precision):
        blk = params["blocks"]
        x = torch.relu(conv3x3(torch.cat(inputs, -1), params["head"]["w"],
                               params["head"]["b"], precision))
        for k in range(cfg.num_layers):
            t = torch.relu(conv3x3(x, blk["w1"][k], blk["b1"][k], precision))
            x = x + cfg.residual_scale * conv3x3(t, blk["w2"][k], blk["b2"][k], precision)
        return conv3x3(x, params["tail"]["w"], params["tail"]["b"], precision) + inputs[-1]

    case = _net_case()
    got = _port_net(*case, s2net.apply, precision=precision, remat=remat)
    want = _port_net(*case, written_out, precision=precision)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


class _PlanesMadeAgain(torch.autograd.Function):
    """The class conv keeping x and w, whose backward makes their planes
    again from them: the reference for the planes the forward keeps."""

    @staticmethod
    def forward(ctx, x, w, b, precision):
        from dsen2_tpu_torch.ops import conv

        ctx.precision = precision
        ctx.save_for_backward(x, w)
        planes = None if precision == "highest" else conv._operand_planes(x, w, precision)
        return conv._forward(x, w, b, precision, planes)

    @staticmethod
    def backward(ctx, g):
        from dsen2_tpu_torch.ops import conv

        x, w = ctx.saved_tensors
        prec = ctx.precision
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        saved = (x, w) if prec == "highest" else conv._operand_planes(x, w, prec)
        dx, dw = conv._backward(g, saved, prec, need_x, need_w)
        return dx, dw, g.sum(dim=(0, 1, 2)) if need_b else None, None


def _kept_and_remade(case, precision, w_grad=True):
    """y and (dx, dw, db) for the output gradient g, once from conv3x3,
    which keeps the forward's planes, and once from _PlanesMadeAgain, with
    conv.planes_kept's increase in each."""
    from dsen2_tpu_torch.utils import profiling

    x, wt, bias, g = case
    runs = []
    for apply in (lambda *a: conv3x3(*a, precision),
                  lambda *a: _PlanesMadeAgain.apply(*a, precision)):
        tx, tw, tb = (torch.from_numpy(a) for a in (x, wt, bias))
        tx.requires_grad_()
        tw.requires_grad_(w_grad)
        tb.requires_grad_()
        kept = profiling.counters().get("conv.planes_kept", 0)
        y = apply(tx, tw, tb)
        leaves = (tx, tw, tb) if w_grad else (tx, tb)
        grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
        runs.append(([y.detach()] + list(grads),
                     profiling.counters().get("conv.planes_kept", 0) - kept))
    return runs


@pytest.mark.parametrize("cin,cout", SHAPES)
@pytest.mark.parametrize("precision", ["high", "default"])
def test_kept_planes_give_the_grads_of_planes_made_again(rng, cin, cout, precision):
    """The backward that takes the forward's planes gives y, dx, dw and db
    bit-equal to one that splits x and w again, and counts one
    conv.planes_kept."""
    (kept, n_kept), (remade, n_remade) = _kept_and_remade(_case(rng, cin, cout), precision)
    for a, b in zip(kept, remade):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (n_kept, n_remade) == (1, 0)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_planes_kept_only_where_w_needs_its_gradient(rng, precision):
    """With w frozen (at "highest" with w's gradient wanted), y, dx and db
    are those of planes made again; at "high" and "default" the backward
    still takes the forward's planes, at "highest" x and w."""
    (kept, n_kept), (remade, n_remade) = _kept_and_remade(
        _case(rng, 16, 16), precision, w_grad=precision == "highest")
    for a, b in zip(kept, remade):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (n_kept, n_remade) == (int(precision != "highest"), 0)


@pytest.mark.parametrize("precision,grad_mode", [
    ("high", True), ("default", True), ("highest", True), ("high", False)])
def test_forward_saves_the_planes_or_x_and_w(rng, precision, grad_mode):
    """What the forward saves for the backward: at "high" x's and w's two
    planes (x's low plane only while w's gradient is wanted), at "default"
    their one plane, at "highest" x and w; under no_grad nothing."""
    from dsen2_tpu_torch.ops import conv

    x, wt, bias, _ = (torch.from_numpy(a) for a in _case(rng, 10, 16))
    x.requires_grad_()
    for w_grad in (True, False):
        wt.requires_grad_(w_grad)
        packed = []

        def pack(t):
            packed.append(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                torch.set_grad_enabled(grad_mode):
            conv3x3(x, wt, bias, precision)
        if not grad_mode:
            want = []
        elif precision == "highest":
            want = [x, wt]
        else:
            xh, xl = conv._plain_planes(conv._nchw(x), precision)
            want = [xh, xl if w_grad else None,
                    *conv._plain_planes(conv._oihw(wt), precision)]
            want = [t for t in want if t is not None]
        assert len(packed) == len(want), w_grad
        for a, b in zip(packed, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_s2net_grads_with_kept_planes_equal_planes_made_again(precision, remat, monkeypatch):
    """s2net's output and parameter gradients, with every conv keeping its
    planes for the backward, are bit-equal to those of the net whose convs
    make them again (_PlanesMadeAgain), with and without remat; every conv
    of the step counts one conv.planes_kept, and a no_grad forward none."""
    from dsen2_tpu_torch.utils import profiling

    case = _net_case()
    cfg = case[0]
    n_convs = 2 + 2 * cfg.num_layers

    def kept():
        return profiling.counters().get("conv.planes_kept", 0)

    before = kept()
    got = _port_net(*case, s2net.apply, precision=precision, remat=remat)
    assert kept() - before == n_convs
    before = kept()
    with torch.no_grad():
        s2net.apply(params_to_torch(case[1], "cpu"), [torch.from_numpy(x) for x in case[2]],
                    cfg, precision=precision)
    assert kept() == before
    # The blocks' convs are s2net's, the head's and the tail's head_tail's.
    for module in (s2net, head_tail):
        monkeypatch.setattr(module, "conv3x3",
                            lambda x, w, b, p: _PlanesMadeAgain.apply(x, w, b, p))
    want = _port_net(*case, s2net.apply, precision=precision, remat=remat)
    assert kept() == before
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_plane_pass_is_not_taken_on_the_cpu(rng):
    """CPU tensors take the plain split: conv.plane_passes does not move."""
    from dsen2_tpu_torch.ops import conv
    from dsen2_tpu_torch.utils import profiling

    before = profiling.counters().get("conv.plane_passes", 0)
    v = torch.from_numpy(_case(rng, 16, 16)[0])
    for prec in ("high", "default"):
        for a, b in zip(conv._planes(conv._nchw(v), prec), conv._plain_planes(conv._nchw(v), prec)):
            assert (a is None and b is None) or torch.equal(a, b)
    assert profiling.counters().get("conv.plane_passes", 0) == before


@pytest.mark.parametrize("make,dense", [
    (lambda t: t, True), (lambda t: t.permute(0, 3, 1, 2), True),
    (lambda t: t[:, :, :, :3], False), (lambda t: t[:, ::2], False),
    (lambda t: t[1:], True), (lambda t: t[..., :1].permute(0, 3, 1, 2), False)])
def test_dense_tells_a_dense_layout(make, dense):
    from dsen2_tpu_torch.ops import conv

    assert conv._dense(make(torch.zeros(3, 4, 5, 6))) is dense
