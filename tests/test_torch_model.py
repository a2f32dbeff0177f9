"""The port's s2net against dsen2_tpu's on the CPU, and its routing of the
residual blocks for tensors on a GPU (with the CUDA launcher replaced)."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsen2_tpu.core.config import ModelConfig as JModelConfig
from dsen2_tpu.models import s2net as js2net
from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import head_tail, resblock, resblock_chain
from dsen2_tpu_torch.weights import params_to_torch


def _inputs(rng, cfg, b=2, h=16, w=12):
    return [rng.random((b, h, w, c)).astype(np.float32) for c in cfg.in_channels]


@pytest.mark.parametrize("cfg", [
    ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=128),
    ModelConfig(in_channels=(4, 6, 2), num_layers=3, feature_size=256),
], ids=["dsen2_width", "vdsen2_width"])
def test_apply_matches_jax_highest(rng, cfg):
    params = s2net.init_params(torch.Generator().manual_seed(11), cfg)
    xs = _inputs(rng, cfg)
    want = np.asarray(js2net.apply(
        jax.tree_util.tree_map(jnp.asarray, params), [jnp.asarray(x) for x in xs],
        JModelConfig(**dataclasses.asdict(cfg)), precision="highest"))
    got = s2net.apply(params_to_torch(params, "cpu"), [torch.from_numpy(x) for x in xs], cfg,
                      precision="highest").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_init_params_layout_and_counts():
    cfg = ModelConfig(in_channels=(4, 6, 2), num_layers=3, feature_size=32)
    p = s2net.init_params(torch.Generator().manual_seed(0), cfg)
    j = js2net.init_params(jax.random.PRNGKey(0), JModelConfig(**dataclasses.asdict(cfg)))
    for top in j:
        for name in j[top]:
            assert p[top][name].shape == j[top][name].shape, (top, name)
            assert p[top][name].dtype == np.float32
    assert s2net.param_count(p) == js2net.param_count(j)
    limit = np.sqrt(6.0 / (9 * 12))
    assert np.abs(p["head"]["w"]).max() <= limit and np.abs(p["head"]["w"]).std() > limit / 4
    q = s2net.init_params(torch.Generator().manual_seed(0), cfg)
    np.testing.assert_array_equal(p["tail"]["w"], q["tail"]["w"])


def test_rejects_unknown_precision(rng):
    cfg = ModelConfig(num_layers=0, feature_size=8)
    params = params_to_torch(s2net.init_params(torch.Generator(), cfg), "cpu")
    with pytest.raises(ValueError, match="precision"):
        s2net.apply(params, [torch.from_numpy(x) for x in _inputs(rng, cfg)], cfg,
                    precision="fast")


@pytest.fixture
def edge_launches(monkeypatch):
    """Replace the head and tail kernels' launchers with recorders: one
    ("head", passes, planes asked) or ("tail", passes) entry per launch."""
    calls = []

    def fake_head(inputs, w, b, passes, planes):
        calls.append(("head", passes, planes))
        x = torch.empty((*inputs[0].shape[:3], w.shape[-1]), device=inputs[0].device)
        return x, (torch.empty((2 if passes == 3 else 1, *x.shape), dtype=torch.bfloat16,
                               device=x.device) if planes else None)

    def fake_tail(x, w, b, residual, passes):
        calls.append(("tail", passes))
        return torch.empty_like(residual)

    monkeypatch.setattr(head_tail, "launch_head", fake_head)
    monkeypatch.setattr(head_tail, "launch_tail", fake_tail)
    return calls


@pytest.fixture
def launches(monkeypatch, edge_launches):
    """Replace the CUDA launchers with recorders, so a call on a non-CPU
    ("meta") tensor shows which kernel entry the routing reached: one entry
    per residual block, with its passes (the head's and tail's in
    edge_launches)."""
    calls = []

    def fake(x, w1, b1, w2, b2, scale, passes, planes=None):
        calls.extend([passes] * w1.shape[0])
        return torch.empty_like(x)

    monkeypatch.setattr(resblock_chain, "launch_blocks", fake)
    monkeypatch.setattr(resblock, "launch_blocks", fake)
    return calls


def _meta_apply(cfg, h, precision, use_kernels=None):
    params = {top: {k: torch.as_tensor(v).to("meta") for k, v in sub.items()}
              for top, sub in s2net.init_params(torch.Generator(), cfg).items()}
    xs = [torch.empty((2, h, 12, c), device="meta") for c in cfg.in_channels]
    return s2net.apply(params, xs, cfg, precision=precision, use_kernels=use_kernels)


@pytest.mark.parametrize("layers", [1, 2, 3, 6])
@pytest.mark.parametrize("h", [16, 24, 12, 13, 132])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_gpu_routing_always_reaches_a_kernel(launches, layers, h, precision):
    cfg = ModelConfig(in_channels=(4, 6), num_layers=layers, feature_size=32)
    chain0, block0 = resblock_chain.fused_resblock_chain.launches, resblock.fused_resblock.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = _meta_apply(cfg, h, precision)
    assert out.shape == (2, h, 12, 6)
    assert launches == [3 if precision == "high" else 1] * layers
    chain = resblock_chain.fused_resblock_chain.launches - chain0
    block = resblock.fused_resblock.launches - block0
    # The JAX package's chain route (even block count, 8 | H), and bf16x3
    # always, go to B1; the rest of "default" goes to B2.
    takes_chain = precision == "high" or (layers % 2 == 0 and h % 8 == 0)
    assert (chain, block) == ((layers, 0) if takes_chain else (0, layers))


def test_gpu_highest_warns_and_runs_plain_convs(launches):
    """Asked for kernels at "highest", the model warns and runs plain convs;
    AUTO resolves to plain convs at "highest" without a word, as
    dsen2_tpu's resolve_use_pallas does."""
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=32)
    with pytest.warns(UserWarning, match="no true-f32 path"):
        out = _meta_apply(cfg, 16, "highest", use_kernels=True)
    assert out.shape == (2, 16, 12, 6) and launches == []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _meta_apply(cfg, 16, "highest", use_kernels=None)
    assert launches == []


def test_use_kernels_false_runs_plain_convs_on_gpu(launches, edge_launches):
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=32)
    _meta_apply(cfg, 16, "high", use_kernels=False)
    assert launches == [] and edge_launches == []


@pytest.mark.parametrize("layers,h", [(2, 16), (3, 13), (6, 132)])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_gpu_kernel_route_runs_the_head_and_tail_kernels(launches, edge_launches, layers, h,
                                                         precision):
    """On the kernel route with f32 activations one head and one tail launch
    run per call; the head writes B1's planes where B1 runs the blocks, and
    none on B2's route."""
    cfg = ModelConfig(in_channels=(4, 6, 2), num_layers=layers, feature_size=128)
    out = _meta_apply(cfg, h, precision)
    assert out.shape == (2, h, 12, cfg.out_channels)
    passes = 3 if precision == "high" else 1
    chain = precision == "high" or (layers % 2 == 0 and h % 8 == 0)
    assert edge_launches == [("head", passes, chain), ("tail", passes)]


@pytest.mark.parametrize("features", [32, 64])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_gpu_kernel_route_keeps_the_class_conv_head_and_tail_at_other_widths(
        launches, edge_launches, features, precision):
    """The head and tail kernels take 128 and 256 features; at other widths
    the blocks still run on the kernels and the head and tail on the class
    conv."""
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=features)
    out = _meta_apply(cfg, 16, precision)
    assert out.shape == (2, 16, 12, cfg.out_channels)
    assert edge_launches == [] and launches == [3 if precision == "high" else 1] * 2


def test_gpu_highest_and_bf16_keep_the_class_conv_head_and_tail(launches, edge_launches):
    """"highest" and bf16 activations take no head or tail kernel."""
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=128)
    with pytest.warns(UserWarning, match="no true-f32 path"):
        _meta_apply(cfg, 16, "highest", use_kernels=True)
    params = {top: {k: torch.as_tensor(v).to("meta", torch.bfloat16) for k, v in sub.items()}
              for top, sub in s2net.init_params(torch.Generator(), cfg).items()}
    xs = [torch.empty((2, 16, 12, c), device="meta", dtype=torch.bfloat16)
          for c in cfg.in_channels]
    s2net.apply(params, xs, cfg, precision="default", use_kernels=True)
    assert edge_launches == [] and launches == [1, 1]


def test_cpu_auto_runs_plain_version_without_warning(rng):
    cfg = ModelConfig(in_channels=(4, 6), num_layers=2, feature_size=16)
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(1), cfg), "cpu")
    xs = [torch.from_numpy(x) for x in _inputs(rng, cfg)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a = s2net.apply(params, xs, cfg, precision="highest", use_kernels=None)
        b = s2net.apply(params, xs, cfg, precision="high", use_kernels=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=5e-4 * a.abs().max().item())
