"""The port's resampling and tiling against dsen2_tpu's, the TF32 scope, the
device rule and the kernels' weight packing, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsen2_tpu.ops import resize as jresize
from dsen2_tpu.ops import tiling as jtiling
from dsen2_tpu_torch.core.device import resolve_device, tf32_disabled
from dsen2_tpu_torch.ops import resblock_chain
from dsen2_tpu_torch.ops import resize as tresize
from dsen2_tpu_torch.ops import tiling as ttiling


@pytest.mark.parametrize("shape,out_hw", [((3, 8, 8, 6), (16, 16)), ((2, 4, 4, 2), (24, 24)),
                                          ((1, 16, 16, 6), (32, 32))])
def test_upsample_patches_matches(rng, shape, out_hw):
    x = (rng.random(shape) * 9000).astype(np.float32)
    want = np.asarray(jresize.upsample_patches(jnp.asarray(x), out_hw))
    got = tresize.upsample_patches(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_resize_bilinear_matches(rng):
    x = rng.standard_normal((10, 14, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), (20, 7)))
    got = tresize.resize_bilinear(torch.from_numpy(x), (20, 7)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hw,pad", [((7, 9), 2), ((5, 5), 5), ((3, 4), 7), ((6, 1), 1)])
def test_symmetric_pad_equals_numpy(rng, hw, pad):
    img = rng.standard_normal((*hw, 3)).astype(np.float32)
    want = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="symmetric")
    np.testing.assert_array_equal(ttiling.pad_symmetric(torch.from_numpy(img), pad).numpy(), want)


@pytest.mark.parametrize("geom", [(20, 18, 16, 2), (24, 30, 12, 3), (9, 9, 9, 0)])
def test_extract_patches_equal(rng, geom):
    h, w = geom[:2]
    img = rng.standard_normal((h, w, 4)).astype(np.float32)
    want = np.asarray(jtiling.extract_patches(jnp.asarray(img), jtiling.PatchGrid(*geom)))
    got = ttiling.extract_patches(torch.from_numpy(img), ttiling.PatchGrid(*geom)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw,interior", [((100, 90), 24), ((48, 48), 48), ((13, 40), 7)])
def test_recompose_positions_equal(out_hw, interior):
    np.testing.assert_array_equal(ttiling.recompose_positions(out_hw, interior),
                                  jtiling.recompose_positions(out_hw, interior))


def test_mosaic_last_write_wins_like_reference(rng):
    """Edge-flush patches overlap; written in order, each later patch wins,
    exactly as dsen2_tpu.ops.tiling.recompose does."""
    h, w, p, b = 30, 26, 16, 3
    n = len(jtiling.recompose_positions((h, w), p - 2 * b))
    patches = rng.standard_normal((n, p, p, 2)).astype(np.float32)
    want = np.asarray(jtiling.recompose(jnp.asarray(patches), b, (h, w)))
    mosaic = torch.zeros((h, w, 2))
    interiors = torch.from_numpy(patches[:, b : p - b, b : p - b])
    ttiling.write_interiors(mosaic, interiors, ttiling.recompose_positions((h, w), p - 2 * b))
    np.testing.assert_array_equal(mosaic.numpy(), want)


@pytest.mark.parametrize("conv,mm", [(True, True), (True, False), (False, True), (False, False)])
def test_tf32_scope_restores_flags(conv, mm):
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
        with tf32_disabled():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (conv, mm)
        with pytest.raises(KeyError):
            with tf32_disabled():
                raise KeyError("inside")
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (conv, mm)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


@pytest.mark.parametrize("c", [128, 256])
def test_weight_packing_follows_mma_fragment_layout(rng, c):
    """The wgmma B operand: for output half nh, input chunk kc, tap and
    plane, a [128 n, 64 k] K-major tile with 16-byte group k // 8 of row n
    stored at group (k // 8) ^ (n % 8). Spot-check entries, and that hi + lo
    carries every weight."""
    w = torch.from_numpy(rng.standard_normal((3, 3, c, c)).astype(np.float32))
    packed = resblock_chain.pack_weights(w, passes=3)
    assert packed.shape == (c // 128, c // 64, 9, 2, 128, 64)
    assert packed.dtype == torch.bfloat16
    whi = w.to(torch.bfloat16).reshape(9, c, c)
    for tap, k, n in [(0, 0, 0), (4, 77, 13), (8, c - 1, c - 1), (2, 9, 130 % c)]:
        nh, nn, kc, kk = n // 128, n % 128, k // 64, k % 64
        col = ((kk // 8) ^ (nn % 8)) * 8 + kk % 8
        assert packed[nh, kc, tap, 0, nn, col] == whi[tap, k, n]
    hi, lo = packed[:, :, :, 0], packed[:, :, :, 1]
    # hi + lo carries every weight to ~2^-16 relative: compare sorted values
    np.testing.assert_allclose(np.sort((hi.float() + lo.float()).numpy().ravel()),
                               np.sort(w.numpy().ravel()), rtol=2 ** -14, atol=0)
    only_hi = resblock_chain.pack_weights(w, passes=1)
    assert torch.equal(only_hi[:, :, :, 0], hi)
