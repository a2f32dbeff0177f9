"""Kernels B1 and B2: their plain versions against the Pallas kernels run in
interpret mode, and the wrappers' rules, on the CPU. The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsen2_tpu.ops.pallas.resblock import fused_resblock as j_block
from dsen2_tpu.ops.pallas.resblock_chain import fused_resblock_chain as j_chain
from dsen2_tpu_torch.ops import resblock, resblock_chain


def _params(rng, k, c, dtype=np.float32):
    w1 = (rng.standard_normal((k, 3, 3, c, c)) * 0.1).astype(dtype)
    w2 = (rng.standard_normal((k, 3, 3, c, c)) * 0.1).astype(dtype)
    b1 = (rng.standard_normal((k, c)) * 0.1).astype(dtype)
    b2 = (rng.standard_normal((k, c)) * 0.1).astype(dtype)
    return w1, b1, w2, b2


def _both(x, *ps):
    return [jnp.asarray(a) for a in (x, *ps)], [torch.from_numpy(a) for a in (x, *ps)]


@pytest.mark.parametrize("k,h,w,tile_rows", [(1, 16, 12, 4), (2, 16, 16, 8), (2, 16, 10, 16),
                                             (3, 24, 8, 12)])
@pytest.mark.parametrize("passes", [1, 3])
def test_chain_plain_matches_pallas_interpret(rng, k, h, w, tile_rows, passes):
    c = 8
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    j, t = _both(x, *_params(rng, k, c))
    want = np.asarray(j_chain(*j, tile_rows=tile_rows, interpret=True, passes=passes))
    got = resblock_chain.fused_resblock_chain(*t, passes=passes).numpy()
    if passes == 1:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * np.abs(want).max())


def test_chain_plain_bf16_activations_match_pallas_interpret(rng):
    """bf16 activations: both round the intermediate and the output to bf16;
    allow one bf16 step of the output's magnitude."""
    x = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ps = _params(rng, 2, 8)
    j = [jnp.asarray(x, jnp.bfloat16)] + [jnp.asarray(p, jnp.bfloat16) for p in ps]
    t = [torch.from_numpy(x).to(torch.bfloat16)] + [torch.from_numpy(p).to(torch.bfloat16)
                                                    for p in ps]
    want = np.asarray(j_chain(*j, tile_rows=8, interpret=True), np.float32)
    got = resblock_chain.fused_resblock_chain(*t).float().numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("h,tile_rows", [(16, 4), (16, 16), (12, 2)])
def test_block_plain_matches_pallas_interpret(rng, h, tile_rows):
    c = 16
    x = rng.standard_normal((2, h, 12, c)).astype(np.float32)
    w1, b1, w2, b2 = (p[0] for p in _params(rng, 1, c))
    j, t = _both(x, w1, b1, w2, b2)
    want = np.asarray(j_block(*j, tile_rows=tile_rows, interpret=True))
    got = resblock.fused_resblock(*t, tile_rows=tile_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_block_rejects_tile_rows_one(rng):
    x = torch.zeros((1, 8, 8, 16))
    w, b = torch.zeros((3, 3, 16, 16)), torch.zeros(16)
    with pytest.raises(ValueError, match="tile_rows"):
        resblock.fused_resblock(x, w, b, w, b, tile_rows=1)
    with pytest.raises(ValueError, match="not a multiple"):
        resblock.fused_resblock(x, w, b, w, b, tile_rows=3)


def test_chain_rejects_bf16x3_on_bf16(rng):
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16)
    w, b = torch.zeros((2, 3, 3, 16, 16)), torch.zeros((2, 16))
    with pytest.raises(ValueError, match="passes=3"):
        resblock_chain.fused_resblock_chain(x, w, b, w, b, passes=3)


@pytest.mark.parametrize("bad", ["w_shape", "b_shape", "passes", "dtype", "rank"])
def test_wrapper_checks_arguments(bad):
    x = torch.zeros((1, 8, 8, 16))
    w, b = torch.zeros((2, 3, 3, 16, 16)), torch.zeros((2, 16))
    kw = {"passes": 1}
    if bad == "w_shape":
        w = torch.zeros((2, 3, 3, 16, 8))
    elif bad == "b_shape":
        b = torch.zeros((1, 16))
    elif bad == "passes":
        kw["passes"] = 2
    elif bad == "dtype":
        x = x.double()
    else:
        x = x[0]
    with pytest.raises(ValueError):
        resblock_chain.fused_resblock_chain(x, w, b, w, b, **kw)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 16)).astype(np.float32))
    w1, b1, w2, b2 = (torch.from_numpy(p) for p in _params(rng, 2, 16))
    n_chain, n_block = resblock_chain.fused_resblock_chain.launches, resblock.fused_resblock.launches
    got = resblock_chain.fused_resblock_chain(x, w1, b1, w2, b2, passes=3)
    want = resblock_chain.resblock_chain_plain(x, w1, b1, w2, b2, passes=3)
    assert torch.equal(got, want)
    resblock.fused_resblock(x, w1[0], b1[0], w2[0], b2[0], tile_rows=8)
    assert resblock_chain.fused_resblock_chain.launches == n_chain
    assert resblock.fused_resblock.launches == n_block


def test_non_cuda_devices_raise_rather_than_fall_back():
    """A tensor that is neither on the CPU nor on a GPU reaches the launcher,
    which raises: no path quietly computes elsewhere."""
    x = torch.empty((1, 8, 8, 128), device="meta")
    w, b = torch.empty((1, 3, 3, 128, 128), device="meta"), torch.empty((1, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        resblock_chain.fused_resblock_chain(x, w, b, w, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        resblock.fused_resblock(x, w[0], b[0], w[0], b[0], tile_rows=8)


def test_plain_version_masks_like_same_padding(rng):
    """Zero weights but nonzero biases: the intermediate outside the image
    must be zero, so border outputs see only in-image bias terms; compare
    with a direct per-pixel count of in-image taps."""
    c, h, w = 4, 5, 6
    x = torch.zeros((1, h, w, c))
    z = torch.zeros((3, 3, c, c))
    w2 = torch.zeros((3, 3, c, c))
    w2[:, :, 0, 0] = 1.0  # conv2 sums channel 0 of the intermediate over the 3x3 window
    b1 = torch.zeros(c)
    b1[0] = 1.0  # intermediate channel 0 = relu(b1) = 1 inside the image
    got = resblock.fused_resblock_plain(x, z, b1, w2, torch.zeros(c), scale=1.0)[0, :, :, 0]
    ones = np.pad(np.ones((h, w)), 1)
    taps = sum(ones[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(got.numpy(), taps)


def _walk_schedule(b, h, w, c, clusters):
    """The conv kernel's schedule walked tile by tile (csrc/resblock_chain.cu):
    cluster i of n takes the 16 x 16 x 128 tiles i, i + n, ...; each of its
    two CTAs takes its 8-row half of each, and the CTA's two warpgroups take
    them in turn. A tile's epilogue overlaps when the CTA has a next tile,
    whose mainloop the other warpgroup runs beside it."""
    steps = b * ((h + 15) // 16) * ((w + 15) // 16) * (c // min(c, 128))
    n = min(clusters, steps)
    tiles = overlapped = 0
    for cluster in range(n):
        mine = list(range(cluster, steps, n))
        for _cta in range(2):
            busy = {0: 0, 1: 0}
            for j in range(len(mine)):
                busy[j % 2] += 1
                tiles += 1
                overlapped += j + 1 < len(mine)
            assert busy[0] - busy[1] in (0, 1)
    return tiles, overlapped


class _ClusterLib:
    """Stands in for the kernels' library: reports `clusters` co-resident
    clusters for every instantiation and records what was asked."""

    def __init__(self, clusters):
        self.clusters = clusters
        self.asked = []

    def dsen2_conv3x3_clusters(self, c, passes, dtype, epilogue):
        self.asked.append((c, passes, dtype, epilogue))
        return self.clusters


@pytest.mark.parametrize("shape,clusters", [
    ((1, 16, 16, 128), 66),      # one tile: one warpgroup of each CTA works, nothing overlaps
    ((1, 5, 11, 128), 66),       # an image smaller than one tile
    ((3, 40, 56, 128), 66),      # 36 tiles, fewer than the clusters
    ((1, 16, 16 * 67, 128), 66), # one cluster takes a second tile
    ((64, 128, 128, 128), 66),   # the tile cell's batch: 62-63 tiles a cluster
    ((6, 48, 64, 256), 66),      # C = 256: two channel halves per pixel tile
    ((16, 64, 64, 256), 61),     # C = 256, an odd number of clusters
    ((64, 128, 128, 64), 66),    # RCAN's batch: one 64-channel tile per pixel tile
])
@pytest.mark.parametrize("nblocks,f32", [(1, True), (2, True), (6, False)])
def test_tile_counters_follow_the_launch_geometry(shape, clusters, nblocks, f32):
    """b1.tiles and b1.tiles_overlapped add, for K blocks, both convs' tiles
    as the kernel's schedule lays them out, read from the geometry alone."""
    from dsen2_tpu_torch.utils.profiling import counters

    b, h, w, c = shape
    want = _walk_schedule(b, h, w, c, clusters)
    assert resblock_chain.schedule_counts(b, h, w, c, clusters) == want
    lib = _ClusterLib(clusters)
    passes = 3 if f32 else 1
    before = counters()
    resblock_chain.count_tiles(lib, shape, passes, f32, nblocks)
    after = counters()
    got = tuple(after[k] - before.get(k, 0) for k in ("b1.tiles", "b1.tiles_overlapped"))
    assert got == (2 * nblocks * want[0], 2 * nblocks * want[1])
    assert lib.asked == [(c, passes, 0, 0), (c, passes, 0 if f32 else 1, 1)]
    if shape == (64, 128, 128, 128):
        assert want[1] / want[0] > 0.98


def test_tile_counters_raise_when_no_cluster_fits():
    with pytest.raises(RuntimeError, match="no cluster fits"):
        resblock_chain.count_tiles(_ClusterLib(0), (1, 16, 16, 128), 3, True, 1)


def test_conv_tile_counters_add_each_epilogue():
    """count_conv_tiles (RCAN's body): each (epilogue, dtype, launches) adds
    its launches' tiles, asking the library for that instantiation."""
    from dsen2_tpu_torch.utils.profiling import counters

    lib = _ClusterLib(66)
    before = counters()
    resblock_chain.count_conv_tiles(lib, (64, 128, 128, 64), 3, ((0, 0, 200), (2, 0, 200),
                                                                  (1, 0, 11)))
    after = counters()
    t, o = _walk_schedule(64, 128, 128, 64, 66)
    assert after["b1.tiles"] - before.get("b1.tiles", 0) == 411 * t
    assert after["b1.tiles_overlapped"] - before.get("b1.tiles_overlapped", 0) == 411 * o
    assert lib.asked == [(64, 3, 0, 0), (64, 3, 0, 2), (64, 3, 0, 1)]
