"""DSen2's head and tail on the kernel route, on the CPU: the plain versions
against the class conv they replace, s2net's kernel route unchanged bit for
bit, the B fragments' layout against the PTX ISA's, and the wrappers'
checks. The kernels themselves run in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from dsen2_tpu_torch.core.config import ModelConfig, dsen2_2x, dsen2_6x
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.ops import head_tail, resblock, resblock_chain
from dsen2_tpu_torch.ops.conv import conv3x3
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import params_to_torch


def _case(cfg, seed=0, b=2, h=24, w=20):
    params = params_to_torch(s2net.init_params(torch.Generator().manual_seed(seed), cfg), "cpu")
    rng = np.random.default_rng(seed)
    inputs = [torch.from_numpy(rng.random((b, h, w, c), np.float32)) for c in cfg.in_channels]
    return params, inputs


def _small(cfg):
    """cfg's inputs and outputs at 2 blocks x 16 features (CPU time)."""
    return ModelConfig(in_channels=cfg.in_channels, num_layers=2, feature_size=16)


@pytest.mark.parametrize("cfg", [dsen2_2x(), dsen2_6x()], ids=["2x", "6x"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_plain_versions_equal_the_class_conv_bit_for_bit(cfg, precision):
    params, inputs = _case(_small(cfg))
    hw, hb = params["head"]["w"], params["head"]["b"]
    x, planes = head_tail.head(inputs, hw, hb, precision, planes=True)
    want = torch.relu(conv3x3(torch.cat(inputs, dim=-1), hw, hb, precision))
    assert torch.equal(x, want)
    assert torch.equal(planes, resblock_chain.split_planes(want, 3 if precision == "high" else 1))
    assert head_tail.head(inputs, hw, hb, precision)[1] is None
    tw, tb = params["tail"]["w"], params["tail"]["b"]
    y = head_tail.tail(x, tw, tb, inputs[-1], precision)
    assert torch.equal(y, conv3x3(want, tw, tb, precision) + inputs[-1])
    assert torch.equal(y, head_tail.tail_plain(x, tw, tb, inputs[-1], precision))


@pytest.mark.parametrize("cfg", [dsen2_2x(), dsen2_6x()], ids=["2x", "6x"])
@pytest.mark.parametrize("precision,layers,h", [("high", 2, 24), ("default", 2, 24),
                                                ("default", 3, 20)])
def test_cpu_kernel_route_is_unchanged_bit_for_bit(cfg, precision, layers, h):
    """use_kernels=True on the CPU, at a width the head and tail kernels
    take: the head, the blocks' plain versions (B1's or B2's route) and the
    tail as the class conv computed them, and no launch counted."""
    small = ModelConfig(in_channels=cfg.in_channels, num_layers=layers, feature_size=128)
    params, inputs = _case(small, h=h)

    def counts():
        c = profiling.counters()
        return c.get("s2net.heads", 0), c.get("s2net.tails", 0)

    before = counts()
    got = s2net.apply(params, inputs, small, precision=precision, use_kernels=True)
    assert counts() == before
    blk = params["blocks"]
    x = torch.relu(conv3x3(torch.cat(inputs, dim=-1), params["head"]["w"], params["head"]["b"],
                           precision))
    passes = 3 if precision == "high" else 1
    if passes == 3 or (layers % 2 == 0 and h % 8 == 0):
        x = resblock_chain.resblock_chain_plain(x, blk["w1"], blk["b1"], blk["w2"], blk["b2"],
                                                scale=small.residual_scale, passes=passes)
    else:
        for k in range(layers):
            x = resblock.fused_resblock_plain(x, blk["w1"][k], blk["b1"][k], blk["w2"][k],
                                              blk["b2"][k], scale=small.residual_scale)
    want = conv3x3(x, params["tail"]["w"], params["tail"]["b"], precision) + inputs[-1]
    assert torch.equal(got, want)


def _bf16_bits(v):
    return v.to(torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("k,n", [(10, 128), (12, 256), (16, 64), (128, 6), (256, 2), (64, 8)])
@pytest.mark.parametrize("passes", [1, 3])
def test_fragments_hold_the_ptx_b_operand_layout(k, n, passes):
    """pack_fragments' lane 4 g + t, register r, half e holds w[tap, 16 kc +
    8 r + 2 t + e, 8 nb + g] of each plane (the m16n8k16 B fragment of the
    PTX ISA: b0 rows 2t, 2t + 1, b1 rows 2t + 8, 2t + 9, column g), zero in
    the padding."""
    rng = np.random.default_rng(k * n + passes)
    w = torch.from_numpy(rng.standard_normal((3, 3, k, n)).astype(np.float32))
    frags = head_tail.pack_fragments(w, passes)
    kp, np_ = -(-k // 16) * 16, -(-n // 8) * 8
    planes = 2 if passes == 3 else 1
    assert frags.dtype == torch.bfloat16 and frags.is_contiguous()
    assert tuple(frags.shape) == (kp // 16, 9, np_ // 8, planes, 8, 4, 2, 2)
    want = torch.zeros((planes, 9, kp, np_), dtype=torch.bfloat16)
    want[:, :, :k, :n] = resblock_chain.split_planes(w.reshape(9, k, n), passes)
    f = frags.view(torch.int16).numpy()
    wb = want.view(torch.int16).numpy()
    kc, tap, nb, p, g, t, r, e = np.meshgrid(*(np.arange(d) for d in frags.shape), indexing="ij")
    np.testing.assert_array_equal(f, wb[p, tap, 16 * kc + 8 * r + 2 * t + e, 8 * nb + g])
    # A warp reads fragment (kc, tap, nb, plane) as 256 contiguous bytes.
    assert frags[0, 0, 0, 0].numel() * 2 == 256


def test_wrappers_check_their_arguments():
    params, inputs = _case(_small(dsen2_2x()))
    hw, hb = params["head"]["w"], params["head"]["b"]
    with pytest.raises(ValueError, match="'high' or 'default'"):
        head_tail.head(inputs, hw, hb, "highest")
    with pytest.raises(ValueError, match="w must be"):
        head_tail.head(inputs[:1], hw, hb, "high")
    x = torch.zeros((2, 24, 20, 16))
    tw, tb = params["tail"]["w"], params["tail"]["b"]
    with pytest.raises(ValueError, match="'high' or 'default'"):
        head_tail.tail(x, tw, tb, inputs[-1], "highest")
    with pytest.raises(ValueError, match="w must be"):
        head_tail.tail(x[..., :8], tw, tb, inputs[-1], "high")
    w = torch.zeros((2, 3, 3, 16, 16))
    b = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="planes must have shape"):
        resblock_chain.fused_resblock_chain(x, w, b, w, b, passes=3,
                                            planes=torch.zeros((1, *x.shape), dtype=torch.bfloat16))


def test_non_cuda_devices_raise_rather_than_fall_back():
    """A tensor neither on the CPU nor on a GPU reaches the launchers, which
    raise: no path quietly computes elsewhere."""
    xs = [torch.empty((1, 16, 16, c), device="meta") for c in (4, 6)]
    w, b = torch.empty((3, 3, 10, 128), device="meta"), torch.empty((128,), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        head_tail.head(xs, w, b, "high", planes=True)
    x = torch.empty((1, 16, 16, 128), device="meta")
    tw, tb = torch.empty((3, 3, 128, 6), device="meta"), torch.empty((6,), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        head_tail.tail(x, tw, tb, xs[-1], "default")
