"""The CUDA residual-block kernel's host-side layouts, on the CPU: the packed
weights against the byte offsets the kernel reads, and the bf16 plane split
against the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsen2_tpu.ops.pallas.resblock_chain import _split_bf16
from dsen2_tpu_torch.ops import resblock_chain


def kernel_byte_offset(tap, k, n, plane, c, planes):
    """Byte offset of w[tap, k, n] (plane `plane`) in one conv's packed
    buffer, written out from csrc/resblock_chain.cu: the slice of output half
    nh, chunk kc and tap starts at ((nh * KC + kc) * 9 + tap) * STAGE_BYTES
    (the weight producer); its planes are SLICE_BYTES = NT * 128 apart (d_lo
    in the consumer), NT = min(C, 128) the tile's output channels; inside a
    plane the descriptor of b_desc (128-byte swizzle, SBO 1024 B) reads row n
    at n * 128 and the 16-byte group of k at ((k / 8) ^ (n % 8))."""
    nt = min(c, 128)
    nh, nn = n // nt, n % nt
    kc, kk = k // 64, k % 64
    stage = planes * nt * 128
    return (((nh * (c // 64) + kc) * 9 + tap) * stage + plane * nt * 128 + nn * 128
            + (((kk // 8) ^ (nn % 8)) * 16) + (kk % 8) * 2)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_packed_weights_sit_where_the_kernel_reads_them(rng, c, passes):
    w = rng.standard_normal((3, 3, c, c)).astype(np.float32)
    packed = resblock_chain.pack_weights(torch.from_numpy(w), passes)
    planes = 2 if passes == 3 else 1
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() * 2 == 9 * c * c * planes * 2
    flat = packed.view(torch.int16).numpy().ravel()
    want = resblock_chain.split_planes(torch.from_numpy(w).reshape(9, c, c), passes)
    want = want.view(torch.int16).numpy()
    tap, k, n = np.meshgrid(np.arange(9), np.arange(c), np.arange(c), indexing="ij")
    for plane in range(planes):
        off = kernel_byte_offset(tap, k, n, plane, c, planes)
        assert (off % 2 == 0).all()
        np.testing.assert_array_equal(flat[off // 2], want[plane])


@pytest.mark.parametrize("shape", [(7,), (2, 5, 3, 8)])
def test_split_planes_equals_jax_split_bit_for_bit(rng, shape):
    v = (rng.standard_normal(shape) * np.exp(rng.uniform(-20, 20, shape))).astype(np.float32)
    v.ravel()[:3] = [0.0, -0.0, 1.0 + 2.0 ** -9]  # a tie: round to nearest even
    hi_j, lo_j = _split_bf16(jnp.asarray(v))
    got = resblock_chain.split_planes(torch.from_numpy(v), 3)
    np.testing.assert_array_equal(got[0].view(torch.int16).numpy(),
                                  np.asarray(hi_j).view(np.int16))
    np.testing.assert_array_equal(got[1].view(torch.int16).numpy(),
                                  np.asarray(lo_j).view(np.int16))
    one = resblock_chain.split_planes(torch.from_numpy(v), 1)
    assert one.shape == (1, *shape) and torch.equal(one[0], got[0])
