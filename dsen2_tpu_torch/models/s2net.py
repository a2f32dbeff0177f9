"""The DSen2 residual CNN family in PyTorch.

The counterpart of dsen2_tpu/models/s2net.py:101-254:

    x = concat(inputs, channel axis)
    x = relu(conv3x3(x, F))                       # head
    repeat L times:                               # resBlock
        x = x + 0.1 * conv3x3(relu(conv3x3(x, F)), F)
    x = conv3x3(x, C_out)                         # tail
    out = x + inputs[-1]                          # global residual

Activations are NHWC and kernels HWIO, as in the JAX package. The head and
tail convs, and the blocks when no kernel runs them, are the plain class conv
of ops/conv.py, forward and backward at the requested precision, as the JAX
package's XLA convs are. Training runs plain convs only (the kernels have no
backward), with `remat=True` recomputing each block in the backward, the
counterpart of jax.checkpoint. Routing of the residual blocks, for a tensor on
a GPU with use_kernels None or True:

  - "high" (bf16x3) and "default" (one pass) always run the hand-written
    kernels, at every height and block count: B1 (`fused_resblock_chain`)
    where the TPU routing took its chain kernel or for "high", B2
    (`fused_resblock`) at "default" with an odd block count or a height with
    no 8-row tile. Neither falls back to plain convs: the JAX package's XLA
    fallbacks for "high" (s2net.py:217-228) are a TPU routing limit.
  - The 128-feature gate (s2net.py:175-188) is a TPU VMEM limit. The CUDA
    kernel tiles both spatial axes, so VDSen2's 256 features run through it.
  - "highest" warns and runs plain f32 convs with TF32 off; the JAX package
    has no kernel there either.

On the CPU the kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.ops.conv import PRECISIONS, conv3x3
from dsen2_tpu_torch.ops.resblock import fused_resblock
from dsen2_tpu_torch.ops.resblock_chain import fused_resblock_chain
from dsen2_tpu_torch.utils import profiling

Params = Dict[str, Dict]

__all__ = [
    "init_params", "apply", "param_count", "summary", "stack_block_params", "param_leaves",
]


def _he_uniform(gen: torch.Generator, shape: tuple[int, ...]) -> np.ndarray:
    """Keras 'he_uniform': U(-limit, limit), limit = sqrt(6 / fan_in),
    fan_in = kh * kw * in_ch for HWIO kernels."""
    limit = float(np.sqrt(6.0 / int(np.prod(shape[:-1]))))
    return ((torch.rand(shape, generator=gen) * 2 - 1) * limit).numpy()


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Fresh numpy parameters drawn from `gen`. Layout:

      head:   w [3,3,C_in,F],  b [F]
      blocks: w1,b1,w2,b2 each stacked on a leading [L] axis
      tail:   w [3,3,F,C_out], b [C_out]
    """
    f, cin, cout, n_l = cfg.feature_size, cfg.total_in_channels, cfg.out_channels, cfg.num_layers
    head_w = _he_uniform(gen, (3, 3, cin, f))
    blocks = [{"w1": _he_uniform(gen, (3, 3, f, f)), "w2": _he_uniform(gen, (3, 3, f, f)),
               "b1": np.zeros(f, np.float32), "b2": np.zeros(f, np.float32)}
              for _ in range(n_l)]
    stacked = stack_block_params(blocks) if n_l else {
        "w1": np.zeros((0, 3, 3, f, f), np.float32), "b1": np.zeros((0, f), np.float32),
        "w2": np.zeros((0, 3, 3, f, f), np.float32), "b2": np.zeros((0, f), np.float32),
    }
    return {
        "head": {"w": head_w, "b": np.zeros(f, np.float32)},
        "blocks": stacked,
        "tail": {"w": _he_uniform(gen, (3, 3, f, cout)), "b": np.zeros(cout, np.float32)},
    }


def stack_block_params(block_list: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-block {'w1','b1','w2','b2'} dicts onto a leading layer axis
    (a copy of dsen2_tpu.models.s2net.stack_block_params)."""
    return {k: np.stack([b[k] for b in block_list]) for k in ("w1", "b1", "w2", "b2")}


def _kernels_on(use_kernels: Optional[bool], precision: str, device: torch.device) -> bool:
    """The use_kernels tri-state: None (AUTO) is on for "high" and
    "default" wherever the tensors are not on the CPU."""
    if use_kernels is None:
        return precision != "highest" and device.type != "cpu"
    return bool(use_kernels)


def apply(
    params: Params,
    inputs: Sequence[torch.Tensor],
    cfg: ModelConfig,
    *,
    precision: str = "highest",
    use_kernels: Optional[bool] = False,
    remat: bool = False,
) -> torch.Tensor:
    """Forward pass. inputs: NHWC tensors (x10, x20_up[, x60_up]), all on the
    10 m grid, already divided by SCALE; params: tensors from
    `weights.params_to_torch`. Returns the NHWC prediction of
    cfg.out_channels bands (still divided by SCALE). remat=True recomputes
    each plain residual block in the backward instead of keeping its
    activations (torch.utils.checkpoint)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    x = torch.cat(list(inputs), dim=-1)
    x = torch.relu(conv3x3(x, params["head"]["w"], params["head"]["b"], precision))
    blk = params["blocks"]
    kernels = _kernels_on(use_kernels, precision, x.device)

    if kernels and precision == "highest":
        warnings.warn(
            "use_kernels has no true-f32 path; precision='highest' uses plain "
            "f32 convs (pass precision='high' for the bf16x3 kernel)"
        )
        kernels = False
    passes = 3 if precision == "high" else 1
    if kernels and passes == 3 and x.dtype != torch.float32:
        warnings.warn(
            "use_kernels with precision='high' needs f32 activations; "
            "bf16 compute_dtype runs the single-pass kernel instead"
        )
        passes = 1

    if not kernels:
        def block(x, k):
            t = torch.relu(conv3x3(x, blk["w1"][k], blk["b1"][k], precision))
            return x + cfg.residual_scale * conv3x3(t, blk["w2"][k], blk["b2"][k], precision)

        for k in range(cfg.num_layers):
            x = checkpoint(block, x, k, use_reentrant=False) if remat else block(x, k)
    elif passes == 3 or (cfg.num_layers % 2 == 0 and x.shape[1] % 8 == 0):
        with profiling.span("s2net.b1"):
            x = fused_resblock_chain(x, blk["w1"], blk["b1"], blk["w2"], blk["b2"],
                                     scale=cfg.residual_scale, passes=passes)
    else:
        h = x.shape[1]
        tile_rows = next((t for t in (16, 8, 4, 2) if h % t == 0), h)
        for k in range(cfg.num_layers):
            x = fused_resblock(x, blk["w1"][k], blk["b1"][k], blk["w2"][k], blk["b2"][k],
                               scale=cfg.residual_scale, tile_rows=tile_rows)

    x = conv3x3(x, params["tail"]["w"], params["tail"]["b"], precision)
    return x + inputs[-1]


# The parameters in a fixed order, whatever order a params dict was built in:
# the optimizer's state is indexed by it.
PARAM_NAMES = (("head", "w"), ("head", "b"), ("blocks", "w1"), ("blocks", "b1"),
               ("blocks", "w2"), ("blocks", "b2"), ("tail", "w"), ("tail", "b"))


def param_leaves(params: Params) -> list:
    """params' tensors in PARAM_NAMES order."""
    return [params[top][name] for top, name in PARAM_NAMES]


def param_count(params: Params) -> int:
    return sum(int(np.prod(tuple(v.shape))) for sub in params.values() for v in sub.values())


def summary(cfg: ModelConfig) -> str:
    """Architecture summary text (a copy of dsen2_tpu.models.s2net.summary)."""
    f, n_l = cfg.feature_size, cfg.num_layers
    cin, cout = cfg.total_in_channels, cfg.out_channels

    def conv_params(ci, co):
        return 3 * 3 * ci * co + co

    lines = [
        f"s2model: inputs {cfg.in_channels} -> concat({cin}) -> "
        f"{n_l} resblocks x {f} -> {cout} + global residual",
        f"{'layer':<22}{'output ch':>10}{'params':>12}",
        f"{'head conv3x3 + relu':<22}{f:>10}{conv_params(cin, f):>12,}",
    ]
    for i in range(n_l):
        lines.append(
            f"{'resblock_%d (2x conv)' % i:<22}{f:>10}{2 * conv_params(f, f):>12,}"
        )
    lines.append(f"{'tail conv3x3':<22}{cout:>10}{conv_params(f, cout):>12,}")
    total = conv_params(cin, f) + n_l * 2 * conv_params(f, f) + conv_params(f, cout)
    lines.append(f"{'TOTAL':<22}{'':>10}{total:>12,}")
    return "\n".join(lines)
