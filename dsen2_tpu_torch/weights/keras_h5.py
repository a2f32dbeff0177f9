"""Keras-2 HDF5 checkpoint <-> numpy params dict.

A copy of the loader and writer in dsen2_tpu/weights/keras_h5.py, which
reaches JAX through its import of dsen2_tpu.models.s2net. Layout facts
(Keras 2.x):

  - a full-model save nests weights under 'model_weights'; a weights-only
    save puts layer groups at top level
  - Conv2D kernels are stored (kh, kw, in_ch, out_ch), i.e. HWIO
  - conv2d layers are numbered in creation order: head conv, (conv, conv)
    per resblock, tail conv
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from dsen2_tpu_torch.core.config import ModelConfig
from dsen2_tpu_torch.models.s2net import stack_block_params

__all__ = ["load_keras_weights", "save_keras_weights"]


def _layer_index(name: str) -> tuple[int, int]:
    """Sort key for Keras auto-names: 'conv2d' -> 0, 'conv2d_7' -> 7."""
    m = re.match(r"^conv2d(?:_(\d+))?$", name)
    if not m:
        raise ValueError(f"not a conv2d layer name: {name}")
    return (0 if m.group(1) is None else int(m.group(1)), 0)


def _collect_conv_weights(h5group) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    convs = []
    for lname in h5group:
        if not lname.startswith("conv2d"):
            continue
        layer = h5group[lname]
        kernel = bias = None

        # weight datasets live either directly in the layer group or one
        # level deeper under the layer's own name
        def visit(name, obj):
            nonlocal kernel, bias
            if hasattr(obj, "shape"):
                if name.endswith("kernel:0") or name.endswith("kernel"):
                    kernel = np.asarray(obj)
                elif name.endswith("bias:0") or name.endswith("bias"):
                    bias = np.asarray(obj)

        layer.visititems(visit)
        if kernel is None:
            raise ValueError(f"layer {lname}: kernel not found")
        if bias is None:
            bias = np.zeros((kernel.shape[-1],), dtype=kernel.dtype)
        convs.append((lname, kernel, bias))
    convs.sort(key=lambda t: _layer_index(t[0]))
    return convs


def load_keras_weights(path: str, cfg: ModelConfig) -> Dict:
    """Read a reference HDF5 checkpoint and return the s2net params dict."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        convs = _collect_conv_weights(root)

    expected = 2 + 2 * cfg.num_layers
    if len(convs) != expected:
        raise ValueError(
            f"{path}: found {len(convs)} conv layers, expected {expected} for "
            f"num_layers={cfg.num_layers}"
        )

    head_k, head_b = convs[0][1], convs[0][2]
    tail_k, tail_b = convs[-1][1], convs[-1][2]
    if head_k.shape != (3, 3, cfg.total_in_channels, cfg.feature_size):
        raise ValueError(f"head kernel shape {head_k.shape} mismatches config {cfg}")
    if tail_k.shape[-1] != cfg.out_channels:
        raise ValueError(f"tail kernel shape {tail_k.shape} mismatches config {cfg}")

    blocks = []
    for i in range(cfg.num_layers):
        _, k1, b1 = convs[1 + 2 * i]
        _, k2, b2 = convs[2 + 2 * i]
        blocks.append({"w1": k1, "b1": b1, "w2": k2, "b2": b2})

    return {
        "head": {"w": head_k.astype(np.float32), "b": head_b.astype(np.float32)},
        "blocks": {k: v.astype(np.float32) for k, v in stack_block_params(blocks).items()},
        "tail": {"w": tail_k.astype(np.float32), "b": tail_b.astype(np.float32)},
    }


def save_keras_weights(path: str, params: Dict) -> None:
    """Write params as a Keras-2-style weights HDF5 (round-trip format used by
    the converter tests and for interchange with the reference tooling)."""
    import h5py

    n_l = int(np.asarray(params["blocks"]["w1"]).shape[0])

    def lname(i: int) -> str:
        return "conv2d" if i == 0 else f"conv2d_{i}"

    seq: list[tuple[np.ndarray, np.ndarray]] = [
        (np.asarray(params["head"]["w"]), np.asarray(params["head"]["b"]))
    ]
    for i in range(n_l):
        seq.append((np.asarray(params["blocks"]["w1"][i]), np.asarray(params["blocks"]["b1"][i])))
        seq.append((np.asarray(params["blocks"]["w2"][i]), np.asarray(params["blocks"]["b2"][i])))
    seq.append((np.asarray(params["tail"]["w"]), np.asarray(params["tail"]["b"])))

    with h5py.File(path, "w") as f:
        layer_names = []
        for i, (k, b) in enumerate(seq):
            name = lname(i)
            layer_names.append(name)
            outer = f.create_group(name)
            g = outer.create_group(name)
            g.create_dataset("kernel:0", data=k)
            g.create_dataset("bias:0", data=b)
            # Keras-2 load_weights requires these attrs on each layer group
            outer.attrs["weight_names"] = np.array(
                [f"{name}/kernel:0".encode(), f"{name}/bias:0".encode()]
            )
        # ... and the layer index at the root (Model.load_weights reads
        # f.attrs['layer_names'] first)
        f.attrs["layer_names"] = np.array([n.encode() for n in layer_names])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.2.4"
