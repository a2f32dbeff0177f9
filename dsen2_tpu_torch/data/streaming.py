"""Streaming dataset loader: iterate tile archives off disk, bounded RAM.

The reference trains by concatenating every tile's patch archive in RAM —
"trained by loading all the data on a 64GB RAM ... a generator can be used"
(training/README.md:18; utils/patches.py:288-324 OpenDataFiles). For the
full 45-tile envelope (360k patches, ~23 GB at 2x) that design caps the
dataset at host RAM. This loader keeps at most ONE tile's training rows in
memory: per epoch it visits tiles in a shuffled order, shuffles rows within
each tile (memmap reads), and assembles fixed-size batches across tile
boundaries, carrying remainders so no sample is dropped.

Shuffling is tile-then-row ("shard shuffle") rather than the reference's
global permutation — the standard streaming trade-off; the per-epoch RNG is
keyed by (seed, epoch) so resumed runs replay the identical batch stream.

On-disk format is exactly the reference's archives (data/patches_dataset.py
module docstring), including the global val_index.npy mask over the
concatenated sorted-tile slot order (training/create_random.py).

A copy of dsen2_tpu/data/streaming.py (tests/test_torch_streaming.py holds
its batches equal to the original's).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from dsen2_tpu_torch.data.patches_dataset import _to_hwc

__all__ = ["StreamingPatchDataset"]


class StreamingPatchDataset:
    """Reference-format train[60]/ archives, streamed tile-by-tile.

    Use with train/loop.py::fit by passing the instance as `train_inputs`
    (with train/val arrays None): fit detects the `epoch_batches` protocol.
    """

    def __init__(self, path: str, run_60: bool, scale: float, seed: int = 0):
        train_path = os.path.join(path, "train60" if run_60 else "train")
        self.dsets: List[str] = sorted(glob.glob(os.path.join(train_path, "*SAFE")))
        if not self.dsets:
            raise FileNotFoundError(f"no *SAFE tile dirs under {train_path}")
        self.input_names = ["data10", "data20"] + (["data60"] if run_60 else [])
        self.label_name = "data60_gt" if run_60 else "data20_gt"
        self.scale = float(scale) if scale else 1.0
        self.seed = seed

        counts = []
        for d in self.dsets:
            arr = np.load(os.path.join(d, self.label_name + ".npy"), mmap_mode="r")
            counts.append(arr.shape[0])
            del arr
        offsets = np.concatenate([[0], np.cumsum(counts)])

        val_file = os.path.join(train_path, "val_index.npy")
        try:
            val_ind = np.load(val_file)
        except OSError:
            raise FileNotFoundError(
                f"{val_file} missing: generate it with "
                "dsen2_tpu_torch.data.make_val_index / the make-patches CLI"
            )
        if len(val_ind) != offsets[-1]:
            raise ValueError(
                f"val_index length {len(val_ind)} != total patch slots {offsets[-1]}"
            )
        # Per-tile row indices for each split (row = index within the tile).
        self.train_rows = [
            np.flatnonzero(~val_ind[offsets[i] : offsets[i + 1]])
            for i in range(len(self.dsets))
        ]
        self.val_rows = [
            np.flatnonzero(val_ind[offsets[i] : offsets[i + 1]])
            for i in range(len(self.dsets))
        ]
        self.n_train = int(sum(len(r) for r in self.train_rows))
        self.n_val = int(sum(len(r) for r in self.val_rows))

    # -- loading ---------------------------------------------------------

    def _load_rows(self, tile_i: int, rows: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
        """Read selected rows of one tile (memmap -> only those rows touch
        RAM), as NHWC float32 / scale."""
        d = self.dsets[tile_i]
        rows = np.sort(rows) if not _is_sorted(rows) else rows
        out = []
        for name in self.input_names + [self.label_name]:
            arr = np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
            out.append(_to_hwc(np.asarray(arr[rows], np.float32)) / np.float32(self.scale))
        return out[:-1], out[-1]

    def val_nbytes(self) -> int:
        """Estimated bytes of the concatenated f32 validation split — what
        load_val() would hold in RAM. Drives fit()'s stream-vs-load choice
        (streaming re-decodes every tile each eval, so small splits load
        once)."""
        if not self.dsets or self.n_val == 0:
            return 0
        d = self.dsets[0]
        per = 0
        for name in self.input_names + [self.label_name]:
            arr = np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
            per += int(np.prod(arr.shape[1:])) * 4
        return per * self.n_val

    @staticmethod
    def _batches_with_carry(tiles, batch_size: int):
        """Assemble fixed-size (count, inputs list, label) batches from a
        stream of per-tile (inputs, label) arrays, carrying remainders
        across tile boundaries so no sample is dropped; one final short
        batch at most."""
        carry_in: Optional[List[np.ndarray]] = None
        carry_lb: Optional[np.ndarray] = None
        for tin, tlb in tiles:
            if carry_lb is not None:
                tin = [np.concatenate([c, a]) for c, a in zip(carry_in, tin)]
                tlb = np.concatenate([carry_lb, tlb])
            m = tlb.shape[0]
            full = m // batch_size * batch_size
            for i in range(0, full, batch_size):
                yield (
                    batch_size,
                    [a[i : i + batch_size] for a in tin],
                    tlb[i : i + batch_size],
                )
            if full < m:
                carry_in = [a[full:].copy() for a in tin]
                carry_lb = tlb[full:].copy()
            else:
                carry_in = carry_lb = None
        if carry_lb is not None:
            yield len(carry_lb), carry_in, carry_lb

    def val_batches(self, batch_size: int):
        """Yield (count, inputs list, label) batches over the validation
        split with ONE tile's val rows resident at a time (bounded RSS,
        like epoch_batches) — deterministic tile/row order, so every epoch
        evaluates the identical sequence. Batches cross tile boundaries via
        the same remainder carry as the training stream."""

        def tiles():
            for t in range(len(self.dsets)):
                if len(self.val_rows[t]):
                    yield self._load_rows(t, self.val_rows[t])

        return self._batches_with_carry(tiles(), batch_size)

    def load_val(self) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        """The validation split, concatenated in RAM (it is ~10% of the
        data; streaming it per-epoch would re-decode every tile each eval)."""
        ins: Optional[List[List[np.ndarray]]] = None
        lbs = []
        for i in range(len(self.dsets)):
            if len(self.val_rows[i]) == 0:
                continue
            tin, tlb = self._load_rows(i, self.val_rows[i])
            if ins is None:
                ins = [[a] for a in tin]
            else:
                for acc, a in zip(ins, tin):
                    acc.append(a)
            lbs.append(tlb)
        if ins is None:
            raise ValueError("validation split is empty")
        return tuple(np.concatenate(a) for a in ins), np.concatenate(lbs)

    # -- epoch stream ------------------------------------------------------

    def epoch_batches(self, epoch: int, batch_size: int):
        """Yield (count, inputs list, label) batches covering every training
        sample exactly once. Deterministic per (seed, epoch)."""
        rng = np.random.default_rng([self.seed, epoch])
        order = rng.permutation(len(self.dsets))

        def tiles():
            for t in order:
                rows = self.train_rows[t]
                if len(rows) == 0:
                    continue
                perm = rng.permutation(len(rows))
                tin, tlb = self._load_rows(t, rows)
                yield [a[perm] for a in tin], tlb[perm]

        return self._batches_with_carry(tiles(), batch_size)


def _is_sorted(a: np.ndarray) -> bool:
    return bool(np.all(a[1:] >= a[:-1])) if len(a) else True
