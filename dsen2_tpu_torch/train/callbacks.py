"""Training-loop callbacks: plateau LR schedule, loss log and plots, and
best-checkpoint tracking (reference: training/supres_train.py:36-106
PlotLosses, :195-201 ModelCheckpoint, :203-209 ReduceLROnPlateau).

ReduceLROnPlateau and LossLogger are copies of dsen2_tpu/train/callbacks.py
(tests/test_torch_train.py holds them equal); LossLogger skips its plots
where matplotlib is not installed. BestCheckpoint writes the .npz always and
the Keras .hdf5 where h5py is installed, with one warning otherwise.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import warnings

import numpy as np

__all__ = ["ReduceLROnPlateau", "LossLogger", "BestCheckpoint"]


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Keras-semantics plateau scheduler: when val_loss fails to improve by
    min_delta for `patience` epochs, multiply lr by `factor` (floored at
    min_lr) and enter a cooldown (reference: training/supres_train.py:203-209
    with factor=.5, patience=5, epsilon=1e-6, cooldown=20, min_lr=1e-5)."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    min_delta: float = 1e-6
    cooldown: int = 20
    min_lr: float = 1e-5
    verbose: bool = True

    best: float = np.inf
    wait: int = 0
    cooldown_counter: int = 0

    def step(self, val_loss: float) -> float:
        """Advance one epoch; returns the (possibly reduced) learning rate."""
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old = self.lr
                self.lr = max(self.lr * self.factor, self.min_lr)
                if self.verbose and self.lr < old:
                    print(f"ReduceLROnPlateau: reducing lr to {self.lr:.2e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
        return self.lr


class LossLogger:
    """Per-epoch text log (same line format as the reference's PlotLosses,
    training/supres_train.py:60-62) plus optional epoch-windowed loss-curve
    PNGs (:64-103)."""

    def __init__(self, out_dir: str, model_nr: str, lr: float, plots: bool = True,
                 plot_every: int = 10, append: bool = False):
        os.makedirs(out_dir, exist_ok=True)
        self.filename = os.path.join(out_dir, f"{model_nr}_lr_{lr:.1e}.txt")
        self.out_dir = out_dir
        self.model_nr = model_nr
        self.plots = plots
        self.plot_every = plot_every
        self.losses: list[float] = []
        self.val_losses: list[float] = []
        if not append:
            open(self.filename, "w").close()

    def on_epoch_end(
        self, epoch: int, loss: float, val_loss: float, lr: float, last: bool = False
    ) -> None:
        self.losses.append(loss)
        self.val_losses.append(val_loss)
        with open(self.filename, "a") as f:
            f.write(
                "Finished epoch {:5d}: loss {:.3e}, valid: {:.3e}, lr: {:.1e}\n".format(
                    epoch, loss, val_loss, lr
                )
            )
        # The reference re-renders the figure every epoch; amortise instead,
        # but always render the final epoch so the saved curve is complete.
        if self.plots and (last or epoch % self.plot_every == 0):
            self._plot(epoch)

    def _plot(self, epoch: int) -> None:
        # Windowed views like the reference: later epochs drop the noisy start.
        for threshold, skip, name in (
            (500, 475, "_loss4.png"),
            (250, 240, "_loss3.png"),
            (100, 85, "_loss2.png"),
            (50, 50, "_loss1.png"),
            (-1, 0, "_loss0.png"),
        ):
            if epoch > threshold:
                try:
                    import matplotlib

                    matplotlib.use("Agg")
                    import matplotlib.pyplot as plt

                    xs = np.arange(len(self.losses))[skip:]
                    plt.clf()
                    plt.plot(xs, self.losses[skip:], label="loss")
                    plt.plot(xs, self.val_losses[skip:], label="val_loss")
                    plt.legend()
                    plt.xlabel("epochs")
                    plt.savefig(os.path.join(self.out_dir, self.model_nr + name))
                except (IOError, ImportError):
                    pass
                break


class BestCheckpoint:
    """Keep the best-val-loss weights on disk (reference ModelCheckpoint with
    save_best_only, training/supres_train.py:195-201): the portable .npz
    dump, and a Keras-compatible HDF5 where h5py is installed."""

    def __init__(self, path_base: str, verbose: bool = True):
        self.path_base = path_base
        self.best = np.inf
        self.verbose = verbose
        self._hdf5 = importlib.util.find_spec("h5py") is not None
        if not self._hdf5:
            warnings.warn(
                "h5py is not installed: best checkpoints are written as .npz "
                f"only ({path_base}.npz)", stacklevel=2,
            )

    def maybe_save(self, val_loss: float, params) -> bool:
        if not val_loss < self.best:
            return False
        self.best = val_loss
        from dsen2_tpu_torch.weights import params_to_numpy, save_keras_weights, save_params_npz

        params_np = params_to_numpy(params)
        save_params_npz(self.path_base + ".npz", params_np)
        written = self.path_base + ".npz"
        if self._hdf5:
            save_keras_weights(self.path_base + ".hdf5", params_np)
            written = self.path_base + ".hdf5"
        if self.verbose:
            print(f"checkpoint: val_loss improved to {val_loss:.3e} -> {written}")
        return True
