"""The training loop: the Keras fit loop of the reference on one GPU.

The counterpart of dsen2_tpu/train/loop.py, with the same semantics:
Keras-2 Nadam and MAE (MSE as a metric), a global shuffle per epoch from
np.random.default_rng(seed), fast-forwarded on resume; the short final batch
weighted by its size; plateau LR; best-val checkpoints; the text log; the
periodic and the interrupt full-state save; exact resume.

Training runs the model's plain convs at the requested accuracy class,
forward and backward (ops/conv.py), as the JAX package trains through XLA
convs: neither residual-block kernel has a backward. Host-fed batches are
uploaded from pinned memory on a producer thread while the previous step
runs; step losses stay on the device until the epoch ends. `stage_data=True`
puts the dataset on the device once (train/staged.py). A streaming dataset
(data/streaming.py::StreamingPatchDataset) in place of the arrays streams
tile archives off disk with bounded host memory.

Under a mesh (parallel/mesh.py) the steps are data-parallel
(parallel/train_step.py): each batch splits over the mesh's 'data' axis,
and the params live on the mesh's first device.
"""

from __future__ import annotations

import contextvars
import copy
import dataclasses
import os
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dsen2_tpu_torch.core.config import ModelConfig, TrainConfig
from dsen2_tpu_torch.core.device import resolve_device, upload
from dsen2_tpu_torch.models import s2net
from dsen2_tpu_torch.train.callbacks import BestCheckpoint, LossLogger, ReduceLROnPlateau
from dsen2_tpu_torch.train.nadam import get_lr, load_optimizer_state, make_optimizer, set_lr
from dsen2_tpu_torch.utils import profiling
from dsen2_tpu_torch.weights import params_to_torch

__all__ = ["TrainState", "fit", "make_optimizer", "restore_fit_state", "train_step"]

# Streaming datasets: a val split up to this size is concatenated in RAM
# once (load_val); beyond it, fit streams val batches tile-by-tile per
# epoch (bounded RSS at the cost of re-reading the tiles each eval).
VAL_STREAM_THRESHOLD_BYTES = 1 << 30


@dataclasses.dataclass
class TrainState:
    params: Dict  # {top: {name: tensor}} on the training device
    opt_state: Dict  # the optimizer's state_dict
    epoch: int = 0


def restore_fit_state(
    path: str, cfg: ModelConfig, train_cfg: TrainConfig, warn_mismatch: bool = True
) -> Dict:
    """Restore a full-state checkpoint written by fit() into keyword
    arguments for fit(): {'params', 'opt_state', 'start_epoch',
    'plateau_state', 'history', 'best_val'} (plus 'train_flags', the
    checkpointed run's recorded flags, which fit() accepts and ignores).
    Resuming with these continues the exact trajectory: optimizer moments,
    plateau scheduler, shuffle order. With warn_mismatch, warns when the
    recorded lr, batch size, augment or seed differ from train_cfg's."""
    from dsen2_tpu_torch.weights.checkpoint import restore_train_state

    st = restore_train_state(path)
    extra = st["extra"]
    out = {
        "params": st["params"],
        "opt_state": st["opt_state"],
        "start_epoch": int(st["epoch"]),
        "plateau_state": dict(extra["plateau"]),
        "history": {k: [float(x) for x in v] for k, v in extra["history"].items()},
        "best_val": float(extra["best_val"]),
    }
    flags = extra.get("train_flags")
    if flags is not None:
        recorded = dict(flags)
        current = {
            "lr": train_cfg.lr,
            "batch_size": train_cfg.batch_size,
            "augment": train_cfg.augment,
            "seed": train_cfg.seed,
        }
        mismatched = {
            k: (recorded[k], current[k])
            for k in recorded
            if k in current and recorded[k] != current[k]
        }
        if mismatched and warn_mismatch:
            detail = ", ".join(
                f"{k}: checkpoint={a!r} vs invocation={b!r}"
                for k, (a, b) in sorted(mismatched.items())
            )
            warnings.warn(
                "resume flags differ from the checkpointed run — the "
                f"trajectory will NOT continue exactly ({detail})",
                stacklevel=2,
            )
        out["train_flags"] = recorded
    return out


def train_step(params, opt, inputs, target, cfg: ModelConfig, precision: str = "high",
               remat: bool = False):
    """One optimizer step on a batch already on the device. Returns the
    batch's (MAE, MSE) before the update, as device scalars."""
    from dsen2_tpu_torch.parallel import make_train_step

    m = make_train_step(cfg, opt, None, precision, remat)(params, inputs, target)
    return m["loss"], m["mse"]


def _snapshot(params, opt) -> Dict:
    """Copies of params and the optimizer state, as fit's `live` holds them
    between epochs (training updates both in place)."""
    return {
        "params": {top: {k: v.detach().clone() for k, v in sub.items()}
                   for top, sub in params.items()},
        "opt_state": copy.deepcopy(opt.state_dict()),
    }


@profiling.traced("fit")
def fit(
    cfg: ModelConfig,
    train_cfg: TrainConfig,
    train_inputs: Sequence[np.ndarray],  # tuple of [N,H,W,C] f32, already /SCALE
    train_labels: np.ndarray,  # [N,H,W,C_out]
    val_inputs: Sequence[np.ndarray],
    val_labels: np.ndarray,
    params: Optional[Dict] = None,
    mesh=None,
    epochs: Optional[int] = None,
    precision: str = "high",
    remat: bool = False,
    verbose: bool = True,
    stage_data: bool = False,
    opt_state: Optional[Dict] = None,
    start_epoch: int = 0,
    plateau_state: Optional[Dict] = None,
    history: Optional[Dict[str, list]] = None,
    best_val: Optional[float] = None,
    force_lr: Optional[float] = None,
    train_flags: Optional[Dict] = None,  # checkpoint metadata; accepted so
    # restore_fit_state(...) can be **-splatted (the caller reconciles it).
    device=None,
) -> Tuple[TrainState, Dict[str, list]]:
    """Train; returns (final state, history). Checkpoints and logs go to
    train_cfg.out_dir when set ({model_nr}lr_{lr:.0e}.npz/.hdf5, as
    training/supres_train.py:195 names them). params: a numpy or tensor
    params dict, else a fresh init from train_cfg.seed.

    Pass opt_state/start_epoch/plateau_state/history/best_val (e.g. via
    restore_fit_state) to resume the exact trajectory of an earlier run.
    Runs on "cuda" unless `device` says otherwise. With a mesh
    (parallel.make_mesh), or with no mesh and no device on a machine with
    several GPUs (then make_mesh()), each batch splits over the mesh's data
    axis when it divides by it and runs on the first device otherwise, as
    the JAX package replicates the final short batch.

    `train_inputs` may instead be a data/streaming.py::StreamingPatchDataset
    (pass train_labels=None); the epoch then streams tile archives off disk
    with bounded RAM, and the val split defaults to ds.load_val() when
    val_labels is None.

    A call is one span, fit; fit.setup covers its entry to the first epoch
    (fit.stage: stage_dataset), and each epoch is a fit.epoch span.
    Counts train.steps and train.samples (utils/profiling counters)."""
    entered = profiling.now()
    # parallel/ imports train/losses.py, so it is imported here.
    from dsen2_tpu_torch.parallel import batch_sharding, make_eval_step, make_mesh, make_train_step
    from dsen2_tpu_torch.parallel.mesh import DATA_AXIS, primary_device

    stream_ds = train_inputs if hasattr(train_inputs, "epoch_batches") else None
    stream_val = False
    if stream_ds is not None:
        if stage_data:
            raise ValueError(
                "stage_data=True is incompatible with a streaming dataset "
                "(streaming exists precisely because the data exceeds memory)"
            )
        if val_labels is None:
            # The val split streams tile-by-tile each epoch only when a
            # one-time concatenated load would strain host RAM: streaming
            # re-reads every tile each eval, so small splits load once.
            # Batch boundaries and sample order are the same either way, so
            # the val loss does not depend on this choice.
            if stream_ds.val_nbytes() > VAL_STREAM_THRESHOLD_BYTES:
                stream_val = True
            else:
                val_inputs, val_labels = stream_ds.load_val()
    if mesh is None and device is None and torch.cuda.device_count() > 1:
        mesh = make_mesh()
    dev = resolve_device(device) if mesh is None else primary_device(mesh, device)
    if params is None:
        params = s2net.init_params(torch.Generator().manual_seed(train_cfg.seed), cfg)
    params = {top: {k: v.detach().clone().requires_grad_(True) for k, v in sub.items()}
              for top, sub in params_to_torch(params, dev).items()}

    opt = make_optimizer(params, train_cfg)
    if opt_state is not None:
        load_optimizer_state(opt, opt_state)

    staged = None
    if stage_data:
        from dsen2_tpu_torch.train.staged import stage_dataset

        with profiling.span("fit.stage"):
            staged = stage_dataset(
                cfg, train_cfg.batch_size, train_inputs, train_labels, val_inputs, val_labels,
                device=dev, precision=precision, remat=remat, augment=train_cfg.augment,
                mesh=mesh,
            )

    def place_batch(arrs):
        """Each array on the device, or under a mesh split over its data
        devices when the batch divides by the data axis."""
        arrs = [np.asarray(a, np.float32) for a in arrs]
        if mesh is None or arrs[0].shape[0] % mesh.shape[DATA_AXIS]:
            return tuple(upload(a, dev) for a in arrs)
        return tuple(batch_sharding(mesh, a.ndim).place(a) for a in arrs)

    train_one = make_train_step(cfg, opt, mesh, precision, remat)
    eval_one = make_eval_step(cfg, mesh, precision)

    def step(binputs, btarget):
        m = train_one(params, binputs, btarget)
        return m["loss"], m["mse"]

    def evaluate(binputs, btarget):
        m = eval_one(params, binputs, btarget)
        return m["loss"], m["mse"]

    plateau = ReduceLROnPlateau(
        lr=train_cfg.lr,
        factor=train_cfg.plateau_factor,
        patience=train_cfg.plateau_patience,
        min_delta=train_cfg.plateau_min_delta,
        cooldown=train_cfg.plateau_cooldown,
        min_lr=train_cfg.plateau_min_lr,
        verbose=verbose,
    )
    if plateau_state:
        for k, v in plateau_state.items():
            setattr(plateau, k, type(getattr(plateau, k))(v))
    if force_lr is not None:
        # The restored optimizer state and plateau scheduler both carry the
        # checkpointed lr and would otherwise win over train_cfg.lr.
        plateau.lr = float(force_lr)
        set_lr(opt, force_lr)
    history = history if history is not None else {
        "loss": [], "val_loss": [], "mse": [], "lr": []
    }
    logger = ckpt = None
    if train_cfg.out_dir:
        os.makedirs(train_cfg.out_dir, exist_ok=True)
        logger = LossLogger(
            train_cfg.out_dir, train_cfg.model_nr, train_cfg.lr,
            append=start_epoch > 0,
        )
        logger.losses = list(history["loss"])
        logger.val_losses = list(history["val_loss"])
        ckpt = BestCheckpoint(
            os.path.join(
                train_cfg.out_dir, f"{train_cfg.model_nr}lr_{train_cfg.lr:.0e}"
            ),
            verbose=verbose,
        )
        if best_val is not None:
            ckpt.best = best_val

    n = stream_ds.n_train if stream_ds is not None else train_labels.shape[0]
    rng = np.random.default_rng(train_cfg.seed)
    # Fast-forward the shuffle stream over the completed epochs, so a
    # resumed run sees the batch order the uninterrupted run would.
    # (Streaming epochs draw from a per-(seed, epoch) rng instead and consume
    # nothing from this stream.)
    if stream_ds is None:
        for _ in range(start_epoch):
            rng.permutation(n)
    epochs = train_cfg.epochs if epochs is None else epochs

    # The state after the last completed epoch, which the interrupt handler
    # saves (training updates params and moments in place mid-epoch).
    live = _snapshot(params, opt) if train_cfg.out_dir else {}

    def save_state(tag: str = "state") -> None:
        """Full-state checkpoint: params + optimizer + plateau + history."""
        if not train_cfg.out_dir:
            return
        from dsen2_tpu_torch.weights.checkpoint import save_train_state

        extra = {
            "plateau": {
                "lr": plateau.lr,
                "best": plateau.best,
                "wait": plateau.wait,
                "cooldown_counter": plateau.cooldown_counter,
            },
            "best_val": ckpt.best if ckpt else np.inf,
            "history": {k: [float(x) for x in v] for k, v in history.items()},
            # The run's trajectory-defining flags, so resume can detect a
            # mismatched invocation.
            "train_flags": {
                "lr": train_cfg.lr,
                "batch_size": train_cfg.batch_size,
                "augment": train_cfg.augment,
                "seed": train_cfg.seed,
            },
        }
        path = os.path.join(train_cfg.out_dir, f"{train_cfg.model_nr}{tag}")
        save_train_state(path, live["params"], live["opt_state"],
                         epoch=len(history["loss"]), extra=extra)

    val_producer_fn = None
    if stream_val:
        def val_producer_fn():
            def produce():
                for cnt, bin_, blb in stream_ds.val_batches(train_cfg.batch_size):
                    yield cnt, place_batch(bin_), place_batch([blb])[0]

            return produce()

    profiling.record("fit.setup", entered)
    try:
        _epoch_loop(
            train_cfg, train_inputs, train_labels, val_inputs, val_labels,
            params, opt, live, step, evaluate, plateau, logger, ckpt,
            n, rng, history, start_epoch, epochs, verbose, place_batch,
            save_state, staged, stream_ds, val_producer_fn,
        )
    except KeyboardInterrupt:
        # An interrupted run leaves a resumable full-state checkpoint.
        if train_cfg.out_dir:
            save_state("interrupted")
            print(
                "interrupted: full train state saved to "
                + os.path.join(train_cfg.out_dir, f"{train_cfg.model_nr}interrupted")
            )
        raise

    params = {top: {k: v.detach() for k, v in sub.items()} for top, sub in params.items()}
    return TrainState(params=params, opt_state=opt.state_dict(),
                      epoch=len(history["loss"])), history


def _prefetch(gen, depth: int = 2):
    """Run a batch-producing generator on a background thread with a bounded
    queue, so that the host indexing and upload of batch k+1 overlap step k.

    The producer's puts poll a stop event so it can never block forever on a
    full queue when the consumer abandons the epoch early (a step raises,
    KeyboardInterrupt); otherwise the thread and depth+1 device-resident
    batches would leak per aborted epoch."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            batches = iter(gen)
            while True:
                with profiling.span("fit.produce"):
                    item = next(batches, q)  # the queue marks the end
                if item is q:
                    break
                if not put(("ok", item)):
                    return
        except BaseException as e:  # noqa: BLE001 — reraised on the consumer
            put(("err", e))
            return
        put(("end", None))

    # The producer's spans are children of the span that started it.
    t = threading.Thread(target=contextvars.copy_context().run, args=(run,), daemon=True)
    t.start()
    try:
        while True:
            with profiling.span("fit.wait_batch"):
                kind, item = q.get()
            if kind == "err":
                raise item
            if kind == "end":
                return
            yield item
    finally:
        stop.set()
        t.join()
        # Drop buffered batches so their device memory frees promptly.
        while not q.empty():
            q.get_nowait()


def _epoch_loop(
    train_cfg, train_inputs, train_labels, val_inputs, val_labels,
    params, opt, live, step, evaluate, plateau, logger, ckpt,
    n, rng, history, start_epoch, epochs, verbose, place_batch,
    save_state, staged=None, stream_ds=None, val_producer_fn=None,
):
    for epoch in range(start_epoch, epochs):
        with profiling.span("fit.epoch", epoch=epoch):
            t0 = time.time()
            if staged is not None:
                loss, mse_, val_loss = _staged_epoch(staged, train_cfg, params, opt, rng, n, epoch)
            else:
                if stream_ds is not None:
                    producer = _stream_producer(stream_ds, train_cfg, epoch, place_batch)
                else:
                    producer = _host_producer(
                        train_cfg, train_inputs, train_labels, rng, n, place_batch, epoch,
                    )
                loss, mse_, val_loss = _run_host_epoch(
                    producer, train_cfg, val_inputs, val_labels, step, evaluate, place_batch,
                    val_producer_fn,
                )

            with profiling.span("fit.epoch_end"):
                new_lr = plateau.step(val_loss)
                if new_lr != get_lr(opt):
                    set_lr(opt, new_lr)

                # Publish the state BEFORE the history appends: if an interrupt
                # lands between them the checkpoint under-counts the epoch (safe:
                # one epoch re-runs on resume) rather than skipping one.
                if train_cfg.out_dir:
                    live.update(_snapshot(params, opt))
                history["loss"].append(loss)
                history["val_loss"].append(val_loss)
                history["mse"].append(mse_)
                history["lr"].append(new_lr)
                if logger:
                    logger.on_epoch_end(epoch, loss, val_loss, new_lr, last=epoch == epochs - 1)
                if ckpt:
                    ckpt.maybe_save(val_loss, params)
                # Periodic full-state checkpoint (resume after any crash, not only
                # an interrupt), and one on the final epoch so that a finished run
                # can be extended.
                done = len(history["loss"])
                if train_cfg.state_every and (
                    done % train_cfg.state_every == 0 or epoch == epochs - 1
                ):
                    save_state()
                if verbose:
                    print(
                        f"epoch {epoch}: loss {loss:.3e} val {val_loss:.3e} "
                        f"lr {new_lr:.1e} ({time.time() - t0:.1f}s)"
                    )


def _staged_epoch(staged, train_cfg, params, opt, rng, n, epoch):
    """One epoch on the device-resident dataset (train/staged.py): the
    permutation, mask and codes go up once, three scalars come back once."""
    from dsen2_tpu_torch.train.staged import epoch_aug_codes, pad_perm

    idx, mask = pad_perm(rng.permutation(n), train_cfg.batch_size)
    aug = epoch_aug_codes(train_cfg.seed, epoch, *idx.shape)
    dev = staged.val_idx.device
    with profiling.span("fit.train"):
        loss, mse_ = staged.train_epoch(
            params, opt, staged.train_inputs, staged.train_labels,
            upload(idx, dev), upload(mask, dev), upload(aug, dev),
        )
    profiling.count("train.samples", n)
    with profiling.span("fit.validate"):
        vloss, _ = staged.eval_epoch(
            params, staged.val_inputs, staged.val_labels, staged.val_idx, staged.val_mask
        )
    with profiling.span("fit.readback"):
        loss, mse_, vloss = torch.stack((loss, mse_, vloss)).cpu().tolist()
    return loss, mse_, vloss


def _epoch_augmenter(train_cfg, epoch):
    """Returns augment(arrs, step_i, count) applying the per-(seed, epoch)
    dihedral codes on the host, or a passthrough when augmentation is off."""
    if not train_cfg.augment:
        return lambda arrs, step_i, count: arrs
    from dsen2_tpu_torch.ops.dihedral import dihedral_np
    from dsen2_tpu_torch.train.staged import epoch_aug_codes

    # Codes are consumed positionally; the table grows on demand
    # (epoch_aug_codes is a pure function of (seed, epoch, shape), and a
    # larger table is a prefix-extension of a smaller one).
    state = {"codes": None}

    def augment(arrs, step_i, count):
        if state["codes"] is None or step_i >= state["codes"].shape[0]:
            grow = max(64, 2 * (step_i + 1))
            state["codes"] = epoch_aug_codes(
                train_cfg.seed, epoch, grow, train_cfg.batch_size
            )
        c = state["codes"][step_i, :count]
        return [
            np.stack([dihedral_np(a[j], c[j]) for j in range(count)])
            for a in arrs
        ]

    return augment


def _host_producer(train_cfg, train_inputs, train_labels, rng, n, place_batch, epoch):
    """Batch producer over in-RAM arrays: global shuffle (Keras semantics)."""
    perm = rng.permutation(n)
    augment = _epoch_augmenter(train_cfg, epoch)

    def produce():
        for step_i, i in enumerate(range(0, n, train_cfg.batch_size)):
            idx = perm[i : i + train_cfg.batch_size]
            arrs = augment(
                [a[idx] for a in train_inputs] + [train_labels[idx]],
                step_i, len(idx),
            )
            yield len(idx), place_batch(arrs[:-1]), place_batch([arrs[-1]])[0]

    return produce()


def _stream_producer(stream_ds, train_cfg, epoch, place_batch):
    """Batch producer over a StreamingPatchDataset (data/streaming.py):
    tile-shuffled stream, augmented like the in-RAM producer."""
    augment = _epoch_augmenter(train_cfg, epoch)

    def produce():
        for step_i, (cnt, bin_, blb) in enumerate(
            stream_ds.epoch_batches(epoch, train_cfg.batch_size)
        ):
            arrs = augment(list(bin_) + [blb], step_i, cnt)
            yield cnt, place_batch(arrs[:-1]), place_batch([arrs[-1]])[0]

    return produce()


def _run_host_epoch(producer, train_cfg, val_inputs, val_labels, step, evaluate, place_batch,
                    val_producer_fn=None):
    """One epoch fed from the host, with background double-buffering. The
    step and val losses stay on the device and come back in one copy.
    val_producer_fn (streaming datasets) replaces the in-RAM val arrays
    with a per-epoch bounded-memory batch producer."""
    losses, mses, weights = [], [], []
    with profiling.span("fit.train"):
        for cnt, binputs, btarget in _prefetch(producer):
            loss, mse_ = step(binputs, btarget)
            profiling.count("train.samples", cnt)
            losses.append(loss)
            mses.append(mse_)
            weights.append(cnt)

    if val_producer_fn is not None:
        val_producer = val_producer_fn()
    else:
        n_val = val_labels.shape[0]

        def produce_val():
            for i in range(0, n_val, train_cfg.batch_size):
                idx = np.arange(i, min(i + train_cfg.batch_size, n_val))
                yield (
                    len(idx),
                    place_batch([a[idx] for a in val_inputs]),
                    place_batch([val_labels[idx]])[0],
                )

        val_producer = produce_val()

    vl, vw = [], []
    with profiling.span("fit.validate"):
        for cnt, vi, vt in _prefetch(val_producer):
            vl.append(evaluate(vi, vt)[0])
            vw.append(cnt)
    k = len(losses)
    with profiling.span("fit.readback"):
        host = torch.stack(losses + mses + vl).cpu().numpy().astype(np.float64)
    w = np.asarray(weights, np.float64)
    loss = float(np.average(host[:k], weights=w))
    mse_ = float(np.average(host[k : 2 * k], weights=w))
    val_loss = float(np.average(host[2 * k :], weights=np.asarray(vw, np.float64)))
    return loss, mse_, val_loss
