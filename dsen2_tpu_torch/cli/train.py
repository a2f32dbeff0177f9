"""Training CLI of the port.

The counterpart of dsen2_tpu/cli/train.py, with the same flags. Capability
match for training/supres_train.py's argument surface (:111-118): --predict
WEIGHTS, --resume WEIGHTS, --true, --run_60, --deep, --path DIR, plus
--epochs, --lr, --batch-size, --seed, --augment, --precision, --state-every,
--stage-data and --smoke.

Fresh runs train DSen2 (6x128, batch 128) or VDSen2 (--deep: 32x256, batch
8, with each block recomputed in the backward) with Keras-2 Nadam + MAE,
plateau LR and best-val checkpoints to
<path>/network_data/{model_nr}lr_{lr:.0e}.npz (and .hdf5 where h5py is
installed): the reference's layout and names. --resume takes a Keras .hdf5
(where h5py is installed) or an .npz of weights, or a full-state directory
written by a previous run of the port (exact-trajectory resume). --stream
reads the tile archives off disk one tile at a time
(data/streaming.py::StreamingPatchDataset) instead of loading them in RAM.

Usage:
  python -m dsen2_tpu_torch.cli.train --smoke [--path DIR]
  python -m dsen2_tpu_torch.cli.train --path data/ [--run_60] [--deep] ...

It runs on the GPU; main(argv, device="cpu") runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time

import numpy as np
import torch


def _load_weights(path: str, cfg):
    from dsen2_tpu_torch.weights import load_keras_weights, load_params_npz

    if path.endswith(".npz"):
        return load_params_npz(path)
    return load_keras_weights(path, cfg)


def _model_nr_of(path: str):
    """The 7-character run prefix of a '{model_nr}lr_{lr:.0e}' weights file
    name (reference: training/supres_train.py:183), or None."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return stem[-15:-8] if len(stem) >= 15 else None


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description="Train / batch-predict DSen2 networks.")
    ap.add_argument("--predict", dest="predict_file",
                    help="weights file (.hdf5 or .npz); run batch prediction")
    ap.add_argument(
        "--resume", dest="resume_file",
        help="weights file, Keras .hdf5 or .npz (weights-only resume, "
        "reference parity), OR a full-state directory written by a previous "
        "run (exact-trajectory resume)",
    )
    ap.add_argument("--true", action="store_true", help="true-scale data (no simulation)")
    ap.add_argument("--run_60", action="store_true", help="train the 6x (60m->10m) network")
    ap.add_argument("--deep", action="store_true", help="VDSen2 (32 resblocks x 256)")
    ap.add_argument("--path", default="./data/", help="data root")
    # lr/batch-size/seed/augment default to None, so that an explicit flag is
    # told apart from an omitted one even when it equals the default: a
    # full-state resume adopts the checkpointed value only for omitted flags.
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None, help="default 1e-4")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--model-nr", default="s2_038_", help="7-char run prefix")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed for init, shuffling and augmentation (default 0)")
    ap.add_argument("--augment", action=argparse.BooleanOptionalAction, default=None,
                    help="random flip/rot90 augmentation (the paper's protocol)")
    ap.add_argument("--precision", default="high", choices=["highest", "high", "default"],
                    help="conv precision: highest=true f32, high=bf16x3 (default; "
                    "~3e-5 rel err), default=one bf16 pass")
    ap.add_argument("--state-every", type=int, default=25,
                    help="full-state (resumable) checkpoint cadence in epochs; 0 "
                    "disables the periodic save")
    ap.add_argument("--stage-data", action="store_true",
                    help="put the dataset on the device once and index it there")
    ap.add_argument("--stream", action="store_true",
                    help="stream tile archives off disk instead of loading "
                    "all patches in RAM (for datasets beyond host memory)")
    ap.add_argument("--smoke", action="store_true",
                    help="2-epoch training on synthetic data (self-test)")
    args = ap.parse_args(argv)

    from dsen2_tpu_torch.core import config
    from dsen2_tpu_torch.core.bands import SCALE

    cfg = (config.dsen2_6x if args.run_60 else config.dsen2_2x)(args.deep)
    batch = args.batch_size or (8 if args.deep else 128)

    if args.smoke:
        rng = np.random.default_rng(0)
        n = 64
        shapes = [(n, 32, 32, c) for c in cfg.in_channels]
        inputs = tuple(rng.random(s, dtype=np.float32) for s in shapes)
        labels = rng.random((n, 32, 32, cfg.out_channels), dtype=np.float32)
        tcfg = config.TrainConfig(lr=args.lr if args.lr is not None else 1e-4,
                                  batch_size=16, model_nr=args.model_nr,
                                  out_dir=os.path.join(args.path, "network_data"))
        from dsen2_tpu_torch.train.loop import fit

        _, hist = fit(cfg, tcfg,
                      tuple(a[:48] for a in inputs), labels[:48],
                      tuple(a[48:] for a in inputs), labels[48:],
                      epochs=2, precision=args.precision, remat=args.deep,
                      verbose=True, device=device)
        ok = np.isfinite(hist["loss"]).all()
        print(f"smoke: loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} ok={ok}")
        return 0 if ok else 1

    if args.predict_file:
        return _predict(args, cfg, device)

    from dsen2_tpu_torch.data.patches_dataset import open_data_files
    from dsen2_tpu_torch.train.loop import fit

    params = None
    resume_kwargs = {}
    model_nr = args.model_nr
    full_state_resume = bool(args.resume_file) and os.path.isdir(args.resume_file)
    if args.resume_file:
        print(f"Resuming from {args.resume_file}")
        if full_state_resume:
            # State dirs are named {model_nr}state / {model_nr}interrupted.
            base = os.path.basename(os.path.normpath(args.resume_file))
            for suffix in ("interrupted", "state"):
                if base.endswith(suffix) and len(base) > len(suffix):
                    model_nr = base[: -len(suffix)]
                    print(f"Changing the model number to: {model_nr}")
                    break
        else:
            params = _load_weights(args.resume_file, cfg)
            found = _model_nr_of(args.resume_file)
            if found:
                model_nr = found
                print(f"Changing the model number to: {model_nr}")

    lr = 1e-4 if args.lr is None else args.lr
    augment = bool(args.augment)
    seed = 0 if args.seed is None else args.seed
    tcfg = config.TrainConfig(
        lr=lr, batch_size=batch, model_nr=model_nr,
        out_dir=os.path.join(args.path, "network_data"),
        augment=augment, seed=seed, state_every=args.state_every,
    )
    if full_state_resume:
        from dsen2_tpu_torch.train.loop import restore_fit_state

        resume_kwargs = restore_fit_state(args.resume_file, cfg, tcfg, warn_mismatch=False)
        print(f"Restored full state at epoch {resume_kwargs['start_epoch']}")
        # Continue the checkpointed run's recorded flags, so that a bare
        # `--resume DIR` replays the exact trajectory; an explicit flag wins
        # but is called out as a trajectory change.
        flags = resume_kwargs.pop("train_flags", None)
        if flags:
            overrides = {
                "lr": args.lr is not None,
                "batch_size": args.batch_size is not None,
                "augment": args.augment is not None,
                "seed": args.seed is not None,
            }
            current = {"lr": lr, "batch_size": batch, "augment": augment, "seed": seed}
            for k, v in flags.items():
                if k not in current:
                    continue
                if overrides[k] and current[k] != v:
                    print(
                        f"WARNING: --{k.replace('_', '-')} {current[k]!r} overrides "
                        f"the checkpointed {v!r}; the trajectory will diverge."
                    )
                    if k == "lr":
                        # The restored optimizer and plateau carry the
                        # checkpointed lr; the override must drive the
                        # updates, and the new lr names a new checkpoint
                        # file, whose best is not the old file's.
                        resume_kwargs["force_lr"] = current[k]
                        resume_kwargs.pop("best_val", None)
                else:
                    current[k] = type(current[k])(v) if current[k] is not None else v
            lr, batch, augment, seed = (
                current["lr"], current["batch_size"], current["augment"], current["seed"],
            )
            tcfg = config.TrainConfig(
                lr=lr, batch_size=batch, model_nr=model_nr,
                out_dir=tcfg.out_dir, augment=augment, seed=seed,
                state_every=args.state_every,
            )
        elif args.lr is not None:
            # A checkpoint without recorded flags: an explicit --lr must still
            # beat the restored optimizer's lr. Reset the best-checkpoint gate
            # only when the lr changes the checkpoint's file name.
            resume_kwargs["force_lr"] = lr
            m = re.search(r"lr_([0-9.eE+-]+)(?:\.(?:hdf5|npz))?$",
                          os.path.basename(args.resume_file.rstrip("/")))
            old_lr = None
            if m:
                try:
                    old_lr = float(m.group(1))
                except ValueError:
                    pass
            if old_lr is None or f"{old_lr:.0e}" != f"{lr:.0e}":
                resume_kwargs.pop("best_val", None)
    if not args.resume_file:
        # Fresh runs keep the architecture summary (the reference dumps
        # model.yaml + plot_model PNG, supres_train.py:189-193).
        from dsen2_tpu_torch.models.s2net import summary

        os.makedirs(tcfg.out_dir, exist_ok=True)
        with open(os.path.join(tcfg.out_dir, model_nr + "model.txt"), "w") as fh:
            fh.write(summary(cfg) + "\n")
    if params is not None:
        resume_kwargs["params"] = params

    print("Loading the training data...")
    if args.stream:
        from dsen2_tpu_torch.data.streaming import StreamingPatchDataset

        # One seed domain for the run: the streaming batch order draws from
        # the same seed as init, shuffling and augmentation.
        train_in = StreamingPatchDataset(args.path, args.run_60, SCALE, seed=tcfg.seed)
        train_lb = val_in = val_lb = None
        print(
            f"Streaming {train_in.n_train} train / {train_in.n_val} val "
            f"patches from {len(train_in.dsets)} tiles."
        )
    else:
        train_in, train_lb, val_in, val_lb = open_data_files(args.path, args.run_60, SCALE)
        print(f"Loaded {train_lb.shape[0]} train / {val_lb.shape[0]} val patches.")
    fit(cfg, tcfg, train_in, train_lb, val_in, val_lb,
        epochs=args.epochs, remat=args.deep, precision=args.precision,
        stage_data=args.stage_data, device=device, **resume_kwargs)
    return 0


def _predict(args, cfg, device=None) -> int:
    """Batch prediction over prepared test archives
    (reference: supres_train.py:149-179): each archive is read off memmaps in
    batches of 8 and every predicted interior is written into the output
    mosaic in the archive's order (last write wins, as ops/tiling.recompose
    does), so host memory holds the mosaic and one batch, not the archive."""
    from dsen2_tpu_torch.core.bands import SCALE
    from dsen2_tpu_torch.core.device import resolve_device, upload
    from dsen2_tpu_torch.data.patches_dataset import open_data_files_test_stream
    from dsen2_tpu_torch.models import s2net
    from dsen2_tpu_torch.ops.tiling import recompose_positions
    from dsen2_tpu_torch.weights import params_to_torch

    if args.true:
        folder, border = "true/", 12
    elif args.run_60:
        folder, border = "test60/", 12
    else:
        folder, border = "test/", 4

    dev = resolve_device(device)
    model_nr = _model_nr_of(args.predict_file) or "predict"
    print(f"Changing the model number to: {model_nr}")
    params = params_to_torch(_load_weights(args.predict_file, cfg), dev)
    print(f"Predicting using file: {args.predict_file}")

    dsets = sorted(glob.glob(os.path.join(args.path, folder, "*SAFE")))
    if not dsets:
        print(f"no test archives under {args.path}{folder}", file=sys.stderr)
        return 1
    for dset in dsets:
        start = time.time()
        print(f"Predicting: {os.path.basename(dset)}.")
        batches, image_size, n, patch_px = open_data_files_test_stream(
            dset, args.run_60, SCALE, batch_size=8
        )
        h, w = int(image_size[0]), int(image_size[1])
        interior = patch_px - 2 * border
        if interior > h or interior > w:
            raise ValueError(f"patch interior {interior} exceeds the image ({h}, {w})")
        pos = recompose_positions((h, w), interior)
        if n < len(pos):
            # A truncated archive must raise, not save a partial mosaic.
            raise ValueError(
                f"got {n} patches, grid needs {len(pos)} for image "
                f"({h}, {w}) with interior {interior}"
            )
        images = np.zeros((h, w, cfg.out_channels), np.float32)
        # Patches beyond the grid are the reference's zero slack slots
        # (utils/patches.py:35); they are read but not predicted.
        for i, batch in enumerate(batches):
            k = min(len(pos) - 8 * i, len(batch[0]))
            if k <= 0:
                continue
            batch_in = [upload(a[:k], dev) for a in batch]
            with torch.no_grad():
                pred = s2net.apply(params, batch_in, cfg, precision="high",
                                   use_kernels=None).cpu().numpy()
            for j, (y, x) in enumerate(pos[8 * i : 8 * i + k]):
                images[y : y + interior, x : x + interior] = pred[
                    j, border : patch_px - border, border : patch_px - border
                ]
        out = os.path.join(dset, model_nr + "-predict.npy")
        print("Writing to file...")
        np.save(out, images * SCALE)
        print(f"Elapsed time: {time.time() - start}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
