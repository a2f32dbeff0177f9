"""Weight-format conversion CLI of the port: Keras-2 HDF5 <-> portable .npz.

The counterpart of dsen2_tpu/cli/convert_weights.py on the port's weights/
(host numpy and h5py; no device). Completes the interchange story with the
reference tooling: its HDF5 checkpoints (testing/supres.py:57,60 naming)
load here unchanged, and weights trained here export back to HDF5 the
reference can consume. .hdf5 needs h5py; .npz needs only numpy.

Usage:
  python -m dsen2_tpu_torch.cli.convert_weights IN OUT [--deep] [--run_60]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert DSen2 weight files.")
    ap.add_argument("input", help=".hdf5 or .npz weights")
    ap.add_argument("output", help=".hdf5 or .npz destination")
    ap.add_argument("--run_60", action="store_true", help="6x network layout")
    ap.add_argument("--deep", action="store_true", help="VDSen2 layout")
    args = ap.parse_args(argv)

    for path, what in ((args.input, "input"), (args.output, "output")):
        if not (path.endswith(".hdf5") or path.endswith(".h5") or path.endswith(".npz")):
            ap.error(f"{what} must end in .hdf5/.h5 or .npz, got: {path}")

    from dsen2_tpu_torch.core.config import dsen2_2x, dsen2_6x
    from dsen2_tpu_torch.weights import (
        load_keras_weights,
        load_params_npz,
        save_keras_weights,
        save_params_npz,
    )

    cfg = (dsen2_6x if args.run_60 else dsen2_2x)(args.deep)

    if args.input.endswith(".npz"):
        params = load_params_npz(args.input)
    else:
        params = load_keras_weights(args.input, cfg)

    if args.output.endswith(".npz"):
        save_params_npz(args.output, params)
    else:
        save_keras_weights(args.output, params)
    from dsen2_tpu_torch.models.s2net import param_count

    print(f"{args.input} -> {args.output} ({param_count(params):,} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
