"""The port's copies of jax-free modules equal their originals, the port
imports neither JAX nor dsen2_tpu, and the tracked tree stays small."""

import ast
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest

from dsen2_tpu.core import bands as jbands
from dsen2_tpu.core import config as jconfig
from dsen2_tpu.models import s2net as js2net
from dsen2_tpu.ops import resize_weights as jrw
from dsen2_tpu.ops import tiling as jtiling
from dsen2_tpu_torch.core import bands as tbands
from dsen2_tpu_torch.core import config as tconfig
from dsen2_tpu_torch.models import s2net as ts2net
from dsen2_tpu_torch.ops import resize_weights as trw
from dsen2_tpu_torch.ops import tiling as ttiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resize_weights_is_a_verbatim_copy():
    with open(jrw.__file__, "rb") as a, open(trw.__file__, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("fn,args", [
    ("bilinear_matrix", (8, 16)), ("bilinear_matrix", (1, 5)), ("bilinear_matrix", (16, 96)),
    ("matlab_cubic_matrix", (12, 24)), ("matlab_cubic_matrix", (24, 12)),
    ("gaussian_blur_matrix", (18, 0.5)), ("block_mean_matrix", (18, 6)),
    ("wald_downsample_matrix", (36, 6)),
])
def test_resize_weights_bit_equal(fn, args):
    np.testing.assert_array_equal(getattr(trw, fn)(*args), getattr(jrw, fn)(*args))


def test_band_constants_equal():
    for name in ("SCALE", "INTERP_NORM", "BANDS_10M", "BANDS_20M", "BANDS_60M",
                 "SELECT_BANDS_20", "SELECT_BANDS_60"):
        assert getattr(tbands, name) == getattr(jbands, name), name
    assert tbands.TileSpec(60, 120).h60 == jbands.TileSpec(60, 120).h60


def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_config_copies_equal():
    assert _fields(tconfig.ModelConfig) == _fields(jconfig.ModelConfig)
    want = _fields(jconfig.InferConfig)
    want["use_kernels"] = want.pop("use_pallas")
    assert _fields(tconfig.InferConfig) == want
    for deep in (False, True):
        for t, j in ((tconfig.dsen2_2x, jconfig.dsen2_2x), (tconfig.dsen2_6x, jconfig.dsen2_6x)):
            a, b = t(deep), j(deep)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.out_channels, a.total_in_channels, a.run_60) == (
                b.out_channels, b.total_in_channels, b.run_60)


@pytest.mark.parametrize("geom", [(60, 54, 32, 4), (24, 24, 16, 2), (13, 29, 8, 1), (12, 12, 12, 0)])
def test_patch_grid_copy_equal(geom):
    t, j = ttiling.PatchGrid(*geom), jtiling.PatchGrid(*geom)
    assert (t.stride, t.starts_i, t.starts_j, t.num_patches) == (
        j.stride, j.starts_i, j.starts_j, j.num_patches)
    np.testing.assert_array_equal(t.flat_starts(), j.flat_starts())
    assert t.flat_starts().dtype == np.int32
    assert dataclasses.asdict(t.scaled(3)) == dataclasses.asdict(j.scaled(3))


def test_patch_grid_rejects_small_extent():
    with pytest.raises(ValueError, match="smaller than the patch interior"):
        ttiling.PatchGrid(4, 4, 16, 2).starts_i


def test_stack_block_params_and_summary_equal(rng):
    blocks = [{k: rng.standard_normal((2, 3)) for k in ("w1", "b1", "w2", "b2")} for _ in range(3)]
    a, b = ts2net.stack_block_params(blocks), js2net.stack_block_params(blocks)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for cfg in (tconfig.dsen2_2x(False), tconfig.dsen2_6x(True)):
        jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
        assert ts2net.summary(cfg) == js2net.summary(jcfg)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dsen2_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_dsen2_tpu():
    files = _port_files()
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"dsen2_tpu_torch/infer/engine.py", "dsen2_tpu_torch/ops/dihedral.py",
            "dsen2_tpu_torch/infer/metrics.py", "dsen2_tpu_torch/data/mat.py",
            "dsen2_tpu_torch/cli/demo.py", "dsen2_tpu_torch/geo/utm.py",
            "dsen2_tpu_torch/io/geotiff.py", "dsen2_tpu_torch/io/writers.py",
            "dsen2_tpu_torch/data/safe_pil.py", "dsen2_tpu_torch/data/safe_reader.py",
            "dsen2_tpu_torch/data/streaming.py", "dsen2_tpu_torch/utils/native.py",
            "dsen2_tpu_torch/utils/profiling.py", "dsen2_tpu_torch/cli/s2_supres.py",
            "dsen2_tpu_torch/cli/create_patches.py",
            "dsen2_tpu_torch/cli/convert_weights.py", "dsen2_tpu_torch/parallel/__init__.py",
            "dsen2_tpu_torch/parallel/mesh.py", "dsen2_tpu_torch/parallel/inference.py",
            "dsen2_tpu_torch/parallel/train_step.py"} <= names
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "dsen2_tpu"), f"{path} imports {name}"


def test_tracked_tree_stays_small():
    if shutil.which("git") is None:
        pytest.skip("git is not installed")
    res = subprocess.run(["git", "ls-files", "-z"], cwd=REPO, capture_output=True)
    if res.returncode != 0:
        pytest.skip("not a git checkout")
    files = [f for f in res.stdout.decode().split("\0") if f]
    total = sum(os.path.getsize(os.path.join(REPO, f)) for f in files
                if os.path.isfile(os.path.join(REPO, f)))
    assert total < 40 * 2**20, f"tracked tree is {total / 2**20:.1f} MiB"
    for stem in ("s2_033_lr_1e-04", "s2_034_lr_1e-04"):
        assert not any(os.path.basename(f).startswith(stem + ".") and
                       f.endswith((".npz", ".hdf5")) for f in files)
