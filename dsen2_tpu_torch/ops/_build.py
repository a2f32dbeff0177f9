"""Build and load the port's CUDA kernels.

`nvcc` compiles every `dsen2_tpu_torch/csrc/*.cu` into one shared library
with a plain C interface, at first use, into `build/kernels/` beside the
package (listed in .gitignore). The library's name carries a hash of the
sources, so an edit rebuilds and an unchanged tree reuses it. It is loaded
with ctypes. A failed build raises; nothing falls back. Each build adds to
the counters kernel.builds and kernel.build_s (utils/profiling), so a build
inside a measured stretch shows.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from dsen2_tpu_torch.utils import profiling

__all__ = ["load_library", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
# What the last build printed: path, seconds and ptxas's report: for each
# kernel its name, registers and spills, and any performance warning (C75xx:
# setmaxnreg ignored, wgmma serialized). The report is kept beside the
# library, so a cached build reads it back.
build_log: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.dsen2_split_planes.argtypes = [p, p, ll, i, p]
    lib.dsen2_split_planes.restype = i
    lib.dsen2_class_planes.argtypes = [p, p, p, ll, i, p]
    lib.dsen2_class_planes.restype = i
    lib.dsen2_conv3x3.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, i, i, p]
    lib.dsen2_conv3x3.restype = i
    lib.dsen2_conv3x3_clusters.argtypes = [i, i, i, i]
    lib.dsen2_conv3x3_clusters.restype = i
    lib.dsen2_conv3x3_pool.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.dsen2_conv3x3_pool.restype = i
    lib.dsen2_ca_gate.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dsen2_ca_gate.restype = i
    lp = ctypes.POINTER(ll)
    lib.dsen2_head.argtypes = [p, p, p, i, i, i, lp, p, p, p, p, i, i, i, i, i, p]
    lib.dsen2_head.restype = i
    lib.dsen2_tail.argtypes = [p, p, p, p, lp, p, i, i, i, i, i, i, p]
    lib.dsen2_tail.restype = i
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as fh:
                digest.update(os.path.basename(s).encode() + fh.read())
        digest.update(" ".join(_FLAGS).encode())
        path = os.path.join(_BUILD, f"libdsen2_kernels_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            t0 = time.perf_counter()
            res = subprocess.run(
                [_nvcc(), *_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True
            )
            seconds = time.perf_counter() - t0
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
            keep = ("Compiling entry function", "Function properties", "registers", "spill",
                    "C75")
            report = [ln.strip() for ln in res.stderr.splitlines() if any(k in ln for k in keep)]
            with open(tmp + ".ptxas", "w") as fh:
                fh.write("\n".join(report))
            os.replace(tmp + ".ptxas", path + ".ptxas")
            os.replace(tmp, path)
            build_log.update(path=path, seconds=seconds, ptxas=report)
            profiling.count("kernel.builds")
            profiling.count("kernel.build_s", seconds)
            print(f"dsen2_tpu_torch: built {os.path.basename(path)} in {seconds:.1f} s")
        else:
            report = []
            if os.path.exists(path + ".ptxas"):
                with open(path + ".ptxas") as fh:
                    report = fh.read().splitlines()
            build_log.update(path=path, seconds=0.0, ptxas=report)
        _lib = _declare(ctypes.CDLL(path))
        return _lib
