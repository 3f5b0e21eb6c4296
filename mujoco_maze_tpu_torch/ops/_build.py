"""Build and load the port's CUDA kernels: one ``nvcc`` call, one ``.so``.

All ``csrc/*.cu`` sources compile in a single ``nvcc`` invocation into a
shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch headers are included (that build takes minutes; this one takes
seconds), and there is no lock file: the library is written under a
temporary name and moved into place with ``os.replace``, so a build that
is killed leaves nothing that blocks or half-loads the next one.

The file name carries a hash of the sources and the flags, so an edited
source is rebuilt at first use.  Build output goes to
``mujoco_maze_tpu_torch/.kernel_build/`` (ignored by git).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / ".kernel_build"
# No fast-math flags: the wrap at ±pi and the crossing tests are knife
# edges.  -fmad=false keeps every multiply and add rounded on its own, as
# PyTorch's elementwise kernels (the plain versions) round them.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the current library is missing; returns its
    path.  Raises with nvcc's output on failure or timeout."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc timed out after {NVCC_TIMEOUT_S} s: {' '.join(cmd)}\n"
            f"{exc.stderr or ''}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    return ctypes.CDLL(str(build()))


def ptxas_report() -> str:
    """What ``ptxas -v`` says of each kernel (registers, stack frame, spill
    stores and loads, shared memory): the same sources and flags compiled
    once more into a throwaway library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"ptxas_report.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
    finally:
        tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    return proc.stderr


if __name__ == "__main__":
    # python -m mujoco_maze_tpu_torch.ops._build: build, then print the
    # ptxas report of every kernel
    import time

    t0 = time.perf_counter()
    print(f"built {build().name} in {time.perf_counter() - t0:.2f} s")
    print(ptxas_report())
