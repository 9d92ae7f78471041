"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``BUILD_DIR/lib<name>-<hash>.so`` (the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds): ``build/torch_kernels`` at the root of a
source checkout, the user's cache for an installed wheel
(:func:`build_dir`). The
compiler's output, including ``-Xptxas -v``'s register and shared-memory
report, is kept beside the library as ``lib<name>-<hash>.log``.

There is no fallback: without nvcc, or when nvcc fails, :func:`load`
raises.

A load runs inside the build span ``pc.build.library.<name>``
(``parallel/profiling.build``): the hash, nvcc where the library is
missing, and the ``ctypes`` load; nvcc's seconds go to the build record's
``compiled``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from pothoscomms_tpu_torch.parallel import profiling


def build_dir(package: Path) -> Path:
    """Where the libraries of ``package`` (the ``pothoscomms_tpu_torch``
    directory) are built: ``build/torch_kernels`` beside it in a source
    checkout (whose root holds ``pyproject.toml``); else, for an installed
    wheel, ``pothoscomms_tpu_torch/torch_kernels`` under the user's cache
    (``$XDG_CACHE_HOME``, else ``~/.cache``), not in site-packages."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pothoscomms_tpu_torch" / "torch_kernels"


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_dir(CSRC.parent)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the CUDA toolkit's default prefix


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda.
    Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME, {DEFAULT_CUDA_HOME}): the CUDA "
        "kernels of pothoscomms_tpu_torch cannot be built")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per source content) and load it."""
    with profiling.build("pc.build.library." + name):
        return _compile_and_load(name)


def _compile_and_load(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        profiling.compiled(name, time.perf_counter() - t0)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                + proc.stderr[-4000:])
        os.replace(tmp, lib)  # atomic: a concurrent load sees no half file
    return ctypes.CDLL(str(lib))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
