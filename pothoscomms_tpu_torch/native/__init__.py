"""Host (C++) kernels of the port, loaded with ctypes: the Galois LFSR,
the multiplicative scrambler and descrambler, CRC8 and checksum8
(``src/comms_native.cpp``).

The library is built with g++ at first use into
``build/torch_kernels/libcomms_native-<hash>.so`` at the root of the
checkout (the hash covers the source and the flags), beside the CUDA
libraries of :mod:`pothoscomms_tpu_torch.kernels.build`. There is no
fallback: without g++, or when g++ fails, :func:`get_lib` raises. The
load runs inside the build span ``pc.build.library.comms_native``, g++'s
seconds going to the build record's ``compiled``
(``parallel/profiling.build``). The
Python ``GaloisLFSR`` of ``blocks/digital.py`` stays as the contract the
tests hold this library to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from pothoscomms_tpu_torch.kernels.build import BUILD_DIR
from pothoscomms_tpu_torch.parallel import profiling

SRC = Path(__file__).resolve().parent / "src" / "comms_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MASK64 = (1 << 64) - 1


class _GLfsrState(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_uint64),
        ("polynomial", ctypes.c_uint64),
        ("mask", ctypes.c_uint64),
    ]


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """Build (once per source content) and load the library."""
    with profiling.build("pc.build.library.comms_native"):
        return _build_and_load()


def _build_and_load() -> ctypes.CDLL:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libcomms_native-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True)
        profiling.compiled("comms_native", time.perf_counter() - t0)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on {SRC.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)  # atomic: a concurrent build sees no half file
    lib = ctypes.CDLL(str(so))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    state = ctypes.POINTER(_GLfsrState)
    lib.glfsr_init.argtypes = [state, ctypes.c_uint64, ctypes.c_uint64]
    lib.glfsr_keystream.argtypes = [state, u8p, ctypes.c_size_t]
    lib.scramble_mult.argtypes = [state, u8p, u8p, ctypes.c_size_t]
    lib.descramble_mult.argtypes = [state, u8p, u8p, ctypes.c_size_t]
    for name in ("crc8", "checksum8"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_size_t]
        fn.restype = ctypes.c_uint8
    return lib


class NativeLfsr:
    """Galois LFSR on the C++ kernels, with the Python ``GaloisLFSR``'s
    interface (``data``, ``keystream``, ``scramble_mult``,
    ``descramble_mult``)."""

    def __init__(self, polynomial: int, seed: int):
        self._lib = get_lib()
        self._state = _GLfsrState()
        self._lib.glfsr_init(ctypes.byref(self._state), polynomial & MASK64,
                             seed & MASK64)

    @property
    def data(self) -> int:
        return self._state.data

    @data.setter
    def data(self, v: int):
        self._state.data = v & MASK64

    def keystream(self, n: int) -> np.ndarray:
        out = np.empty(n, np.uint8)
        self._lib.glfsr_keystream(ctypes.byref(self._state), out, n)
        return out

    def _mult(self, fn, bits) -> np.ndarray:
        bits = np.ascontiguousarray(bits, np.uint8)
        out = np.empty(len(bits), np.uint8)
        fn(ctypes.byref(self._state), bits, out, len(bits))
        return out

    def scramble_mult(self, bits: np.ndarray) -> np.ndarray:
        return self._mult(self._lib.scramble_mult, bits)

    def descramble_mult(self, bits: np.ndarray) -> np.ndarray:
        return self._mult(self._lib.descramble_mult, bits)


def crc8(data) -> int:
    arr = np.ascontiguousarray(data, np.uint8)
    return int(get_lib().crc8(arr, arr.size))


def checksum8(data) -> int:
    arr = np.ascontiguousarray(data, np.uint8)
    return int(get_lib().checksum8(arr, arr.size))
