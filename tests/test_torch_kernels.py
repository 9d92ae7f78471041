"""The port's kernel wrappers (pothoscomms_tpu_torch.kernels) on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version;
here that plain version is held against the JAX package's Pallas kernels
(interpret mode, as the JAX package's own tests run them on the CPU) at
shapes those kernels take, and against numpy. Also: CPU tensors never
count as launches, wrappers refuse what their kernel does not take, and
the loader raises (never falls back) without nvcc.

Tolerances: cgemm at scaled atol 3e-6 and the FFT at 2e-5, as the JAX
package's tests (tests/test_parallel.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pothoscomms_tpu.parallel.fft import dft_matrices as jdft_matrices
from pothoscomms_tpu.parallel.pallas_kernels import cmatmul, fft_planar_fused
from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.kernels.cgemm import cgemm
from pothoscomms_tpu_torch.kernels.fft import fft_c2c, fft_c2c_plain

torch.set_num_threads(1)


def _scaled_err(got, exp):
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


@pytest.mark.parametrize("b,n", [(64, 256), (3, 100)])
def test_cgemm_matches_jax_cmatmul(b, n):
    """(64, 256) tiles, so JAX runs its Pallas kernel; (3, 100) does not,
    so JAX falls back to jnp matmuls while the port's kernel masks the
    ragged edges."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, n, 2)).astype(np.float32)
    fr, fi = jdft_matrices(n, False)
    exp = np.asarray(cmatmul(jnp.asarray(x), fr, fi, interpret=True))
    got = cgemm(torch.from_numpy(x), torch.from_numpy(fr),
                torch.from_numpy(fi)).numpy()
    assert got.shape == (b, n, 2)
    assert _scaled_err(got, exp) < 3e-6
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    ref = np.fft.fft(xc, axis=-1)
    assert _scaled_err(got[..., 0] + 1j * got[..., 1], ref) < 3e-6


def test_fft_c2c_matches_jax_pallas_fused_fft():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(64, 1024, 2)).astype(np.float32)
    exp = np.asarray(fft_planar_fused(jnp.asarray(x), 1024, False,
                                      interpret=True))
    got = fft_c2c(torch.from_numpy(x)).numpy()
    assert _scaled_err(got, exp) < 2e-5


@pytest.mark.parametrize("n", [1, 2, 16, 100, 384])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_c2c_plain_matches_numpy(n, inverse):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(4, n, 2)).astype(np.float32)
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    ref = np.fft.ifft(xc, axis=-1) * n if inverse else np.fft.fft(xc, axis=-1)
    got = fft_c2c_plain(torch.from_numpy(x), inverse).numpy()
    assert _scaled_err(got[..., 0] + 1j * got[..., 1], ref) < 2e-5


def test_cpu_tensors_never_count_as_launches():
    from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain

    before = (cgemm.launches, fft_c2c.launches)
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(8, 64, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    cgemm(x, g, g)
    fft_c2c(x)
    taps = rng.normal(size=200)  # conv branch: FFT on K2
    run, hist = fir_fft_chain(taps, 64, 2, 256, device="cpu")
    run(torch.from_numpy(rng.normal(size=(2, 256, 2)).astype(np.float32)),
        hist)
    assert (cgemm.launches, fft_c2c.launches) == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    a = torch.zeros(4, 8, 2)
    g = torch.zeros(8, 3)
    with pytest.raises(ValueError):          # no kernel and no plain path
        cgemm(a.to("meta"), g.to("meta"), g.to("meta"))
    with pytest.raises(ValueError):
        fft_c2c(a.to("meta"))
    with pytest.raises(TypeError):
        cgemm(a.double(), g, g)
    with pytest.raises(TypeError):
        fft_c2c(a.double())
    with pytest.raises(ValueError):          # N mismatch
        cgemm(a, torch.zeros(7, 3), torch.zeros(7, 3))
    with pytest.raises(ValueError):          # gi of another shape
        cgemm(a, g, torch.zeros(8, 4))
    with pytest.raises(ValueError):
        cgemm(a[0], g, g)                    # not [B, N, 2]


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load.__wrapped__("cgemm")
    assert not (tmp_path / "build").exists()


def test_check_raises_on_cuda_error():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.check(700, "cgemm_f32")
