"""The port's filter/window designers (pothoscomms_tpu_torch.design) give
arrays identical to the JAX package's (pothoscomms_tpu.design), bit for
bit: both are the same numpy code, copied so the port never imports jax.
"""

import numpy as np
import pytest
import torch

from pothoscomms_tpu import design as jdesign
from pothoscomms_tpu_torch import design

torch.set_num_threads(1)


def _same(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("name,arg", [
    ("rectangular", 0), ("hann", 0), ("hamming", 0), ("blackman", 0),
    ("bartlett", 0), ("flattop", 0), ("kaiser", 0), ("kaiser", 3.5),
    ("chebyshev", 0), ("chebyshev", 60.0)])
@pytest.mark.parametrize("n", [1, 32, 51])
def test_windows_identical(name, arg, n):
    _same(design.design_window(name, n, arg),
          jdesign.design_window(name, n, arg))


@pytest.mark.parametrize("filt", ["SINC", "MAXFLAT", "GAUSSIAN", "REMEZ",
                                  "RAISED_COSINE", "ROOT_RAISED_COSINE"])
@pytest.mark.parametrize("band,lo,hi", [
    ("LOW_PASS", 0.1, 0.0), ("HIGH_PASS", 0.2, 0.0),
    ("BAND_PASS", 0.1, 0.3), ("BAND_STOP", 0.1, 0.3)])
def test_fir_designs_identical(filt, band, lo, hi):
    args = (filt, band, 51, lo, hi, 0.3, 2.0)
    _same(design.design_fir(*args), jdesign.design_fir(*args))


@pytest.mark.parametrize("band", ["COMPLEX_BAND_PASS", "COMPLEX_BAND_STOP"])
@pytest.mark.parametrize("filt", ["SINC", "REMEZ", "ROOT_RAISED_COSINE"])
def test_complex_fir_designs_identical(filt, band):
    args = (filt, band, 41, -0.1, 0.25, 0.2, 1.0)
    _same(design.design_complex_fir(*args), jdesign.design_complex_fir(*args))


def test_remez_and_estimates_identical():
    bands, desired = [(0.0, 0.1), (0.15, 0.5)], [1.0, 0.0]
    _same(design.remez(41, bands, desired, [1.0, 10.0]),
          jdesign.remez(41, bands, desired, [1.0, 10.0]))
    for fn, args in (("remez_estimate_num_taps", (0.05, 0.1, 60.0)),
                     ("remez_estimate_atten", (51, 0.05, 0.1)),
                     ("remez_estimate_bw", (51, 0.1, 60.0)),
                     ("remez_estimate_weight", (0.1, 60.0))):
        assert getattr(design, fn)(*args) == getattr(jdesign, fn)(*args)


@pytest.mark.parametrize("kind", ["butterworth", "chebyshev", "chebyshev2",
                                  "elliptic"])
@pytest.mark.parametrize("band", ["LOW_PASS", "HIGH_PASS", "BAND_PASS",
                                  "BAND_STOP"])
def test_iir_designs_identical(kind, band):
    b, a = design.design_iir(kind, band, 4, 0.1, 0.5, 50.0, 0.25)
    jb, ja = jdesign.design_iir(kind, band, 4, 0.1, 0.5, 50.0, 0.25)
    _same(b, jb)
    _same(a, ja)


def test_validation_matches():
    for mod in (design, jdesign):
        with pytest.raises(ValueError):
            mod.design_window("nope", 8)
        with pytest.raises(ValueError):
            mod.design_fir("SINC", "NOPE", 11, 0.1)
        with pytest.raises(ValueError):
            mod.design_iir("butterworth", "LOW_PASS", 0, 0.1)
