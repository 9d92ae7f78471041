"""Shared test helpers.

The port's counterpart of the reference's ``common/Testing.hpp``:
``stdVectorToBufferChunk`` (trivial here — numpy), ``stretchStdVector``
(replicate data so vectorized code paths execute, :40-57), and
``testBufferChunksEqual/Close`` (:67-93).
"""

from __future__ import annotations

import numpy as np

from pothoscomms_tpu_torch.core.dtypes import DType


def stretch_vector(values, factor: int) -> np.ndarray:
    """Repeat each element ``factor`` times (reference
    common/Testing.hpp:40-57)."""
    arr = np.asarray(values)
    return np.repeat(arr, factor, axis=0)


def to_complex_int(values, dtype) -> np.ndarray:
    """Convert complex python/numpy values to the trailing-(re,im) integer
    representation used for complex-int DTypes."""
    dtype = DType.parse(dtype)
    arr = np.asarray(values)
    out = np.stack([arr.real, arr.imag], axis=-1)
    return out.astype(dtype.scalar.np)


def from_complex_int(arr) -> np.ndarray:
    """Trailing-(re,im) int array -> numpy complex128 (for comparisons)."""
    arr = np.asarray(arr)
    return arr[..., 0].astype(np.float64) + 1j * arr[..., 1].astype(np.float64)


def assert_buffers_equal(expected, actual, msg=""):
    expected = np.asarray(expected)
    actual = np.asarray(actual)
    assert expected.shape == actual.shape, (
        f"{msg} shape mismatch: expected {expected.shape} got {actual.shape}"
    )
    np.testing.assert_array_equal(actual, expected, err_msg=msg)


def assert_buffers_close(expected, actual, epsilon=1e-6, msg=""):
    expected = np.asarray(expected)
    actual = np.asarray(actual)
    assert expected.shape == actual.shape, (
        f"{msg} shape mismatch: expected {expected.shape} got {actual.shape}"
    )
    np.testing.assert_allclose(actual, expected, atol=epsilon, rtol=0, err_msg=msg)


def sync_search_f64(x, pre, thr: float, sw: int, w: int, dw: int,
                    npre: int, n: int) -> dict:
    """Float64 numpy oracle of the frame-sync search's formulas
    (``kernels/sync_search.py``; reference FrameSync.cpp:595-693), which
    S1 and its plain version are held to.

    x: [C, L, 2] planar (any float type) or [C, L] complex; pre: [npre]
    complex. Returns a dict of [C, n] arrays: ``scale``, ``delta_fc``,
    ``phase_off``, ``abs_L`` (|L| before the floor), ``corr_peak``,
    ``borderline``: the offsets whose ``ok`` test has one of its
    comparisons within 1e-5 relative of its threshold, where float32
    rounding may take the other side; and ``ill_conditioned``: the
    accepted offsets whose K's terms cancel to below 1e-3 of the sum of
    their magnitudes (a noiseless window that straddles +1 and -1
    symbols), where float32 rounding alone moves delta_fc, and with it
    the whole correlation, by more than the bounds.
    """
    x = np.asarray(x)
    xc = (x[..., 0].astype(np.float64) + 1j * x[..., 1].astype(np.float64)
          if x.shape[-1] == 2 and not np.iscomplexobj(x)
          else x.astype(np.complex128))
    pre = np.asarray(pre, np.complex128)
    i = np.arange(n)
    absx = np.abs(xc)
    cs = np.pad(np.cumsum(absx, axis=1), ((0, 0), (1, 0)))

    def winsum(lo, hi):
        return cs[:, i + hi] - cs[:, i + lo]

    half = w // 2
    sum0 = winsum(dw, half) / (half - dw)
    sum1 = winsum(sw - half, sw - dw) / (half - dw)
    a0, a1 = absx[:, i + dw], absx[:, i + sw - dw]
    ok = (a0 >= thr) & (a1 >= thr) & (sum0 >= thr) & (sum1 >= thr)
    s0 = sum0 / np.abs(pre[0])
    s1 = sum1 / np.abs(pre[-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(s1 != 0, s0 / np.where(s1 == 0, 1.0, s1), np.inf)
    ok &= (ratio <= 2) & (ratio >= 0.5)
    rel = [np.abs(v - thr) / thr for v in (a0, a1, sum0, sum1)] if thr \
        else []
    with np.errstate(invalid="ignore"):
        rel += [np.abs(ratio - 2) / 2, np.abs(ratio - 0.5) / 0.5]
    borderline = np.min(np.nan_to_num(np.stack(rel), nan=np.inf),
                        axis=0) < 1e-5
    scale = np.where(ok, 2.0 / np.where(ok, s0 + s1, 1.0), 0.0)

    off = w * (npre - 1)
    K = np.zeros(scale.shape, np.complex128)
    K_mag = np.zeros(scale.shape)
    for k in range(off + dw, off + w - half - dw):
        y = xc[:, i + k] * np.conj(xc[:, i + k + half])
        K += y
        K_mag += np.abs(y)
    delta_fc = np.where(scale != 0, np.angle(K) / half, 0.0)

    prep = np.repeat(pre, w)
    Ls = np.zeros(scale.shape, np.complex128)
    for j in range(sw):
        Ls += xc[:, i + j] * np.exp(1j * delta_fc * j) * np.conj(prep[j])
    L = Ls * scale
    abs_L = np.abs(L)
    return {"scale": scale, "delta_fc": delta_fc, "phase_off": -np.angle(L),
            "abs_L": abs_L,
            "corr_peak": np.where(scale != 0, np.floor(abs_L), 0.0),
            "borderline": borderline,
            "ill_conditioned": (scale != 0) & (np.abs(K) < 1e-3 * K_mag)}


def search_agreement(got, ref: dict, peak_floor: float = 1.0) -> dict:
    """How the four search arrays ``got`` (scale, delta_fc, phase_off,
    corr_peak; [C, n]) agree with :func:`sync_search_f64`'s ``ref``, on
    the offsets that are neither borderline nor ill-conditioned:

    - ``scale_zero_mismatch``: offsets where exactly one of the two has
      scale 0 (the ``ok`` test went the other way);
    - ``scale_rel``: max |d scale| / scale where the reference's is not 0;
    - ``delta_fc_abs``: max |d delta_fc| there;
    - ``phase_abs``: max |d phase_off| (wrapped to [-pi, pi]) where the
      reference's scale is not 0 and |L| >= ``peak_floor`` (the phase of
      a smaller peak is noise; the automaton reads it only above
      0.7 sw);
    - ``peak_mismatch``: offsets whose corr_peak differs, leaving out
      those whose reference |L| lies within 1e-3 of an integer;
    - ``borderline``, ``ill_conditioned`` and ``near_integer``: the
      offsets left out.
    """
    scale, dfc, pho, peak = (np.asarray(a, np.float64) for a in got)
    keep = ~ref["borderline"] & ~ref["ill_conditioned"]
    live = keep & (ref["scale"] != 0)
    dist = np.abs(ref["abs_L"] - np.round(ref["abs_L"]))
    near = keep & (ref["scale"] != 0) & (dist < 1e-3)
    wrapped = np.angle(np.exp(1j * (pho - ref["phase_off"])))

    def worst(v, where):
        return float(np.max(v[where])) if where.any() else 0.0

    return {
        "offsets": int(keep.size),
        "borderline": int(ref["borderline"].sum()),
        "ill_conditioned": int(ref["ill_conditioned"].sum()),
        "near_integer": int(near.sum()),
        "scale_zero_mismatch": int(((scale != 0) != (ref["scale"] != 0))
                                   [keep].sum()),
        "scale_rel": worst(np.abs(scale - ref["scale"])
                           / np.where(live, ref["scale"], 1.0), live),
        "delta_fc_abs": worst(np.abs(dfc - ref["delta_fc"]), live),
        "phase_abs": worst(np.abs(wrapped),
                           live & (ref["abs_L"] >= peak_floor)),
        "peak_mismatch": int((peak != ref["corr_peak"])
                             [keep & ~near].sum()),
    }
