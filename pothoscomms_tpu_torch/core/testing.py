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


# ---------------------------------------------------------------------- #
# The fusable math catalog, engaged (the CPU and card tests, chip_smoke)
# ---------------------------------------------------------------------- #
# name: (path, factory args, setter and value or None, dtype in, dtype out,
#        feed, inputs, atol relative to max(1, max |output|) or None for
#        bit for bit). Every math path whose block fuses at float32 or
#        complex_float32 has one case (tests/test_torch_math_fusion.py
#        checks the list is complete). Feeds: "normal" N(0, 1) (complex:
#        both parts), "positive" U(0.1, 4), "offset" N(0, 1) + 3 (no zero
#        denominators).
FUSED_MATH_CASES = {
    "arithmetic": ("/comms/arithmetic", ("DIV",), None, "complex_float32",
                   "complex_float32", "offset", 2, 1e-5),
    "comparator": ("/comms/comparator", (">",), None, "float32", "int8",
                   "normal", 2, None),
    "beta": ("/comms/beta", (), None, "float32", "float32", "positive", 2,
             1e-5),
    "const_arithmetic": ("/comms/const_arithmetic", ("X/K", 3.0), None,
                         "float32", "float32", "normal", 1, 1e-6),
    "const_comparator": ("/comms/const_comparator", (">=", 0.25), None,
                         "float32", "int8", "normal", 1, None),
    "scale": ("/comms/scale", (), ("set_factor", 1.5), "complex_float32",
              "complex_float32", "normal", 1, 1e-6),
    "rotate": ("/comms/rotate", (), ("set_phase", 0.4), "complex_float32",
               "complex_float32", "normal", 1, 1e-5),
    "abs": ("/comms/abs", (), None, "complex_float32", "float32", "normal",
            1, 1e-5),
    "angle": ("/comms/angle", (), None, "complex_float32", "float32",
              "normal", 1, 1e-5),
    "conjugate": ("/comms/conjugate", (), None, "complex_float32",
                  "complex_float32", "normal", 1, None),
    "sinc": ("/comms/sinc", (), None, "float32", "float32", "normal", 1,
             1e-5),
    "sigmoid": ("/comms/sigmoid", (), None, "float32", "float32", "normal",
                1, 1e-5),
    "rsqrt": ("/comms/rsqrt", (), None, "float32", "float32", "positive",
              1, None),
    "gamma": ("/comms/gamma", (), None, "float32", "float32", "positive",
              1, 1e-4),
    "lngamma": ("/comms/lngamma", (), None, "float32", "float32",
                "positive", 1, 1e-5),
    "erf": ("/comms/erf", (), None, "float32", "float32", "normal", 1,
            1e-5),
    "erfc": ("/comms/erfc", (), None, "float32", "float32", "normal", 1,
             1e-5),
    "trigonometric": ("/comms/trigonometric", ("ATAN",), None, "float32",
                      "float32", "normal", 1, 1e-5),
    "pow": ("/comms/pow", (1.5,), None, "float32", "float32", "positive",
            1, 1e-5),
    "sqrt": ("/comms/sqrt", (), None, "float32", "float32", "positive", 1,
             1e-5),
    "cbrt": ("/comms/cbrt", (), None, "float32", "float32", "positive", 1,
             1e-5),
    "nth_root": ("/comms/nth_root", (4.0,), None, "float32", "float32",
                 "positive", 1, 1e-5),
    "log": ("/comms/log", (), None, "float32", "float32", "positive", 1,
            1e-5),
    "log2": ("/comms/log2", (), None, "float32", "float32", "positive", 1,
             1e-5),
    "log10": ("/comms/log10", (), None, "float32", "float32", "positive",
              1, 1e-5),
    "log1p": ("/comms/log1p", (), None, "float32", "float32", "positive",
              1, 1e-5),
    "exp": ("/comms/exp", (), None, "float32", "float32", "normal", 1,
            1e-5),
    "exp2": ("/comms/exp2", (), None, "float32", "float32", "normal", 1,
             1e-5),
    "exp10": ("/comms/exp10", (), None, "float32", "float32", "normal", 1,
              1e-5),
    "expm1": ("/comms/expm1", (), None, "float32", "float32", "normal", 1,
              1e-5),
    "logN": ("/comms/logN", (3.0,), None, "float32", "float32", "positive",
             1, 1e-5),
    "expN": ("/comms/expN", (3.0,), None, "float32", "float32", "normal",
             1, 1e-5),
    "modf": ("/comms/modf", (), None, "float32", "float32", "normal", 1,
             None),
}


def fused_math_feeds(name: str, n: int, seed: int = 0):
    """The case's input arrays (one per input port), ``n`` samples each."""
    _, _, _, din, _, feed, n_in, _ = FUSED_MATH_CASES[name]
    rng = np.random.default_rng(seed)
    cplx = din.startswith("complex")
    out = []
    for _ in range(n_in):
        if feed == "positive":
            x = rng.uniform(0.1, 4.0, n)
        else:
            x = rng.normal(size=n) * (8.0 if name == "modf" else 1.0)
            x = x + (3.0 if feed == "offset" else 0.0)
        if cplx:
            x = x + 1j * rng.normal(size=n)
        out.append(x.astype(np.complex64 if cplx else np.float32))
    return out


def fused_math_run(name: str, feeds, device="cpu", fuse: bool = True,
                   threshold: int = 1 << 16):
    """feeder(s) -> the case's block -> an exact hop -> collector(s) on
    Topology(device) (ModF, a multi-output tail: an exact hop, then ModF,
    then one collector a port), so the block joins a fused run of two.
    The hop is bit-exact: conjugate, const_arithmetic X+K with K = 0, or
    bitwise NOT on int8 verdicts. Returns ([outputs], topology)."""
    from pothoscomms_tpu_torch.core.fixtures import (CollectorSink,
                                                     FeederSource)
    from pothoscomms_tpu_torch.core.registry import BlockRegistry
    from pothoscomms_tpu_torch.core.topology import Topology

    path, args, setter, din, dout, _, n_in, _ = FUSED_MATH_CASES[name]
    blk = BlockRegistry.make(path, din, *args)
    if setter:
        getattr(blk, setter[0])(setter[1])

    def hop(dt):
        if dt == "int8":
            return BlockRegistry.make("/comms/bitwise_unary", "int8", "NOT")
        if dt.startswith("complex"):
            return BlockRegistry.make("/comms/conjugate", dt)
        return BlockRegistry.make("/comms/const_arithmetic", dt, "X+K", 0.0)

    topo = Topology(device=device)
    topo.auto_fuse = fuse
    topo.fuse_threshold = threshold
    tail_ports = list(blk.outputs)
    if len(tail_ports) > 1:
        head, tail = hop(din), blk
        topo.connect(head, 0, blk, 0)
    else:
        head, tail = blk, hop(dout)
        topo.connect(blk, 0, tail, 0)
        tail_ports = [0]
    for i, x in enumerate(feeds):
        f = FeederSource(din)
        f.feed_buffer(x)
        topo.connect(f, 0, head, i)
    sinks = []
    for port in tail_ports:
        s = CollectorSink(dout)
        s.input(0).set_capacity(None)
        topo.connect(tail, port, s, 0)
        sinks.append(s)
    topo.commit()
    assert topo.wait_inactive(timeout=120.0)
    return [s.get_buffer() for s in sinks], topo


def fused_math_agree(name: str, got, ref) -> float:
    """Hold the case's outputs to a reference run: bit for bit where the
    case says so, else within its tolerance of max(1, max |ref|). Returns
    the largest |got - ref| (raises AssertionError on disagreement)."""
    atol = FUSED_MATH_CASES[name][7]
    worst = 0.0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, r.shape)
        d = np.abs(g.astype(np.complex128) - r.astype(np.complex128))
        worst = max(worst, float(d.max()) if d.size else 0.0)
        if atol is None:
            assert np.array_equal(g, r), f"{name}: not bit-exact"
        else:
            bound = atol * max(1.0, float(np.max(np.abs(r))))
            assert worst <= bound, f"{name}: {worst} > {bound}"
    return worst
