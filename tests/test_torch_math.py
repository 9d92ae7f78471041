"""The port's math catalog (ops/elementwise.py, blocks/math.py,
blocks/window.py) against the JAX package: every case of tests/test_math.py
on the same seeded feeds, each through the JAX block and the port's block
in a feeder -> block -> collector topology (the port's on the CPU).

Inputs are explicit float32/float64/complex64/integer arrays made with
numpy.random.default_rng (JAX x64 is on in the tests). Integer,
complex-integer, comparator and fixed-point outputs are held bit for bit.
Float outputs are held within the tolerance tests/test_math.py holds the
JAX package to against its numpy expectation (1e-4 for float32
arithmetic, 1e-5 for the float32 unaries and trig, 1e-10 to 1e-12 for
float64), as an absolute bound on |port - JAX|; each case records the
largest difference it saw (``max_abs_diff`` in the JUnit properties).
"""

import zlib

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu.ops.fxpt import fxpt_atan2 as jfxpt_atan2
from pothoscomms_tpu_torch.core.dtypes import ALL_NAMES, FLOAT_NAMES, DType
from pothoscomms_tpu_torch.core.testing import to_complex_int
from pothoscomms_tpu_torch.ops import elementwise as ew
from pothoscomms_tpu_torch.ops.fxpt import fxpt_atan2
from tests.test_math import _fxpt_atan2_scalar, cplx_int_ref

torch.set_num_threads(1)

N = 128  # as tests/test_math.py: >= 100 so vectorized paths execute
PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def make_test_data(dtype: DType, rng, lo=1, hi=50):
    """tests/test_math.py's feeds: integers in [lo, hi) as the dtype's
    storage."""
    lo = max(lo, 1)
    if dtype.is_complex:
        vals = (rng.integers(lo, hi, N).astype(np.float64)
                + 1j * rng.integers(lo, hi, N).astype(np.float64))
        if dtype.is_complex_int:
            return to_complex_int(vals, dtype)
        return vals.astype(dtype.np)
    if dtype.is_float:
        return rng.uniform(lo, hi, N).astype(dtype.np)
    return rng.integers(lo, hi, N).astype(dtype.np)


def run_block(which, make, inputs, in_dtype, out_dtype=None, outs=(0,)):
    """feeder(s) -> make(package) -> collector(s) in one package; returns
    the collected buffers, one per output port in ``outs``."""
    p, fx = PACKAGES[which]
    blk = make(p)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    for i, arr in enumerate(inputs):
        f = fx.FeederSource(in_dtype)
        f.feed_buffer(arr)
        topo.connect(f, 0, blk, i)
    sinks = []
    for o in outs:
        c = fx.CollectorSink(out_dtype or in_dtype)
        topo.connect(blk, o, c, 0)
        sinks.append(c)
    assert topo.wait_inactive(timeout=30)
    return [s.get_buffer() for s in sinks]


def both(make, inputs, in_dtype, out_dtype=None, outs=(0,)):
    got = run_block("port", make, inputs, in_dtype, out_dtype, outs)
    exp = run_block("jax", make, inputs, in_dtype, out_dtype, outs)
    return got, exp


def hold_exact(make, inputs, in_dtype, out_dtype=None):
    (got,), (exp,) = both(make, inputs, in_dtype, out_dtype)
    dt = DType.parse(out_dtype or in_dtype)
    assert got.dtype == dt.np and got.shape == exp.shape
    np.testing.assert_array_equal(got, exp.astype(dt.np))
    return got


def hold_close(make, inputs, in_dtype, tol, record, out_dtype=None,
               outs=(0,)):
    gots, exps = both(make, inputs, in_dtype, out_dtype, outs)
    worst = 0.0
    for got, exp in zip(gots, exps):
        dt = DType.parse(out_dtype or in_dtype)
        assert got.dtype == dt.np and got.shape == exp.shape
        d = float(np.max(np.abs(got.astype(np.complex128)
                                - exp.astype(np.complex128))))
        worst = max(worst, d)
    record("max_abs_diff", worst)
    assert worst <= tol, worst
    return gots


def blk(path, *args, setup=None):
    def make(p):
        b = p.BlockRegistry.make(path, *args)
        if setup:
            setup(b)
        return b

    return make


# ------------------------------------------------------------------ #
# registry: the three modules' paths and aliases
# ------------------------------------------------------------------ #
def test_registry_matches_jax_for_math_sources_window():
    import pothoscomms_tpu.core.registry as jreg

    mods = ("pothoscomms_tpu.blocks.math", "pothoscomms_tpu.blocks.sources",
            "pothoscomms_tpu.blocks.window")
    want = sorted(path for path, f in jreg._REGISTRY.items()
                  if getattr(f, "__module__", "") in mods)
    assert len(want) == 40
    have = pkg.BlockRegistry.paths()
    assert [p for p in want if p not in have] == []
    port_mods = {"pothoscomms_tpu_torch.blocks.math",
                 "pothoscomms_tpu_torch.blocks.sources",
                 "pothoscomms_tpu_torch.blocks.window"}
    from pothoscomms_tpu_torch.core import registry as preg

    mine = sorted(p for p, f in preg._REGISTRY.items()
                  if getattr(f, "__module__", "") in port_mods)
    assert mine == want


# ------------------------------------------------------------------ #
# arithmetic (tests/test_math.py:113-244)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype_name", ALL_NAMES)
@pytest.mark.parametrize("op", ["ADD", "SUB", "MUL", "DIV"])
def test_arithmetic_dtype_sweep(dtype_name, op, record_property):
    dt = DType.parse(dtype_name)
    rng = np.random.default_rng(_seed(dtype_name, op))
    x = make_test_data(dt, rng, 20, 50)
    y = make_test_data(dt, rng, 1, 19)
    make = blk("/comms/arithmetic", dtype_name, op)
    if dt.is_float:
        hold_close(make, [x, y], dtype_name,
                   1e-4 if dt.bits == 32 else 1e-12, record_property)
    else:
        got = hold_exact(make, [x, y], dtype_name)
        if dt.is_complex_int:  # and the C++ oracle of tests/test_math.py
            np.testing.assert_array_equal(got, cplx_int_ref(op, x, y))


def test_arithmetic_three_inputs_and_preload():
    x = np.arange(N, dtype=np.int32)
    y = np.arange(N, dtype=np.int32) * 2
    z = np.arange(N, dtype=np.int32) * 3
    hold_exact(blk("/comms/arithmetic", "int32", "ADD",
                   setup=lambda b: b.set_num_inputs(3)), [x, y, z], "int32")

    def preloaded(which):
        p, fx = PACKAGES[which]
        b = p.BlockRegistry.make("/comms/arithmetic", "int32", "ADD")
        b.set_preload([0, 4])
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        f0, f1 = fx.FeederSource("int32"), fx.FeederSource("int32")
        f0.feed_buffer(x)
        f1.feed_buffer(y[: N - 4])
        c = fx.CollectorSink("int32")
        topo.connect(f0, 0, b, 0)
        topo.connect(f1, 0, b, 1)
        topo.connect(b, 0, c, 0)
        assert topo.wait_inactive()
        return c.get_buffer()

    got = preloaded("port")
    np.testing.assert_array_equal(got, preloaded("jax"))
    np.testing.assert_array_equal(
        got, x + np.concatenate([np.zeros(4, np.int32), y[: N - 4]]))


def test_arithmetic_inline_buffers(record_property):
    """The fold writes over its private copy of input 0 (the reference's
    inlining, math/TestArithmeticBlocks.cpp:381-383), counted as the JAX
    package counts its donated buffer."""
    x = np.arange(N, dtype=np.float32)
    y = np.ones(N, dtype=np.float32)
    made = []

    def make(p):
        b = p.BlockRegistry.make("/comms/arithmetic", "float32", "ADD")
        made.append(b)
        return b

    hold_close(make, [x, y], "float32", 1e-6, record_property)
    assert made[0].get_num_inline_buffers() > 0
    assert made[0].get_num_inline_buffers() == made[1].get_num_inline_buffers()


@pytest.mark.parametrize("dtype_name", ["float32", "float64", "int16",
                                        "uint8", "complex_float32",
                                        "complex_int16", "uint32",
                                        "complex_uint16"])
@pytest.mark.parametrize("op", ["X+K", "X-K", "K-X", "X*K", "X/K", "K/X"])
def test_const_arithmetic(dtype_name, op, record_property):
    dt = DType.parse(dtype_name)
    x = make_test_data(dt, np.random.default_rng(42), 2, 40)
    k = (3 + 2j) if dt.is_complex else 3
    make = blk("/comms/const_arithmetic", dtype_name, op, k)
    if dt.is_float:
        hold_close(make, [x], dtype_name, 1e-5, record_property)
    else:
        hold_exact(make, [x], dtype_name)


# ------------------------------------------------------------------ #
# scale and rotate (Q format, labels)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype_name,factor", [
    ("float32", 2.5), ("complex_float32", -1.25), ("float64", 0.3),
    ("int16", 0.5), ("int8", -0.75), ("int32", 1.5), ("int64", 0.25),
    ("uint8", 0.5), ("uint16", 0.75), ("complex_int16", 0.5),
    ("complex_uint32", 0.5)])
def test_scale_float_and_fixed_point(dtype_name, factor, record_property):
    dt = DType.parse(dtype_name)
    if dt.is_float:
        x = make_test_data(dt, np.random.default_rng(7), 1, 50)
        hold_close(blk("/comms/scale", dtype_name,
                       setup=lambda b: b.set_factor(factor)), [x],
                   dtype_name, 1e-6 if dt.bits == 32 else 1e-12,
                   record_property)
        return
    if dt.kind == "uint":
        x = make_test_data(dt, np.random.default_rng(7), 1, 120)
    elif dt.is_complex:
        x = to_complex_int((np.arange(N) % 40 - 20)
                           + 1j * (np.arange(N) % 30 - 15), dt)
    else:
        x = (np.arange(N) - 64).astype(dt.np)
    got = hold_exact(blk("/comms/scale", dtype_name,
                         setup=lambda b: b.set_factor(factor)), [x],
                     dtype_name)
    if dtype_name == "int16":  # and the Q-format oracle of test_math.py
        fq = int(np.trunc(factor * 2 ** 16))
        np.testing.assert_array_equal(
            got, ((x.astype(np.int32) * fq) >> 16).astype(np.int16))


def test_scale_label_driven_factor(record_property):
    x = np.ones(100, dtype=np.float32)

    def run(which):
        p, fx = PACKAGES[which]
        feeder = fx.FeederSource("float32")
        feeder.feed_buffer(x, [p.Label("gain", 3.0, 0),
                               p.Label("gain", 5.0, 60)])
        b = p.BlockRegistry.make("/comms/scale", "float32")
        b.set_factor(1.0)
        b.set_label_id("gain")
        coll = fx.CollectorSink("float32")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(feeder, 0, b, 0)
        topo.connect(b, 0, coll, 0)
        assert topo.wait_inactive()
        return coll.get_buffer()

    got, exp = run("port"), run("jax")
    record_property("max_abs_diff", float(np.max(np.abs(got - exp))))
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(
        got, np.concatenate([np.full(60, 3.0), np.full(40, 5.0)]))


@pytest.mark.parametrize("dtype_name", ["complex_float32", "complex_float64",
                                        "complex_int16", "complex_int32",
                                        "complex_uint16"])
def test_rotate_complex_float_and_int(dtype_name, record_property):
    dt = DType.parse(dtype_name)
    phase = 0.3
    make = blk("/comms/rotate", dtype_name,
               setup=lambda b: b.set_phase(phase))
    if dt.is_float:
        r0, r1 = np.random.default_rng(0), np.random.default_rng(1)
        x = (r0.normal(size=N) + 1j * r1.normal(size=N)).astype(dt.np)
        hold_close(make, [x], dtype_name,
                   1e-5 if dt.bits == 32 else 1e-12, record_property)
        return
    x = to_complex_int((np.arange(N) % 40 - 20)
                       + 1j * (np.arange(N) % 30 - 15), dt) \
        if dt.kind == "int" else make_test_data(dt, np.random.default_rng(2))
    hold_exact(make, [x], dtype_name)


# ------------------------------------------------------------------ #
# comparators
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype_name", ["int32", "float32", "uint64",
                                        "float64"])
@pytest.mark.parametrize("op", [">", "<", ">=", "<=", "==", "!="])
def test_comparator_and_const_comparator(dtype_name, op):
    dt = DType.parse(dtype_name)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 10, N).astype(dt.np)
    y = rng.integers(0, 10, N).astype(dt.np)
    if dt.kind == "uint":  # beyond 2^63, where an int64 detour would fail
        x = x + np.uint64(1 << 63)
        y = y + np.uint64(1 << 63)
    got = hold_exact(blk("/comms/comparator", dtype_name, op), [x, y],
                     dtype_name, "int8")
    np.testing.assert_array_equal(got, {
        ">": x > y, "<": x < y, ">=": x >= y, "<=": x <= y, "==": x == y,
        "!=": x != y}[op].astype(np.int8))
    k = dt.np.type(5) + (np.uint64(1 << 63) if dt.kind == "uint" else 0)
    hold_exact(blk("/comms/const_comparator", dtype_name, op, k), [x],
               dtype_name, "int8")


# ------------------------------------------------------------------ #
# abs / angle / conjugate, fixed point
# ------------------------------------------------------------------ #
def test_abs_variants(record_property):
    x = np.linspace(-5, 5, N).astype(np.float32)
    hold_close(blk("/comms/abs", "float32"), [x], "float32", 0.0,
               record_property)
    xi = (np.arange(N) - 64).astype(np.int16)
    hold_exact(blk("/comms/abs", "int16"), [xi], "int16")
    xc = (np.linspace(-3, 3, N) + 1j * np.linspace(2, -2, N)).astype(
        np.complex64)
    hold_close(blk("/comms/abs", "complex_float32"), [xc], "complex_float32",
               1e-5, record_property, "float32")
    ci = to_complex_int((np.arange(N) % 20 - 10)
                        + 1j * (np.arange(N) % 14 - 7), "complex_int16")
    hold_exact(blk("/comms/abs", "complex_int16"), [ci], "complex_int16",
               "int16")
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/abs", "uint8")


def test_angle_float_and_fxpt_parity(record_property):
    xc = (np.cos(np.linspace(0, 6, N))
          + 1j * np.sin(np.linspace(0, 6, N))).astype(np.complex64)
    hold_close(blk("/comms/angle", "complex_float32"), [xc],
               "complex_float32", 1e-5, record_property, "float32")


def test_fxpt_atan2_grid_parity():
    rng = np.random.default_rng(3)
    ys = rng.integers(-32768, 32768, 512).astype(np.int16)
    xs = rng.integers(-32768, 32768, 512).astype(np.int16)
    specials = np.array([[0, 0], [1, 1], [-5, -5], [100, 0], [0, 100],
                         [-100, 0], [0, -100]], dtype=np.int16)
    ys = np.concatenate([ys, specials[:, 0]])
    xs = np.concatenate([xs, specials[:, 1]])
    got = fxpt_atan2(torch.from_numpy(ys), torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfxpt_atan2(ys, xs)))
    exp = np.array([_fxpt_atan2_scalar(int(y), int(x))
                    for y, x in zip(ys[:64], xs[:64])], np.uint16)
    np.testing.assert_array_equal(got[:64], exp)


@pytest.mark.parametrize("dtype_name", ["complex_int16", "complex_int32",
                                        "complex_int8"])
def test_angle_fxpt_block(dtype_name):
    vals = (np.array([100, -50, 0, 77]) + 1j * np.array([30, 60, -90, 0]))
    ci = to_complex_int(np.resize(vals, N), dtype_name)
    dt = DType.parse(dtype_name)
    got = hold_exact(blk("/comms/angle", dtype_name), [ci], dtype_name,
                     dt.scalar.name)
    if dtype_name == "complex_int16":
        exp = np.array([np.int16(_fxpt_atan2_scalar(int(v.imag),
                                                    int(v.real)))
                        for v in vals])
        np.testing.assert_array_equal(got[:4], exp)


@pytest.mark.parametrize("dtype_name", ["complex_float32", "complex_int32",
                                        "complex_uint16", "complex_float64"])
def test_conjugate(dtype_name):
    dt = DType.parse(dtype_name)
    vals = np.arange(N) + 1j * np.arange(N)
    x = to_complex_int(vals, dt) if dt.is_integer else vals.astype(dt.np)
    hold_exact(blk("/comms/conjugate", dtype_name), [x], dtype_name)


# ------------------------------------------------------------------ #
# float unaries, rsqrt, trig, pow and roots, ModF, beta
# ------------------------------------------------------------------ #
UNARY_PATHS = ["/comms/sinc", "/comms/sigmoid", "/comms/log", "/comms/log2",
               "/comms/log10", "/comms/log1p", "/comms/exp", "/comms/exp2",
               "/comms/exp10", "/comms/expm1", "/comms/sqrt", "/comms/cbrt",
               "/comms/erf", "/comms/erfc", "/comms/gamma",
               "/comms/lngamma"]


@pytest.mark.parametrize("dtype_name", FLOAT_NAMES)
@pytest.mark.parametrize("path", UNARY_PATHS)
def test_unary_float_blocks(dtype_name, path, record_property):
    """Held relative to max(|value|, 1) at test_math.py's bound for the
    JAX package (eps * 50: 5e-4 for float32, 5e-10 for float64)."""
    dt = DType.parse(dtype_name)
    x = np.linspace(0.1, 4.0, N).astype(dt.np)
    eps = 1e-5 if dt.bits == 32 else 1e-11
    (got,), (exp,) = both(blk(path, dtype_name), [x], dtype_name)
    assert got.dtype == dt.np and got.shape == exp.shape
    rel = np.max(np.abs(got - exp) / np.maximum(np.abs(exp), 1.0))
    record_property("max_rel_diff", float(rel))
    assert rel < eps * 50, path


NP_UNARY = {"/comms/sqrt": np.sqrt, "/comms/cbrt": np.cbrt,
            "/comms/log": np.log, "/comms/exp2": np.exp2}


@pytest.mark.parametrize("dtype_name", ["int32", "uint16", "int8"])
@pytest.mark.parametrize("path", list(NP_UNARY))
def test_unary_integer_blocks(dtype_name, path):
    """Integer dtypes evaluate in float64 and C-cast back (math/Log.cpp:82
    and friends), held bit for bit to that oracle (numpy's correctly
    rounded float64 functions, truncated). The JAX package agrees except
    where the exact result is an integer its float64 cbrt or exp2 misses
    by an ulp from below (cbrt(64) = 3.9999..., exp2(3) = 7.9999...),
    which truncates one lower: those points, and only those, may differ
    (ROADMAP Queue 3, reference-side)."""
    dt = np.dtype(dtype_name)
    x = (np.arange(1, N + 1) % 100 + 1).astype(dt)
    if path == "/comms/exp2":
        x = (x % 6).astype(dt)
    (got,), (exp,) = both(blk(path, dtype_name), [x], dtype_name)
    oracle = np.trunc(NP_UNARY[path](x.astype(np.float64))).astype(dt)
    np.testing.assert_array_equal(got, oracle)
    off = got != exp.astype(dt)
    exact = NP_UNARY[path](x.astype(np.float64)) == oracle
    assert np.all(exact[off]) and np.all(exp[off] == oracle[off] - 1)
    if path in ("/comms/sqrt", "/comms/log"):
        assert not off.any()


def test_rsqrt_fast_inverse_parity(record_property):
    x = np.linspace(0.5, 100, N).astype(np.float32)
    (got,) = hold_close(blk("/comms/rsqrt", "float32"), [x], "float32",
                        1e-6, record_property)
    u = x.view(np.uint32)
    f2 = (np.uint32(0x5F1FFFF9) - (u >> np.uint32(1))).astype(
        np.uint32).view(np.float32)
    exp = np.float32(0.703952253) * f2 * (np.float32(2.38924456)
                                          - x * f2 * f2)
    np.testing.assert_allclose(got, exp, atol=1e-6, rtol=0)
    x64 = np.linspace(0.5, 100, N).astype(np.float64)
    hold_close(blk("/comms/rsqrt", "float64"), [x64], "float64", 1e-12,
               record_property)


TRIG_CASES = {"SIN": 0, "COS": 0, "TAN": 0, "SEC": 0, "CSC": 0, "COT": 0,
              "ASIN": 0, "ACOS": 0, "ATAN": 0, "ASEC": 1, "ACSC": 1,
              "ACOT": 0, "SINH": 0, "COSH": 0, "TANH": 0, "SECH": 0,
              "CSCH": 0, "COTH": 0, "ASINH": 0, "ACOSH": 1, "ATANH": 0,
              "ASECH": 0, "ACSCH": 0, "ACOTH": 1}


@pytest.mark.parametrize("dtype_name", FLOAT_NAMES)
def test_trigonometric_ops(dtype_name, record_property):
    """All 24 operations, at test_math.py's 1e-10 for float64 and the
    float32 unaries' 1e-5 relative bound for float32."""
    dt = DType.parse(dtype_name)
    x = np.linspace(0.2, 0.9, N)
    worst = 0.0
    for op, shift in TRIG_CASES.items():
        xin = (x + shift).astype(dt.np)
        (got,), (exp,) = both(blk("/comms/trigonometric", dtype_name, op),
                              [xin], dtype_name)
        assert got.dtype == dt.np
        d = np.max(np.abs(got - exp) / np.maximum(np.abs(exp), 1.0))
        worst = max(worst, float(d))
        assert d <= (1e-10 if dt.bits == 64 else 1e-5), op
    record_property("max_rel_diff", worst)


def test_pow_and_roots(record_property):
    x = np.linspace(1, 5, N).astype(np.float64)
    hold_close(blk("/comms/pow", "float64", 2.5), [x], "float64", 1e-10,
               record_property)
    xi = np.arange(1, N + 1, dtype=np.int32)
    got = hold_exact(blk("/comms/pow", "int32", 2), [xi], "int32")
    np.testing.assert_array_equal(got, xi * xi)
    hold_close(blk("/comms/nth_root", "float64", 3.0), [x], "float64",
               1e-10, record_property)
    x32 = np.linspace(1, 5, N).astype(np.float32)
    hold_close(blk("/comms/pow", "float32", 1.5), [x32], "float32", 1e-4,
               record_property)
    hold_close(blk("/comms/nth_root", "float32", 2.0), [x32], "float32",
               1e-5, record_property)


@pytest.mark.parametrize("dtype_name", FLOAT_NAMES)
def test_logn_expn(dtype_name, record_property):
    dt = DType.parse(dtype_name)
    x = np.linspace(0.5, 3.0, N).astype(dt.np)
    tol = 1e-5 if dt.bits == 32 else 1e-12
    hold_close(blk("/comms/logN", dtype_name, 3.0), [x], dtype_name, tol,
               record_property)
    hold_close(blk("/comms/expN", dtype_name, 2.5,
                   setup=lambda b: b.set_base(4.0)), [x], dtype_name,
               tol * 100, record_property)


@pytest.mark.parametrize("dtype_name", FLOAT_NAMES)
def test_modf_two_outputs(dtype_name):
    x = np.array([1.25, -2.75, 3.0, -0.5] * 32, dtype=np.dtype(dtype_name))
    got, exp = both(blk("/comms/modf", dtype_name), [x], dtype_name,
                    outs=("int", "frac"))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)
    frac, integral = np.modf(x)
    np.testing.assert_array_equal(got[0], integral)
    np.testing.assert_array_equal(got[1], frac)


@pytest.mark.parametrize("dtype_name", FLOAT_NAMES)
def test_beta(dtype_name, record_property):
    x = np.linspace(1, 4, N).astype(np.dtype(dtype_name))
    y = np.linspace(2, 5, N).astype(np.dtype(dtype_name))
    hold_close(blk("/comms/beta", dtype_name), [x, y], dtype_name,
               1e-6 if dtype_name == "float32" else 1e-9, record_property)


def test_gamma_sign_on_negatives(record_property):
    """tgamma's sign by reflection parity, on (-4, 0)."""
    x = (np.linspace(-3.9, -0.1, N) + 1e-3).astype(np.float64)
    hold_close(blk("/comms/gamma", "float64"), [x], "float64", 1e-9,
               record_property)


def test_numpy_twins_follow_c_semantics():
    """uint64 division and comparison beyond 2^63, where an int64 detour
    would fail."""
    a = np.array([2 ** 64 - 1, 2 ** 63 + 5, 7], np.uint64)
    b = np.array([2, 2 ** 63, 0], np.uint64)
    np.testing.assert_array_equal(
        ew.binary_arith_np("uint64", "DIV")(a, b),
        np.array([2 ** 63 - 1, 1, 0], np.uint64))
    np.testing.assert_array_equal(ew.comparator_np(">")(a, b),
                                  np.array([1, 1, 1], np.int8))
    assert ew.host_numpy(DType.parse("complex_uint32"))
    assert not ew.host_numpy(DType.parse("uint8"))
    t = ew.c_idiv(torch.tensor([-7, 7, 5]), torch.tensor([2, -2, 0]))
    assert t.tolist() == [-3, -3, 0]


# ------------------------------------------------------------------ #
# window designer (reference window/WindowDesigner.cpp)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("wtype,args", [("hann", []), ("kaiser", [6.0]),
                                        ("blackman", []),
                                        ("chebyshev", [60.0])])
def test_window_designer_against_jax(wtype, args):
    def run(which):
        p, _ = PACKAGES[which]
        d = p.BlockRegistry.make("/comms/window_designer")
        got = []

        class Catch(p.Block):
            def set_taps(self, taps):
                got.append(np.asarray(taps))

        catch = Catch()
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(d, "tapsChanged", catch, "setTaps")
        topo.commit()
        d.set_window_type(wtype)
        d.set_window_args(args)
        d.set_num_taps(33)
        return got

    got, exp = run("port"), run("jax")
    assert len(got) == len(exp) >= 3
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-12)
    assert got[-1].shape == (33,)
