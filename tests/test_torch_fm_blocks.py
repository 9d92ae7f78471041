"""The port's FM blocks — /comms/freq_demod, /comms/dc_removal and
/comms/envelope_detector — against the JAX package's blocks on the same
feeds, streaming and fused (the cases of tests/test_framing.py:392-430,
test_filter.py:647-760 and test_fusion.py:106-125).

Inputs are made with numpy.random.default_rng(seed). Tolerances:
integer outputs bit-exact; float64 within 1e-9 absolute (the JAX tests'
bound); float32 outputs within 1e-5 absolute of the JAX block (the same
float32 operations, atan2 and cumulative sums in another order); the
fused segment against streaming within 1e-3 absolute, as
tests/test_fusion.py.
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch.core.testing import to_complex_int
from pothoscomms_tpu_torch.kernels.envelope import envelope_rows
from tests.test_filter import dc_removal_oracle, envelope_oracle

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def _on_cpu(blk):
    """A lone block placed on a CPU topology (the port's default device is
    the card)."""
    pkg.Topology(device="cpu")._register(blk)
    return blk
THRESH = 4096  # low fuse threshold so tests engage with small data


def run_blocks(which, blocks_of, dtype_in, dtype_out, feeds, fuse=False,
               threshold=THRESH):
    """feeder -> blocks -> collector in one package; returns (output,
    topology)."""
    p, fx = PACKAGES[which]
    blocks = blocks_of(p)
    feed = fx.FeederSource(dtype_in)
    sink = fx.CollectorSink(dtype_out)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.auto_fuse = fuse
    topo.fuse_threshold = threshold
    chain = [feed] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    for x in feeds:
        feed.feed_buffer(x)
    topo.commit()
    assert topo.wait_inactive(timeout=60.0)
    return sink.get_buffer(), topo


def both(blocks_of, dtype_in, dtype_out, feeds, **kw):
    got, _ = run_blocks("port", blocks_of, dtype_in, dtype_out, feeds, **kw)
    exp, _ = run_blocks("jax", blocks_of, dtype_in, dtype_out, feeds, **kw)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    return got, exp


def test_fm_blocks_registered_under_jax_names():
    for path in ("/comms/freq_demod", "/blocks/freq_demod",
                 "/comms/dc_removal", "/comms/envelope_detector",
                 "/blocks/envelope_detector"):
        assert pkg.BlockRegistry.exists(path)
        assert jpkg.BlockRegistry.exists(path)


# ---------------------------------------------------------------------- #
# FreqDemod (tests/test_framing.py:392-430)
# ---------------------------------------------------------------------- #
def demod(dtype):
    return lambda p: [p.BlockRegistry.make("/comms/freq_demod", dtype)]


def test_freq_demod_float_matches_jax_and_oracle():
    rng = np.random.default_rng(10)
    phase = np.cumsum(rng.normal(size=200) * 0.2)
    x = np.exp(1j * phase).astype(np.complex64)
    got, exp = both(demod("complex_float32"), "complex_float32", "float32",
                    [x[:77], x[77:]])
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    prev = np.concatenate([[0], x[:-1].conj()])  # reference starts prev=0
    np.testing.assert_allclose(got, np.angle(x * prev).astype(np.float32),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,out", [("complex_int16", "int16"),
                                       ("complex_int32", "int32"),
                                       ("complex_int8", "int8")])
def test_freq_demod_int_bit_exact(dtype, out):
    from tests.test_math import _fxpt_atan2_scalar

    rng = np.random.default_rng(11)
    hi = 10 if dtype == "complex_int8" else 100
    vals = rng.integers(-hi, hi, 50) + 1j * rng.integers(-hi, hi, 50)
    ci = to_complex_int(vals, dtype)
    got, exp = both(demod(dtype), dtype, out, [ci[:20], ci[20:]])
    np.testing.assert_array_equal(got, exp)
    if dtype == "complex_int16":  # the oracle of test_framing.py
        prev = 0
        want = []
        for v in vals:
            diff = v * prev
            want.append(np.int16(_fxpt_atan2_scalar(int(diff.imag),
                                                    int(diff.real))))
            prev = np.conj(v)
        np.testing.assert_array_equal(got, np.array(want, np.int16))


def test_freq_demod_fuse_export_import_roundtrip():
    blk = _on_cpu(pkg.BlockRegistry.make("/comms/freq_demod",
                                         "complex_float32"))
    blk._prev = np.complex64(0.25 - 0.5j)
    carry, _ = blk.fuse_export(1)
    assert carry.shape == (1, 1, 2)
    np.testing.assert_array_equal(carry.numpy()[0, 0], [0.25, 0.5])
    blk._prev = np.complex64(0)
    blk.fuse_import(carry)
    assert blk._prev == np.complex64(0.25 - 0.5j)


# ---------------------------------------------------------------------- #
# DCRemoval (tests/test_filter.py:647-717)
# ---------------------------------------------------------------------- #
def dc(dtype, d, casc):
    def build(p):
        blk = p.BlockRegistry.make("/comms/dc_removal", dtype)
        blk.set_average_size(d)
        blk.set_cascade_size(casc)
        return [blk]
    return build


def test_dc_removal_float64_oracle_and_jax():
    rng = np.random.default_rng(16)
    x = (rng.normal(size=400) + 3.0).astype(np.float64)
    got, exp = both(dc("float64", 32, 2), "float64", "float64", [x])
    np.testing.assert_allclose(got, np.array(dc_removal_oracle(x, 32, 2,
                                                               False)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-9)
    assert abs(got[200:].mean()) < 0.1


def test_dc_removal_int16_exact():
    rng = np.random.default_rng(17)
    x = (rng.integers(-100, 100, 300) + 50).astype(np.int16)
    got, exp = both(dc("int16", 16, 2), "int16", "int16", [x[:123], x[123:]])
    want = np.array(dc_removal_oracle([int(v) for v in x], 16, 2, True),
                    np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, exp)


def test_dc_removal_complex_int16_exact():
    rng = np.random.default_rng(18)
    vals = (rng.integers(-90, 90, 200) + 40) + 1j * (rng.integers(
        -90, 90, 200) - 30)
    ci = to_complex_int(vals, "complex_int16")
    got, exp = both(dc("complex_int16", 8, 2), "complex_int16",
                    "complex_int16", [ci[:50], ci[50:]])
    np.testing.assert_array_equal(got, exp)


def test_dc_removal_chunked_state():
    rng = np.random.default_rng(18)
    x = (rng.normal(size=300) + 1.5).astype(np.float64)
    got, exp = both(dc("float64", 8, 3), "float64", "float64",
                    [x[:111], x[111:]])
    np.testing.assert_allclose(got, np.array(dc_removal_oracle(x, 8, 3,
                                                               False)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "complex_float32"])
def test_dc_removal_float32_matches_jax(dtype):
    rng = np.random.default_rng(19)
    x = rng.normal(size=700) + 2.0
    if dtype.startswith("complex"):
        x = x + 1j * (rng.normal(size=700) - 1.0)
    x = x.astype(np.complex64 if dtype.startswith("complex") else np.float32)
    got, exp = both(dc(dtype, 16, 2), dtype, dtype, [x[:333], x[333:]])
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "complex_float32"])
def test_dc_removal_fuse_export_import_roundtrip(dtype):
    rng = np.random.default_rng(20)
    blk = _on_cpu(pkg.BlockRegistry.make("/comms/dc_removal", dtype))
    blk.set_average_size(6)
    blk.set_cascade_size(3)
    h = rng.normal(size=(3, 6)).astype(np.float32)
    if dtype.startswith("complex"):
        h = (h + 1j * rng.normal(size=(3, 6))).astype(np.complex64)
    blk._hists = h.copy()
    carry, _ = blk.fuse_export(1)
    assert carry.shape == ((3, 1, 6, 2) if dtype.startswith("complex")
                           else (3, 1, 6))
    blk._hists = np.zeros_like(h)
    blk.fuse_import(carry)
    np.testing.assert_array_equal(blk._hists, h)
    assert blk._hists.dtype == h.dtype


# ---------------------------------------------------------------------- #
# EnvelopeDetector (tests/test_filter.py:719-760)
# ---------------------------------------------------------------------- #
def envelope(dtype, attack, release, look=0):
    def build(p):
        blk = p.BlockRegistry.make("/comms/envelope_detector", dtype)
        blk.set_attack(attack)
        blk.set_release(release)
        blk.set_lookahead(look)
        return [blk]
    return build


def test_envelope_complex_matches_jax_and_oracle():
    rng = np.random.default_rng(19)
    x = (rng.normal(size=500) + 1j * rng.normal(size=500)).astype(
        np.complex64)
    x[:250] *= 5.0
    got, exp = both(envelope("complex_float32", 8.0, 24.0),
                    "complex_float32", "float32", [x[:200], x[200:]])
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, envelope_oracle(np.abs(x).astype(np.float32), 8.0, 24.0),
        rtol=0, atol=1e-4)


def test_envelope_lookahead_delay():
    n, look = 200, 10
    x = np.zeros(n, np.float32)
    x[100:] = 1.0
    got, exp = both(envelope("float32", 2.0, 2.0, look), "float32",
                    "float32", [x[:90], x[90:]])
    assert got.shape == (n - look,)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, envelope_oracle(x[look:], 2.0, 2.0),
                               rtol=0, atol=1e-4)


def test_envelope_complex_int16_input():
    rng = np.random.default_rng(21)
    vals = rng.integers(-300, 300, 300) + 1j * rng.integers(-300, 300, 300)
    ci = to_complex_int(vals, "complex_int16")
    got, exp = both(envelope("complex_int16", 4.0, 12.0), "complex_int16",
                    "float32", [ci])
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


def test_envelope_gains_are_float32_and_lookahead_blocks_fusion():
    blk = pkg.BlockRegistry.make("/comms/envelope_detector", "float32")
    blk.set_attack(10.0)
    ga, gr = blk._gains()
    assert ga == np.float32(np.exp(-1 / 10.0)) and ga.dtype == np.float32
    assert blk.fuse_ready()
    blk.set_lookahead(2)
    assert not blk.fuse_ready()
    with pytest.raises(TypeError):
        blk.device_core(1)


# ---------------------------------------------------------------------- #
# The fused FM segment (tests/test_fusion.py:106-125)
# ---------------------------------------------------------------------- #
def fm_chain(p):
    demod = p.BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dcb = p.BlockRegistry.make("/comms/dc_removal", "float32")
    dcb.set_average_size(32)
    dcb.set_cascade_size(2)
    env = p.BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(4.0)
    env.set_release(16.0)
    return [demod, dcb, env]


def test_fm_chain_fused_matches_streaming_and_jax():
    rng = np.random.default_rng(2)
    phase = np.cumsum(rng.normal(size=3 * THRESH) * 0.2)
    feeds = [np.exp(1j * phase).astype(np.complex64),
             np.exp(1j * phase[::-1]).astype(np.complex64)]
    before = envelope_rows.launches
    fused, topo = run_blocks("port", fm_chain, "complex_float32", "float32",
                             feeds, fuse=True)
    ref, _ = run_blocks("port", fm_chain, "complex_float32", "float32",
                        feeds, fuse=False)
    jfused, jtopo = run_blocks("jax", fm_chain, "complex_float32",
                               "float32", feeds, fuse=True)
    seg = topo._segments[0]
    assert len(topo._segments) == 1 and len(seg.blocks) == 3
    assert seg.engage_count >= 1 and seg.fused_elements > 0
    assert not seg.pair_engaged
    assert seg.fused_elements == jtopo._segments[0].fused_elements
    assert envelope_rows.launches == before  # CPU: the plain version
    assert fused.shape == ref.shape == (2 * 3 * THRESH,)
    np.testing.assert_allclose(fused, ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(fused, jfused, rtol=0, atol=1e-5)


def test_fm_chain_fused_blocked_pull():
    """A 2^16 pull takes the blocked follower (8 rows of 8192) inside the
    fused segment; it matches streaming and the JAX fused segment."""
    rng = np.random.default_rng(3)
    phase = np.cumsum(rng.normal(size=(1 << 16) + 37) * 0.2)
    feeds = [np.exp(1j * phase).astype(np.complex64)]
    fused, topo = run_blocks("port", fm_chain, "complex_float32", "float32",
                             feeds, fuse=True)
    jfused, _ = run_blocks("jax", fm_chain, "complex_float32", "float32",
                           feeds, fuse=True)
    assert topo._segments[0].fused_elements == 1 << 16
    assert fused.shape == (len(phase),)
    np.testing.assert_allclose(fused, jfused, rtol=0, atol=1e-5)
    ref = envelope_oracle(np.abs(np.array(_dc_demod_oracle(feeds[0], 32, 2),
                                          np.float64)), 4.0, 16.0)
    np.testing.assert_allclose(fused, ref, rtol=0, atol=2e-3)


def _dc_demod_oracle(x, d, casc):
    prev = np.concatenate([[0], x[:-1].conj()])
    dm = np.angle(x.astype(np.complex128) * prev)
    return dc_removal_oracle(dm, d, casc, False)
