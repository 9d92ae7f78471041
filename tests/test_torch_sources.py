"""The port's sources (blocks/sources.py) against the JAX package: the
source cases of tests/test_sources_fft.py on the same settings and seeds,
and each fused generation step against the JAX package's ``src_step``.

Tables are built in numpy float64 exactly as the JAX package builds them,
and the noise draws come from ``np.random.default_rng(seed)`` in the same
order, so every comparison here is bit for bit: the tables, the streamed
samples, the noise pool, the fused walks' samples and carries, across
three quanta whose sizes are not multiples of the JAX package's tiles
(65536 for the waveform, 4096 for the noise pool).
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch.blocks.sources import (noise_walk,
                                                  noise_walk_plain)

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}
QUANTA = (70001, 4097, 131075)  # no multiple of 65536 or 4096


def waveform(p, dtype, wave, freq=0.1, rate=1.0, ampl=1.0, offset=0.0,
             res=0.0):
    blk = p.BlockRegistry.make("/comms/waveform_source", dtype)
    blk.set_waveform(wave)
    blk.set_frequency(freq)
    blk.set_sample_rate(rate)
    blk.set_resolution(res)
    blk.set_amplitude(ampl)
    blk.set_offset(offset)
    return blk


def noise(p, dtype, wave, fast=True, mean=0.0, b=1.0, ampl=1.0, seed=7):
    src = p.BlockRegistry.make("/comms/noise_source", dtype, seed)
    src.set_waveform(wave)
    src.set_mean(mean)
    src.set_b(b)
    src.set_fast(fast)
    src.set_amplitude(ampl)
    return src


def collect(which, make, n, batches=1):
    """source -> collector, ``batches`` quota grants of n each; returns
    (samples, source)."""
    p, fx = PACKAGES[which]
    src = make(p)
    sink = fx.CollectorSink(src.dtype)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.connect(src, 0, sink, 0)
    for _ in range(batches):
        topo.run_source_elements(n)
    return sink.get_buffer(), src


def activated(make, which):
    p, _ = PACKAGES[which]
    src = make(p)
    if p is pkg:  # a lone block computes on its topology's device
        pkg.Topology(device="cpu")._register(src)
    src._active = True
    src._update_table()
    return src


WAVE_CASES = [
    ("complex_float64", "SINE", dict(freq=0.1)),
    ("complex_float32", "SINE", dict(freq=1.217e6, rate=30.72e6)),
    ("float32", "SINE", dict(freq=0.25, ampl=2.0, offset=0.5)),
    ("int16", "CONST", dict(freq=0.0, ampl=123.7)),
    ("float64", "SQUARE", dict(freq=1.0 / 16.0)),
    ("float64", "RAMP", dict(freq=1.0 / 16.0)),
    ("complex_int16", "RAMP", dict(freq=0.003, ampl=1000.0 - 300j)),
    ("complex_float64", "SINE", dict(freq=1e-4)),
    ("complex_float64", "SINE", dict(freq=-0.1)),
    ("complex_float32", "SQUARE", dict(freq=0.01, res=0.001)),
]


@pytest.mark.parametrize("dtype,wave,kw", WAVE_CASES)
def test_waveform_tables_and_stream_bit_exact(dtype, wave, kw):
    def make(p):
        return waveform(p, dtype, wave, **kw)

    got, exp = activated(make, "port"), activated(make, "jax")
    assert (got._mask, got._step) == (exp._mask, exp._step)
    assert got._table.dtype == exp._table.dtype
    np.testing.assert_array_equal(got._table, exp._table)
    # streamed in two grants (index continuity across work calls)
    a, sa = collect("port", make, 20000, batches=2)
    b, sb = collect("jax", make, 20000, batches=2)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert sa._index == sb._index


def test_waveform_auto_table_growth_and_errors():
    src = activated(lambda p: waveform(p, "complex_float64", "SINE",
                                       freq=1e-4), "port")
    assert src._step >= 16
    size = src._mask + 1
    assert size > 4096 and (size & (size - 1)) == 0
    assert src._step == round(1e-4 * size)
    bad = waveform(pkg, "complex_float64", "SINE", freq=1e-9)
    bad._active = True
    with pytest.raises(ValueError):
        bad._update_table()
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/waveform_source", "uint16")


NOISE_CASES = [
    ("float64", "NORMAL", dict(fast=True, mean=1.0, b=2.0)),
    ("float64", "NORMAL", dict(fast=False, mean=1.0, b=2.0)),
    ("float64", "UNIFORM", dict(mean=5.0, b=2.0)),
    ("int32", "POISSON", dict(mean=4.0)),
    ("complex_float64", "NORMAL", dict()),
    ("float64", "LAPLACE", dict(mean=0.0, b=1.0)),
    ("complex_float32", "NORMAL", dict(seed=11)),
    ("complex_int16", "UNIFORM", dict(b=300.0, fast=False)),
]


@pytest.mark.parametrize("dtype,wave,kw", NOISE_CASES)
def test_noise_pool_and_stream_bit_exact(dtype, wave, kw):
    def make(p):
        return noise(p, dtype, wave, **kw)

    got, exp = activated(make, "port"), activated(make, "jax")
    np.testing.assert_array_equal(got._table, exp._table)
    a, _ = collect("port", make, 40000)
    b, _ = collect("jax", make, 40000)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_noise_statistics_and_errors():
    out, _ = collect("port", lambda p: noise(p, "float64", "NORMAL",
                                             mean=1.0, b=2.0), 40000)
    assert abs(out.mean() - 1.0) < 0.15 and abs(out.std() - 2.0) < 0.2
    out, _ = collect("port", lambda p: noise(p, "complex_float64",
                                             "NORMAL"), 20000)
    assert abs(np.corrcoef(out.real, out.imag)[0, 1]) < 0.1
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/noise_source", "float32") \
            .set_waveform("BOGUS")


def _walk_both(make, quanta):
    """Three quanta of the fused generation step in each package, from
    the same streaming state; yields (port y, JAX y, port carry, JAX
    carry) per quantum."""
    got, exp = activated(make, "port"), activated(make, "jax")
    pc, pstep, pparams = got.fuse_source_export(1)
    jc, jstep, jparams = exp.fuse_source_export(1)
    for t in quanta:
        pc, py = pstep(pc, t, *pparams)
        jc, jy = jstep(jc, t, *jparams)
        yield got, exp, py, np.asarray(jy), pc, jc


@pytest.mark.parametrize("dtype,wave,kw", [
    ("complex_float32", "SINE", dict(freq=1.217e6, rate=30.72e6)),
    ("float32", "RAMP", dict(freq=0.003)),
    ("complex_float32", "SINE", dict(freq=3172.0, rate=48000.0)),
    ("complex_float32", "SINE", dict(freq=1e-4)),  # a 2^20 table
])
def test_waveform_fused_step_matches_jax(dtype, wave, kw):
    def make(p):
        return waveform(p, dtype, wave, **kw)

    for got, exp, py, jy, pc, jc in _walk_both(make, QUANTA):
        assert py.dtype == torch.float32 and tuple(py.shape) == jy.shape
        np.testing.assert_array_equal(py.numpy(), jy)
        assert pc == int(np.asarray(jc))
    # the import restores the same table index in both packages
    got.fuse_source_import(pc)
    exp.fuse_source_import(jc)
    assert got._index == exp._index


@pytest.mark.parametrize("dtype,seed", [("complex_float32", 11),
                                        ("float32", 3)])
def test_noise_fused_walk_matches_jax(dtype, seed):
    def make(p):
        return noise(p, dtype, "NORMAL", seed=seed)

    for got, exp, py, jy, pc, jc in _walk_both(make, QUANTA):
        np.testing.assert_array_equal(py.numpy(), jy)
        assert pc == int(np.asarray(jc))


def test_noise_walk_plain_equals_walk():
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(4096, 2)).astype(np.float32)
    carry_p = carry_t = 1234
    for t in QUANTA + (1, 4096):
        carry_p, yp = noise_walk_plain(pool, carry_p, t)
        carry_t, yt = noise_walk(torch.from_numpy(pool), carry_t, t)
        assert carry_p == carry_t
        np.testing.assert_array_equal(yp, yt.numpy())


def test_source_fusion_readiness():
    w = waveform(pkg, "complex_float32", "SINE", freq=0.1)
    w._active = True
    assert w.fuse_source_ready()
    w64 = waveform(pkg, "complex_float64", "SINE", freq=0.1)
    w64._active = True
    assert not w64.fuse_source_ready()
    n = noise(pkg, "complex_float32", "NORMAL", fast=False)
    n._active = True
    assert not n.fuse_source_ready()
    n.set_fast(True)
    assert n.fuse_source_ready()
