"""The probes P1 (``stream_scale``) and P2 (``layout_move``) in the port
against the Pallas kernels of benches/probe_pallas_ceiling.py and
benches/probe_mosaic.py, run with the probes' own block specs through
``pl.pallas_call(..., interpret=True)`` (the probes' jitted calls do not
take interpret mode, and the CPU backend runs Pallas only so), and
against the probes' numpy oracles.

Inputs are float32 arrays made with numpy.random.default_rng(seed).
Tolerance: bit-exact everywhere (x 2 and permutations are exact).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benches.probe_pallas_ceiling import _scale_kernel
from pothoscomms_tpu_torch.kernels.layout_move import (MODES, layout_move,
                                                       layout_move_plain)
from pothoscomms_tpu_torch.kernels.stream_scale import (stream_scale,
                                                        stream_scale_plain)

torch.set_num_threads(1)

B, N, TB = 512, 1024, 256


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def scale_interpret(xr, xi, tb):
    """probe_pallas_ceiling.scale_pallas with interpret=True."""
    b, n = xr.shape
    spec = pl.BlockSpec((tb, n), lambda i: (i, i * 0))
    return pl.pallas_call(
        _scale_kernel, grid=(b // tb,), in_specs=[spec, spec],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((b, n), jnp.float32),
                   jax.ShapeDtypeStruct((b, n), jnp.float32)),
        interpret=True)(xr, xi)


@pytest.mark.parametrize("tb", [128, 256, 512])
def test_stream_scale_equals_pallas_probe(tb):
    xr, xi = _normal(1, B, N), _normal(2, B, N)
    jr, ji = scale_interpret(jnp.asarray(xr), jnp.asarray(xi), tb)
    before = stream_scale.launches
    yr, yi = stream_scale(torch.from_numpy(xr), torch.from_numpy(xi), tb)
    assert stream_scale.launches == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))
    pr, pi = stream_scale_plain(torch.from_numpy(xr), torch.from_numpy(xi))
    assert torch.equal(pr, yr) and torch.equal(pi, yi)


def test_stream_scale_rejects_bad_operands():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        stream_scale(x, torch.zeros(4, 9))
    with pytest.raises(TypeError):
        stream_scale(x.double(), x.double())
    with pytest.raises(ValueError):
        stream_scale(x, x, 0)


# The probe's four bodies (probe_mosaic.py:55, 61, 67-68, 75) and numpy
# oracles (:56, 62, 69-70, 76) at its tb = 256, N = 1024.
BODIES = {
    "A": lambda x: jnp.swapaxes(x.reshape(TB, 8, 128), 1, 2).reshape(TB, N),
    "B": lambda x: jnp.swapaxes(x.reshape(TB, 128, 8), 1, 2).reshape(TB, N),
    "C": lambda x: jnp.transpose(
        x.reshape(TB, 8, 16, 8), (0, 3, 2, 1)).reshape(TB, N),
    "D": lambda x: jnp.concatenate([x[:, m::8] for m in range(8)], axis=1),
}
ORACLES = {
    "A": lambda x: np.swapaxes(x.reshape(-1, 8, 128), 1, 2).reshape(-1, N),
    "B": lambda x: np.swapaxes(x.reshape(-1, 128, 8), 1, 2).reshape(-1, N),
    "C": lambda x: np.transpose(
        x.reshape(-1, 8, 16, 8), (0, 3, 2, 1)).reshape(-1, N),
    "D": lambda x: np.concatenate([x[:, m::8] for m in range(8)], axis=1),
}


def move_interpret(x, body):
    """probe_mosaic.try_kernel's run with interpret=True."""
    b, n = x.shape

    def kernel(x_ref, y_ref):
        y_ref[:] = body(x_ref[:])

    spec = pl.BlockSpec((TB, n), lambda i: (i, i * 0))
    return pl.pallas_call(
        kernel, grid=(b // TB,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((b, n), jnp.float32),
        interpret=True)(x)


@pytest.mark.parametrize("mode", MODES)
def test_layout_move_equals_pallas_probe_and_oracle(mode):
    x = _normal(3, B, N)
    exp = np.asarray(move_interpret(jnp.asarray(x), BODIES[mode]))
    np.testing.assert_array_equal(exp, ORACLES[mode](x))
    before = layout_move.launches
    got = layout_move(torch.from_numpy(x), mode)
    assert layout_move.launches == before
    np.testing.assert_array_equal(got.numpy(), exp)
    assert torch.equal(layout_move_plain(torch.from_numpy(x), mode), got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,n", [(3, 64), (5, 192), (2, 8192)])
def test_layout_move_other_widths_match_the_oracle_form(mode, b, n):
    """The kernel's map at N = 8 m: A (8, m) swap, B (m, 8) swap, C (8,
    m/8, 8) transpose, D the stride-8 gather, as numpy writes them."""
    x = _normal(b + n, b, n)
    m = n // 8
    exp = {"A": np.swapaxes(x.reshape(b, 8, m), 1, 2),
           "B": np.swapaxes(x.reshape(b, m, 8), 1, 2),
           "C": np.transpose(x.reshape(b, 8, m // 8, 8), (0, 3, 2, 1)),
           "D": np.concatenate([x[:, k::8] for k in range(8)], axis=1)}
    np.testing.assert_array_equal(
        layout_move(torch.from_numpy(x), mode).numpy(),
        exp[mode].reshape(b, n))


def test_layout_move_rejects_bad_operands():
    with pytest.raises(ValueError):
        layout_move(torch.zeros(2, 100), "A")  # N not a multiple of 64
    with pytest.raises(ValueError):
        layout_move(torch.zeros(2, 128), "E")
    with pytest.raises(TypeError):
        layout_move(torch.zeros(2, 128, dtype=torch.float64), "A")


def _probe_module(name):
    """A module of benches_torch/ (not a package), loaded by its path."""
    path = Path(__file__).resolve().parents[1] / "benches_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bt_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_p1_library_yardstick_computes_p1():
    """chip_smoke's library_ms for P1 times one torch._foreach_mul of both
    planes by 2: it must compute stream_scale's function, bit for bit."""
    xr, xi = (torch.from_numpy(_normal(s, 64, N)) for s in (31, 32))
    lr, li = torch._foreach_mul((xr, xi), 2.0)
    pr, pi = stream_scale_plain(xr, xi)
    assert torch.equal(lr, pr) and torch.equal(li, pi)


@pytest.mark.parametrize("events,calls,per_call,ms,floor,holds", [
    (20, 20, 1, 0.2132, 0.160, True),
    (40, 20, 2, 0.1806, 0.160, True),
    (19, 20, 1, 0.2132, 0.160, False),    # an event lost
    (20, 20, 1, 0.1049, 0.160, False),    # below the bound
    (20, 20, 1, 0.0092, 0.0100, False),   # P2 read from L2
    (0, 20, 0, 0.0, 0.0, False),          # nothing recorded
])
def test_device_time_readings_need_every_event_and_the_bound(
        events, calls, per_call, ms, floor, holds):
    probe = _probe_module("probe_stream_ceiling")
    assert probe.reading_holds(events, calls, per_call, ms, floor) is holds


def test_bytes_bound_is_hbm_time():
    probe = _probe_module("probe_stream_ceiling")
    assert probe.bytes_bound_ms(2 * 4096 * 1024 * 4) == pytest.approx(
        0.0100165, rel=1e-4)
