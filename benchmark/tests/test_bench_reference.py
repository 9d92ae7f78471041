"""The plain references against an independent float64 computation (numpy)
and against the port on ``device="cpu"``, at tiny sizes; the controls
against the limits they have to fail."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import generate, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC, FM = "spectrum_fir64_fft1024", "fm_receiver_256ch"


def load(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return (cfg, harness.load_module(BENCH / "reference" / f"{name}.py"),
            harness.load_module(BENCH / "configs" / f"{name}.py"))


def fm_signal():
    t = json.loads((BENCH / "traffic" / "fm_ch256_t131072_pool4.json")
                   .read_text())
    return t["signal"]


def as_complex(planar: torch.Tensor) -> np.ndarray:
    a = planar.double().numpy()
    return a[..., 0] + 1j * a[..., 1]


# ---------------------------------------------------------------------- #
# spectrum_fir64_fft1024
# ---------------------------------------------------------------------- #
def numpy_spectra(taps, prev, x, nbins):
    """np.convolve over the last K - 1 samples of prev and x, then the DFT
    of each window: float64 throughout."""
    k = len(taps)
    out = []
    for c in range(x.shape[0]):
        hist = prev[c, -(k - 1):] if prev is not None else np.zeros(k - 1)
        y = np.convolve(np.concatenate([hist, x[c]]), taps, "valid")
        out.append(np.fft.fft(y.reshape(-1, nbins), axis=-1))
    return np.stack(out)


@pytest.mark.parametrize("with_prev", [False, True])
def test_spectrum_reference_against_numpy(with_prev):
    cfg, ref, mod = load(SPEC)
    taps = mod.weights(cfg, 3000000023)
    pool = generate.pool({"kind": "complex_normal"}, 2, 3, 2048, 11,
                         torch.device("cpu"))
    prev = pool[0] if with_prev else None
    got = ref.spectra(cfg, taps, prev, pool[1], 0, 3).numpy()
    exp = numpy_spectra(taps, as_complex(prev) if with_prev else None,
                        as_complex(pool[1]), cfg["nbins"])
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < 1e-13


def test_spectrum_reference_against_the_port_on_cpu():
    """Two chained steps of ``fir_fft_chain`` on the CPU: the second's
    spectra within the limit and its carry exact."""
    cfg, ref, mod = load(SPEC)
    taps = mod.weights(cfg, 5)
    dev = torch.device("cpu")
    x0, x1 = generate.pool({"kind": "complex_normal"}, 2, 3, 4096, 12, dev)
    step, carry = mod.step_entry(cfg, taps, 3, 4096, dev)
    y0, carry = step(x0, carry)
    y1, carry = step(x1, carry)
    lim = cfg["limits"]
    assert ref.check_step(cfg, taps, None, x0, y0)["spec_err"] \
        <= lim["spec_err"]
    assert ref.check_step(cfg, taps, x0, x1, y1)["spec_err"] \
        <= lim["spec_err"]
    assert ref.check_carry(cfg, taps, x1, carry) == {"carry_err": 0.0}


def test_spectrum_control_fails_its_limit():
    cfg, ref, mod = load(SPEC)
    taps = mod.weights(cfg, 6)
    x0, x1 = generate.pool({"kind": "complex_normal"}, 2, 4, 4096, 13,
                           torch.device("cpu"))
    y = ref.control_output(cfg, taps, x0, x1)
    err = ref.check_step(cfg, taps, x0, x1, y)["spec_err"]
    assert err > 3 * cfg["limits"]["spec_err"]


def test_round_tf32():
    cfg, ref, _ = load(SPEC)
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -12), 3.0e-20])
    got = ref.round_tf32(x)
    assert got[:4].tolist() == [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9]
    assert got[4].item() == -1.0
    r = torch.randn(10000)
    rel = ((ref.round_tf32(r) - r).abs() / r.abs()).max().item()
    assert 2 ** -13 < rel <= 2 ** -11


# ---------------------------------------------------------------------- #
# fm_receiver_256ch
# ---------------------------------------------------------------------- #
def numpy_fm(w, full: np.ndarray, count: int) -> np.ndarray:
    """The three blocks over ``full`` [C, n] complex in float64 with numpy,
    the envelope as the plain sequential recurrence; the last ``count``
    outputs."""
    c, n = full.shape
    prev = np.concatenate([np.zeros((c, 1)), full[:, :-1]], axis=1)
    u = np.angle(full * np.conj(prev))
    u[np.abs(prev) == 0] = 0.0
    d = w["average"]
    a = u
    for _ in range(w["cascade"]):
        a = np.stack([np.convolve(r, np.ones(d))[:n] / d for r in a])
    delayed = np.concatenate([np.zeros((c, d - 1)), u[:, :n - d + 1]], axis=1)
    mag = np.abs(delayed - a)
    ga, gr = math.exp(-1 / w["attack"]), math.exp(-1 / w["release"])
    e = np.zeros(c)
    y = np.empty((c, n))
    for i in range(n):
        g = np.where(mag[:, i] > e, ga, gr)
        e = g * e + (1 - g) * mag[:, i]
        y[:, i] = e
    return y[:, n - count:]


@pytest.mark.parametrize("with_prev", [False, True])
def test_fm_reference_against_numpy(with_prev):
    cfg, ref, mod = load(FM)
    w = mod.weights(cfg, 0)
    pool = generate.pool(fm_signal(), 2, 2, 3072, 14, torch.device("cpu"))
    prev = pool[0] if with_prev else None
    got = ref.envelope(cfg, w, prev, pool[1]).numpy()
    full = as_complex(torch.cat([pool[0], pool[1]], 1) if with_prev
                      else pool[1])
    exp = numpy_fm(w, full, 3072)
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < 1e-12


def test_fm_reference_against_the_port_on_cpu():
    """Two chained steps of the compiled chain on the CPU (the blocked
    envelope core at 8192 samples a step): the second within the limit."""
    cfg, ref, mod = load(FM)
    w = mod.weights(cfg, 0)
    dev = torch.device("cpu")
    x0, x1 = generate.pool(fm_signal(), 2, 2, 8192, 15, dev)
    step, carry = mod.step_entry(cfg, w, 2, 8192, dev)
    y0, carry = step(x0, carry)
    y1, carry = step(x1, carry)
    lim = cfg["limits"]["env_err"]
    assert ref.check_step(cfg, w, None, x0, y0)["env_err"] <= lim
    assert ref.check_step(cfg, w, x0, x1, y1)["env_err"] <= lim


def test_fm_control_fails_its_limit():
    cfg, ref, mod = load(FM)
    w = mod.weights(cfg, 0)
    x0, x1 = generate.pool(fm_signal(), 2, 2, 4096, 16, torch.device("cpu"))
    y = ref.control_output(cfg, w, x0, x1)
    assert ref.check_step(cfg, w, x0, x1, y)["env_err"] \
        > 3 * cfg["limits"]["env_err"]


def test_fm_signal_stays_off_the_branch_cut():
    """The phase step between samples stays well inside +-pi, so float32
    and float64 discriminators agree on every sample."""
    x = as_complex(torch.cat(generate.pool(fm_signal(), 4, 3, 4096, 17,
                                           torch.device("cpu")), 1))
    step = np.angle(x[:, 1:] * np.conj(x[:, :-1]))
    wrap = np.angle(x[:, :1] * np.conj(x[:, -1:]))  # the pool's cycle
    assert np.max(np.abs(step)) < 0.8 * math.pi
    assert np.max(np.abs(wrap)) < 0.8 * math.pi
