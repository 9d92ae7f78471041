"""The decimating channelizer's files (``spectrum_fir64_decim2_fft1024``,
cell ``spectrum_decim2_ch256``): the taps, the plain reference against
numpy in float64, the TF32 control against the limit it has to fail, the
closed-loop faults caught in the cell, the work count against numbers
worked out by hand, and the two stage readers on synthetic traces."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_helpers import run_cell
from benchmark import generate, harness
from test_bench_harness import FAULTS

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME, CELL = "spectrum_fir64_decim2_fft1024", "spectrum_decim2_ch256"
PEAKS = json.loads((BENCH / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


def load():
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    return (cfg, harness.load_module(BENCH / "reference" / f"{NAME}.py"),
            harness.load_module(BENCH / "configs" / f"{NAME}.py"))


def as_complex(planar: torch.Tensor) -> np.ndarray:
    a = planar.double().numpy()
    return a[..., 0] + 1j * a[..., 1]


# ---------------------------------------------------------------------- #
# the taps
# ---------------------------------------------------------------------- #
def test_taps_select_the_band_at_an_eighth_of_the_rate():
    """Unit gain at +f_s/8, the pass band's centre, and within 0.15 cycles
    a sample of it; the stop band 0.4 cycles a sample from the centre and
    beyond held below 1e-4; every tap nonzero; the same taps for every
    seed."""
    cfg, _, mod = load()
    h = mod.weights(cfg, 3000000041)
    assert h.shape == (cfg["taps"],) and np.iscomplexobj(h)
    assert np.array_equal(h, mod.weights(cfg, 7))
    assert np.all(np.abs(h) > 0)

    def gain(f):
        return abs(np.sum(h * np.exp(-2j * np.pi * f * np.arange(len(h)))))

    assert gain(0.125) == pytest.approx(1.0, abs=1e-12)
    assert gain(0.125 + 0.15) > 0.9 and gain(0.125 - 0.15) > 0.9
    for f in (0.125 + 0.5, 0.125 + 0.4, 0.125 - 0.4):
        assert gain(f) < 1e-4


# ---------------------------------------------------------------------- #
# the reference and the control
# ---------------------------------------------------------------------- #
def numpy_spectra(taps, prev, x, nbins, decim):
    """np.convolve over the last K - 1 samples of prev and x, every
    ``decim``-th output kept, then the DFT of each window: float64."""
    k = len(taps)
    out = []
    for c in range(x.shape[0]):
        hist = prev[c, -(k - 1):] if prev is not None else np.zeros(k - 1)
        y = np.convolve(np.concatenate([hist, x[c]]), taps, "valid")
        out.append(np.fft.fft(y[::decim].reshape(-1, nbins), axis=-1))
    return np.stack(out)


@pytest.mark.parametrize("with_prev", [False, True])
def test_reference_against_numpy(with_prev):
    cfg, ref, mod = load()
    taps = mod.weights(cfg, 0)
    pool = generate.pool({"kind": "complex_normal"}, 2, 3, 4096, 21,
                         torch.device("cpu"))
    prev = pool[0] if with_prev else None
    got = ref.spectra(cfg, taps, prev, pool[1], 0, 3).numpy()
    exp = numpy_spectra(taps, as_complex(prev) if with_prev else None,
                        as_complex(pool[1]), cfg["nbins"], cfg["decim"])
    assert got.shape == exp.shape == (3, 2, 1024)
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < 1e-13


def test_control_fails_its_limit():
    cfg, ref, mod = load()
    taps = mod.weights(cfg, 0)
    x0, x1 = generate.pool({"kind": "complex_normal"}, 2, 4, 4096, 23,
                           torch.device("cpu"))
    y = ref.control_output(cfg, taps, x0, x1)
    assert y.shape == (4, 2, 1024, 2)
    err = ref.check_step(cfg, taps, x0, x1, y)["spec_err"]
    assert err > 3 * cfg["limits"]["spec_err"]


# ---------------------------------------------------------------------- #
# the cell
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_closed_loop_fault_is_caught(tiny_root, capsys, monkeypatch, fault):
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    c = harness.Cell(man, CELL, tiny_root)
    entry = c.config_module.step_entry

    def broken_entry(*a, **k):
        step, carry = entry(*a, **k)
        return FAULTS[fault](step), carry

    monkeypatch.setattr(c.config_module, "step_entry", broken_entry)
    rc, res, err = run_cell(tiny_root, CELL, capsys)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] > 0


# ---------------------------------------------------------------------- #
# the work count and the stage readers
# ---------------------------------------------------------------------- #
def work(channels, samples):
    counts = harness.load_module(BENCH / "counts" / f"{NAME}.py")
    cfg, _, _ = load()
    return counts.work(cfg, {"channels": channels, "samples": samples})


def test_counts_by_hand():
    """256 x 131072 samples, 65536 outputs a channel kept: the FIR
    8 x 64 flops an output, 16384 transforms of 5 x 1024 x 10; bytes: 8
    in a sample, 8 out a kept sample, the carry's 63 samples in and out a
    channel, 64 taps; the FFT stage reads and writes 8 bytes a kept
    sample."""
    got = work(256, 131072)
    fir_flops = 256 * 65536 * 512
    fft_flops = 16384 * 5 * 1024 * 10
    nbytes = 256 * 131072 * 8 + 256 * 65536 * 8 + 2 * 256 * 63 * 8 + 64 * 8
    assert (fir_flops, fft_flops, nbytes) == (8589934592, 838860800,
                                              402911744)
    assert got["flops"] == pytest.approx(fir_flops + fft_flops, rel=1e-12)
    assert got["bytes"] == nbytes
    assert got["stages"]["fir"] == {"flops": fir_flops, "bytes": nbytes}
    assert got["stages"]["fft"]["flops"] == pytest.approx(fft_flops,
                                                          rel=1e-12)
    assert got["stages"]["fft"]["bytes"] == 2 * 134217728


def test_counts_read_only_the_shape():
    src = (BENCH / "counts" / f"{NAME}.py").read_text()
    assert "pothoscomms" not in src and "import torch" not in src


def reader(stage):
    return harness.load_module(
        BENCH / "metrics" / f"kernel_roofline_pct.{stage}.py")


def synthetic(k2_s=0.11e-3, other_s=2.9e-3, steps=10):
    """A trace of ``steps`` steps: K2's two kernels, cuDNN's convolution
    and a copy, each step's time as given."""
    ops = [["void (anonymous namespace)::stockham_kernel<false, true>("
            "float2 const*, float2*)", 0.9 * k2_s * steps],
           ["void (anonymous namespace)::dft_kernel<false>(float2 const*)",
            0.1 * k2_s * steps],
           ["sm90_xmma_fprop_implicit_gemm_f32f32", 0.8 * other_s * steps],
           ["void at::native::CatArrayBatchedCopy", 0.2 * other_s * steps]]
    return {"steps": steps, "kernel_s": (k2_s + other_s) * steps,
            "device_ops": ops}


def test_stage_readers_on_a_synthetic_trace():
    w = work(256, 131072)
    m = {"work": w, "peaks": PEAKS, "trace": synthetic()}
    fir_least = 402911744 / 3.35e12
    fft_least = 268435456 / 3.35e12
    assert reader("fft").read(m) == pytest.approx(100 * fft_least / 0.11e-3)
    assert reader("fir").read(m) == pytest.approx(100 * fir_least / 2.9e-3)
    assert 50 < reader("fft").read(m) < 100
    assert 3 < reader("fir").read(m) < 5


@pytest.mark.parametrize("stage", ["fir", "fft"])
def test_stage_readers_find_nothing_to_read(stage):
    w = work(256, 131072)
    read = reader(stage).read
    no_k2 = synthetic()
    no_k2["device_ops"] = no_k2["device_ops"][2:]
    assert read({"work": w, "peaks": PEAKS, "trace": no_k2}) is None
    assert read({"work": w, "peaks": PEAKS}) is None
    assert read({"work": w, "peaks": None, "trace": synthetic()}) is None
    flat = {k: v for k, v in w.items() if k != "stages"}
    assert read({"work": flat, "peaks": PEAKS, "trace": synthetic()}) is None
    cpu = {"steps": 4, "kernel_s": 0.0, "device_ops": []}
    assert read({"work": w, "peaks": PEAKS, "trace": cpu}) is None
