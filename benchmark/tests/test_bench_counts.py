"""The work counts of the four cells against numbers worked out by hand,
and the roofline reader against them."""

import json
import math
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def work(name, channels, samples):
    counts = harness.load_module(BENCH / "counts" / f"{name}.py")
    return counts.work(cfg(name), {"channels": channels, "samples": samples})


# (config, channels, samples a step, flops, bytes), worked out by hand:
# the FIR 8 flops x 64 taps a sample, the FFT 5 x 1024 x 10 a transform of
# 1024, i.e. 512 + 50 = 562 flops a sample; bytes: 8 in and 8 out a
# complex sample, the carry's 63 samples in and out a channel, 64 taps;
# FM: 8 in and 4 out a sample, the state 8 + 2 x 64 x 4 + 4 = 524 bytes
# a channel, in and out
HAND = [
    ("spectrum_fir64_fft1024", 256, 131072,
     33554432 * 562, 33554432 * 16 + 2 * 256 * 63 * 8 + 64 * 8),
    ("spectrum_fir64_fft1024", 1, 33554432,
     33554432 * 562, 33554432 * 16 + 2 * 63 * 8 + 64 * 8),
    ("fm_receiver_256ch", 256, 131072, 0, 33554432 * 12 + 2 * 256 * 524),
    ("fm_receiver_256ch", 256, 16384, 0, 4194304 * 12 + 2 * 256 * 524),
]


@pytest.mark.parametrize("name,c,t,flops,nbytes", HAND,
                         ids=["spectrum_ch256", "spectrum_wideband_topology",
                              "fm_rx_ch256", "fm_rx_ch256_t16k"])
def test_counts_by_hand(name, c, t, flops, nbytes):
    got = work(name, c, t)
    assert got["flops"] == pytest.approx(flops, rel=1e-12)
    assert got["bytes"] == nbytes


def test_spectrum_numbers_as_stated():
    got = work("spectrum_fir64_fft1024", 256, 131072)
    assert got["flops"] == 18857590784
    assert got["bytes"] == 537129472  # 537 MB, 0.160 ms at 3.35 TB/s


@pytest.mark.parametrize("name", ["spectrum_fir64_fft1024",
                                  "fm_receiver_256ch"])
def test_counts_read_only_the_shape(name):
    """The count is the configuration's and the traffic's, whatever
    kernels run: it imports nothing of the program."""
    src = (BENCH / "counts" / f"{name}.py").read_text()
    assert "pothoscomms" not in src and "import torch" not in src


def test_roofline_reader():
    reader = harness.load_module(BENCH / "metrics" / "kernel_roofline_pct.py")
    peaks = json.loads((BENCH / "peaks.json").read_text())[
        "NVIDIA H100 80GB HBM3"]
    w = work("spectrum_fir64_fft1024", 256, 131072)
    least = max(w["bytes"] / 3.35e12, w["flops"] / 4.95e14)
    assert least == pytest.approx(537129472 / 3.35e12)
    m = {"work": w, "peaks": peaks,
         "trace": {"steps": 10, "kernel_s": 10 * 3.2e-3}}
    assert reader.read(m) == pytest.approx(100 * least / 3.2e-3)
    assert reader.read({"work": w, "peaks": peaks}) is None
    assert reader.read({"work": w, "peaks": None,
                        "trace": m["trace"]}) is None
    fm = work("fm_receiver_256ch", 256, 131072)
    m = {"work": fm, "peaks": peaks,
         "trace": {"steps": 4, "kernel_s": 4 * 5.4e-3}}
    assert reader.read(m) == pytest.approx(
        100 * fm["bytes"] / 3.35e12 / 5.4e-3)
    assert math.isfinite(reader.read(m))
