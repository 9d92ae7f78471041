"""The decimating FIR -> FFT chain of the port (``fir_fft_chain`` with
decim > 1, the conv form): three chained steps against the benchmark's
plain float64 reference of the decimating channelizer
(``benchmark/reference/spectrum_fir64_decim2_fft1024.py``), the block
sizes that keep the decimation's phase, the span ``pc.op.conv_fir`` and
the counters ``fir_multichannel.calls`` and ``.by_shape``.

Tolerance: spectra within 1e-5 of max |reference| (float32 sums over 64
taps and a 1024-point FFT, against float64); carries exact. The file
imports no JAX; its card test runs on a card with

    python -m pytest tests/test_torch_chain_decim.py --noconftest -q
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pothoscomms_tpu_torch.parallel import chain

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
NAME = "spectrum_fir64_decim2_fft1024"


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "_decim_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _taps(rng, k):
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def _x(rng, c, t):
    return torch.from_numpy(rng.normal(size=(c, t, 2)).astype(np.float32))


def host_spans(prof, prefix="pc."):
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == DeviceType.CPU and e.name.startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


def test_decim2_three_steps_match_the_plain_reference():
    """K = 64, 1024 bins, decimation 2, C = 3, T = 4096: each of three
    chained steps within 1e-5 of the reference, every carry exact."""
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    ref = _load(BENCH / "reference" / f"{NAME}.py")
    assert (cfg["taps"], cfg["nbins"], cfg["decim"]) == (64, 1024, 2)
    rng = np.random.default_rng(41)
    C, T = 3, 4096
    taps = _taps(rng, 64)
    run, carry = chain.fir_fft_chain(taps, 1024, C, T, decim=2,
                                     device="cpu")
    assert run.form == "conv"
    prev = None
    for _ in range(3):
        x = _x(rng, C, T)
        spec, carry = run(x, carry)
        assert spec.shape == (C, T // 2 // 1024, 1024, 2)
        assert ref.check_step(cfg, taps, prev, x, spec)["spec_err"] < 1e-5
        assert torch.equal(carry, x[:, T - 63:])
        prev = x


@pytest.mark.parametrize("block,decim,nbins", [
    (3072, 2, 1024), (1024, 2, 1024), (6144, 4, 1024), (1280, 3, 256)])
def test_decimating_block_off_the_phase_is_refused(block, decim, nbins):
    with pytest.raises(ValueError, match="decim"):
        chain.fir_fft_chain(np.ones(64) / 64, nbins, 2, block, decim=decim,
                            device="cpu")


@pytest.mark.parametrize("block,decim,nbins,form", [
    (4096, 2, 1024, "conv"), (768, 3, 256, "conv"), (8192, 4, 1024, "conv"),
    (3072, 1, 1024, "one_pass")])
def test_blocks_on_the_phase_are_taken(block, decim, nbins, form):
    run, carry = chain.fir_fft_chain(np.ones(64) / 64, nbins, 2, block,
                                     decim=decim, device="cpu")
    assert run.form == form
    spec, _ = run(torch.zeros(2, block, 2), carry)
    assert spec.shape == (2, block // decim // nbins, nbins, 2)


def test_conv_fir_span_lies_inside_the_conv_form_span():
    run, carry = chain.fir_fft_chain(np.ones(64) / 64, 1024, 2, 4096,
                                     decim=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(torch.zeros(2, 4096, 2), carry)
    spans = host_spans(prof)
    assert [s[0] for s in spans] == ["pc.fir_fft.conv", "pc.op.conv_fir"]
    (_, a, b), (_, c, d) = spans
    assert a <= c and d <= b


def test_conv_fir_counters_count_one_call_a_step():
    rng = np.random.default_rng(42)
    run, carry = chain.fir_fft_chain(_taps(rng, 64), 1024, 3, 4096, decim=2,
                                     device="cpu")
    calls = chain.fir_multichannel.calls
    shape = chain.fir_multichannel.by_shape[(3, 4096, 64, 2)]
    for i in range(1, 4):
        _, carry = run(_x(rng, 3, 4096), carry)
        assert chain.fir_multichannel.calls == calls + i
        assert chain.fir_multichannel.by_shape[(3, 4096, 64, 2)] == shape + i


@pytest.mark.cuda
def test_card_conv_form_spans_and_rows():
    """On the card: the conv FIR's span holds the ``cat``, cuDNN's
    convolution and the carry, K2 runs the FFT, no ``pc.`` row reaches the
    device timeline, and the spectra match the CPU's within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(43)
    taps = _taps(rng, 64)
    run, carry = chain.fir_fft_chain(taps, 1024, 4, 8192, decim=2)
    run_h, carry_h = chain.fir_fft_chain(taps, 1024, 4, 8192, decim=2,
                                         device="cpu")
    x = _x(rng, 4, 8192)
    spec, carry = run(x.cuda(), carry)
    spec_h, carry_h = run_h(x, carry_h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(x.cuda(), carry)
        torch.cuda.synchronize()
    spans = host_spans(prof)
    assert [s[0] for s in spans if not s[0].startswith("pc.kernel.")] == [
        "pc.fir_fft.conv", "pc.op.conv_fir"]
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert any("stockham_kernel" in n for n in device)
    assert not [n for n in device if n.startswith("pc.")]
    err = (spec.cpu() - spec_h).abs().max() / spec_h.abs().max()
    assert err < 1e-5
    assert torch.equal(carry.cpu(), carry_h)
