"""The decimating FIR -> FFT chain of the port (``fir_fft_chain`` with
decim > 1): the ``polyphase`` form (K4, ``kernels/fir_decim.py``, then
K2) where decim <= 64 and K <= 256, else the conv form. Chained steps
against the benchmark's plain float64 reference of the decimating
channelizer (``benchmark/reference/spectrum_fir64_decim2_fft1024.py``),
the rule's answers, K4's wrapper and its refusals, the block sizes that
keep the decimation's phase, the spans ``pc.fir_fft.polyphase`` /
``pc.kernel.fir_decim`` and ``pc.op.conv_fir`` (one conv FIR a step
counted by its span), and the counter ``fir_decim.launches``.

Tolerance: spectra within 1e-5 of max |reference| (float32 sums over at
most 256 taps and an FFT, against float64), K4 within 1e-5 of max |plain|
of its plain version; carries exact. The file imports no JAX; its card
tests run on a card with

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

from pothoscomms_tpu_torch.kernels import fir_decim as k4
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
    assert run.form == "polyphase"
    prev = None
    for _ in range(3):
        x = _x(rng, C, T)
        spec, carry = run(x, carry)
        assert spec.shape == (C, T // 2 // 1024, 1024, 2)
        assert ref.check_step(cfg, taps, prev, x, spec)["spec_err"] < 1e-5
        assert torch.equal(carry, x[:, T - 63:])
        prev = x


@pytest.mark.parametrize("decim", [2, 3, 4])
@pytest.mark.parametrize("k", [1, 2, 31, 64, 65, 256])
def test_polyphase_three_steps_match_the_plain_reference(decim, k):
    """The polyphase form at D in {2, 3, 4} and K from 1 to K4's 256:
    three chained steps of C = 2, 4 windows of 64 bins a step, each within
    1e-5 of the float64 reference, every carry exact."""
    cfg = {"nbins": 64, "decim": decim}
    ref = _load(BENCH / "reference" / f"{NAME}.py")
    rng = np.random.default_rng(100 * decim + k)
    C, T = 2, decim * 64 * 4
    taps = _taps(rng, k)
    run, carry = chain.fir_fft_chain(taps, 64, C, T, decim=decim,
                                     device="cpu")
    assert run.form == "polyphase"
    prev = None
    for _ in range(3):
        x = _x(rng, C, T)
        spec, carry = run(x, carry)
        assert spec.shape == (C, 4, 64, 2)
        assert ref.check_step(cfg, taps, prev, x, spec)["spec_err"] < 1e-5
        assert torch.equal(carry, x[:, T - (k - 1):])
        prev = x


def _form_before(k, nbins, decim, block):
    """fir_fft_form as it stood with no polyphase form."""
    if decim == 1 and block % nbins == 0:
        if nbins == 1024 and 1 < k <= 65:
            return "one_pass"
        if 1 < k <= min(128, nbins) + 1:
            return "combined"
    if decim == 1 and k <= 128 and block % 128 == 0:
        return "toeplitz"
    return "conv"


def test_rule_takes_polyphase_within_k4s_contract_only():
    """decim 2 to 64 with 1 to 256 taps takes ``polyphase``; K 257 or
    decim 65 keeps ``conv``; every decim = 1 answer is as before."""
    assert chain.fir_fft_form(256, 1024, 2, 2048) == "polyphase"
    assert chain.fir_fft_form(1, 1024, 2, 2048) == "polyphase"
    assert chain.fir_fft_form(257, 1024, 2, 2048) == "conv"
    assert chain.fir_fft_form(64, 256, 64, 64 * 256) == "polyphase"
    assert chain.fir_fft_form(64, 256, 65, 65 * 256) == "conv"
    for k in range(1, 300):
        for nbins in (16, 64, 100, 128, 256, 512, 1024, 2048):
            for block in (128, 1000, 1024, 3072, 4096, 8192):
                assert chain.fir_fft_form(k, nbins, 1, block) == \
                    _form_before(k, nbins, 1, block)
                for decim in (2, 3, 4, 64, 65):
                    assert chain.fir_fft_form(k, nbins, decim, block) == (
                        "polyphase" if k <= 256 and decim <= 64 else
                        _form_before(k, nbins, decim, block))


def test_plan_fits_a_blocks_shared_memory_wherever_k4_is_taken():
    """Every K and D that K4 takes gets a block of 32 to 128 threads whose
    stage fits an H100 block's 227 KB of shared memory; the main shape
    gets 128 threads and 32 taps a phase."""
    assert k4.plan(64, 2) == (128, 32, 19520)
    for k in range(1, k4.MAX_TAPS + 1):
        for decim in range(2, k4.MAX_DECIM + 1):
            threads, jp, smem = k4.plan(k, decim)
            assert threads in (32, 64, 128) and jp % 8 == 0
            assert -(-k // decim) <= jp < -(-k // decim) + 8
            assert smem <= 232448


def _operands(rng, c, t, k):
    return (_x(rng, c, t), _x(rng, c, k - 1),
            torch.from_numpy(rng.normal(size=(k, 2)).astype(np.float32) / k))


def test_fir_decim_on_the_cpu_is_its_plain_version_with_a_fresh_carry():
    rng = np.random.default_rng(44)
    x, carry, taps = _operands(rng, 3, 600, 31)
    y, new = k4.fir_decim(x, carry, taps, 3)
    y_p, new_p = k4.fir_decim_plain(x, carry, taps, 3)
    assert torch.equal(y, y_p) and torch.equal(new, new_p)
    assert y.shape == (3, 200, 2) and y.is_contiguous()
    assert torch.equal(new, x[:, -30:])
    assert new.data_ptr() != carry.data_ptr()
    x2, carry2, _ = _operands(rng, 2, 8, 31)  # T < K - 1: part of the carry
    _, new2 = k4.fir_decim(x2, carry2, taps, 2)
    assert torch.equal(new2, torch.cat([carry2, x2], dim=1)[:, 8:])


@pytest.mark.parametrize("fault", ["dtype", "non_contiguous", "t_off_phase",
                                   "k_257", "decim_65", "decim_1", "meta",
                                   "carry_shape"])
def test_fir_decim_refuses(fault):
    rng = np.random.default_rng(45)
    x, carry, taps = _operands(rng, 2, 64, 8)
    decim, exc = 2, ValueError
    if fault == "dtype":
        x, exc = x.double(), TypeError
    elif fault == "non_contiguous":
        x = _x(rng, 64, 2).transpose(0, 1)
    elif fault == "t_off_phase":
        decim = 3
    elif fault == "k_257":
        x, carry, taps = _operands(rng, 2, 64, 257)
    elif fault == "decim_65":
        x, carry, taps = _operands(rng, 2, 130, 8)
        decim = 65
    elif fault == "decim_1":
        decim = 1
    elif fault == "meta":
        x, carry, taps = (t.to("meta") for t in (x, carry, taps))
    elif fault == "carry_shape":
        carry = carry[:, 1:].contiguous()
    with pytest.raises(exc):
        k4.fir_decim(x, carry, taps, decim)


@pytest.mark.parametrize("block,decim,nbins", [
    (3072, 2, 1024), (1024, 2, 1024), (6144, 4, 1024), (1280, 3, 256)])
def test_decimating_block_off_the_phase_is_refused(block, decim, nbins):
    with pytest.raises(ValueError, match="decim"):
        chain.fir_fft_chain(np.ones(64) / 64, nbins, 2, block, decim=decim,
                            device="cpu")


@pytest.mark.parametrize("block,decim,nbins,form", [
    (4096, 2, 1024, "polyphase"), (768, 3, 256, "polyphase"),
    (8192, 4, 1024, "polyphase"), (3072, 1, 1024, "one_pass")])
def test_blocks_on_the_phase_are_taken(block, decim, nbins, form):
    run, carry = chain.fir_fft_chain(np.ones(64) / 64, nbins, 2, block,
                                     decim=decim, device="cpu")
    assert run.form == form
    spec, _ = run(torch.zeros(2, block, 2), carry)
    assert spec.shape == (2, block // decim // nbins, nbins, 2)


def test_conv_fir_span_lies_inside_the_conv_form_span():
    """The conv form, which a decimating chain takes past K4's 256 taps."""
    run, carry = chain.fir_fft_chain(np.ones(257) / 257, 1024, 2, 4096,
                                     decim=2, device="cpu")
    assert run.form == "conv"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(torch.zeros(2, 4096, 2), carry)
    spans = host_spans(prof)
    assert [s[0] for s in spans] == ["pc.fir_fft.conv", "pc.op.conv_fir"]
    (_, a, b), (_, c, d) = spans
    assert a <= c and d <= b


def test_conv_fir_counters_count_one_call_a_step():
    """One conv FIR a step, seen by its span under a CPU profiler: one
    ``pc.op.conv_fir`` inside each step's ``pc.fir_fft.conv``, at (C, T,
    K, decim) = (3, 4096, 257, 2), which give the step's spectra [3, 2,
    1024, 2] and its carry [3, 256, 2]."""
    rng = np.random.default_rng(42)
    run, carry = chain.fir_fft_chain(_taps(rng, 257), 1024, 3, 4096,
                                     decim=2, device="cpu")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            spec, carry = run(_x(rng, 3, 4096), carry)
        assert [s[0] for s in host_spans(prof)] == ["pc.fir_fft.conv",
                                                    "pc.op.conv_fir"]
        assert spec.shape == (3, 2, 1024, 2)
        assert carry.shape == (3, 256, 2)


def test_polyphase_form_calls_fir_decim_once_a_step(monkeypatch):
    """On the CPU the form runs K4's wrapper (its plain version) once a
    step inside ``pc.fir_fft.polyphase``, and no conv FIR."""
    rng = np.random.default_rng(46)
    run, carry = chain.fir_fft_chain(_taps(rng, 64), 1024, 3, 4096, decim=2,
                                     device="cpu")
    calls = []
    wrapped = k4.fir_decim

    def counted(*args):
        calls.append(args[0].shape)
        return wrapped(*args)

    monkeypatch.setattr(k4, "fir_decim", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(1, 4):
            _, carry = run(_x(rng, 3, 4096), carry)
            assert calls == [(3, 4096, 2)] * i
    assert [s[0] for s in host_spans(prof)] == ["pc.fir_fft.polyphase"] * 3


@pytest.mark.cuda
def test_card_conv_form_spans_and_rows():
    """On the card: the conv FIR's span holds the ``cat``, cuDNN's
    convolution and the carry, K2 runs the FFT, no ``pc.`` row reaches the
    device timeline, and the spectra match the CPU's within 1e-5 (257
    taps: past K4's contract)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(43)
    taps = _taps(rng, 257)
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


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,k,decim", [
    (256, 131072, 64, 2),   # the decimating cell's step
    (1, 4096, 64, 2),       # one channel
    (3, 3000, 64, 2),       # T / D not a multiple of a block's 1024 outputs
    (3, 2998, 64, 2),       # odd rows of y not 16-byte aligned
    (4, 6000, 1, 2),        # one tap
    (2, 3000, 64, 3),       # D = 3 (the unpaired staging)
    (2, 4096, 256, 4),      # K4's most taps
    (2, 40, 63, 2),         # T < K - 1: the new carry takes from the old
])
def test_card_fir_decim_matches_plain(c, t, k, decim):
    """K4 within 1e-5 of max |plain| of its plain version; the new carry
    equal bit for bit to the last K - 1 samples of carry + x, and a fresh
    tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(c + t + k + decim)
    x, carry, taps = _operands(rng, c, t, k)
    xd, cd, hd = x.cuda(), carry.cuda(), taps.cuda()
    before = k4.fir_decim.launches
    y, new = k4.fir_decim(xd, cd, hd, decim)
    y_p, new_p = k4.fir_decim_plain(x, carry, taps, decim)
    torch.cuda.synchronize()
    assert k4.fir_decim.launches == before + 1
    assert y.shape == (c, t // decim, 2) and y.is_contiguous()
    err = (y.cpu() - y_p).abs().max() / y_p.abs().max()
    assert err < 1e-5, err
    assert torch.equal(new.cpu(), new_p), "carry against the plain version"
    assert torch.equal(new.cpu(), torch.cat([carry, x], 1)[:, t:])
    if k > 1:
        assert new.untyped_storage().data_ptr() not in (
            cd.untyped_storage().data_ptr(), xd.untyped_storage().data_ptr())


@pytest.mark.cuda
def test_card_polyphase_step_spans_rows_and_launches():
    """On the card: one K4 launch a step; ``pc.kernel.fir_decim`` inside
    ``pc.fir_fft.polyphase``; K4 and K2 the step's only device rows (no
    cuDNN, ``cat`` or permute copy) and no ``pc.`` row on the device
    timeline; the spectra within 1e-5 of the CPU's, the carry exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(47)
    taps = _taps(rng, 64)
    run, carry = chain.fir_fft_chain(taps, 1024, 4, 8192, decim=2)
    run_h, carry_h = chain.fir_fft_chain(taps, 1024, 4, 8192, decim=2,
                                         device="cpu")
    assert run.form == run_h.form == "polyphase"
    before = k4.fir_decim.launches
    for i in range(1, 4):
        x = _x(rng, 4, 8192)
        spec, carry = run(x.cuda(), carry)
        spec_h, carry_h = run_h(x, carry_h)
        torch.cuda.synchronize()
        assert k4.fir_decim.launches == before + i
        err = (spec.cpu() - spec_h).abs().max() / spec_h.abs().max()
        assert err < 1e-5
        assert torch.equal(carry.cpu(), carry_h)
    x = _x(rng, 4, 8192).cuda()
    torch.cuda.synchronize()
    # two steps: the profiler tends to lose a profile's first device row
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            _, carry = run(x, carry)
        torch.cuda.synchronize()
    spans = host_spans(prof)
    outer = [s for s in spans if s[0] == "pc.fir_fft.polyphase"]
    inner = [s for s in spans if s[0] == "pc.kernel.fir_decim"]
    assert len(outer) == len(inner) == 2
    assert all(a <= c and d <= b
               for (_, a, b), (_, c, d) in zip(outer, inner))
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert any("fir_decim_kernel" in n for n in device)
    assert any("stockham_kernel" in n for n in device)
    assert not [n for n in device if n.startswith("pc.")]
    assert all(any(kn in n for kn in ("fir_decim_kernel", "stockham_kernel",
                                      "dft_kernel")) for n in device), device
