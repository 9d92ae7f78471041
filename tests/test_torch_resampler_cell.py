"""The 3:2 resampler bank with an elliptic channel filter (BASELINE config
#3 as the benchmark's ``resampler_fir99_3to2_ellip6`` runs it):
``compile_chain([/comms/fir_filter 3:2, /comms/iir_filter])`` of the
registry's blocks, chained steps against the benchmark's plain float64
reference (``benchmark/reference/resampler_fir99_3to2_ellip6.py``), the
designs, the spans ``pc.op.rational_operand``, ``pc.op.iir_products`` and
``pc.op.iir_scan`` (the IIR's blocked form, on the CPU; on a card the IIR
is I1, ``pc.kernel.iir_df2t``), one resampler product a step counted by
its span, and the counters ``iir_blocked_step.by_shape``,
``IIRFilter.fallback_steps`` and ``iir_df2t.launches``.

Tolerance: outputs and the IIR's state within 1e-5 of max |reference|:
float32 rounding through the order-6 recursion (the program reads
1.6-2.9e-6 here, a float32 sequential DF-II-T of the same resampled
stream 8.9e-6, TF32 operands 3.4e-4); the FIR's carry exact. The file
imports no JAX; its card test runs on a card with

    python -m pytest tests/test_torch_resampler_cell.py --noconftest -q
"""

import functools
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu_torch.blocks.filter import IIRFilter
from pothoscomms_tpu_torch.design.iirdes import design_iir
from pothoscomms_tpu_torch.kernels import cgemm as k1
from pothoscomms_tpu_torch.kernels.iir_df2t import iir_df2t
from pothoscomms_tpu_torch.kernels.iir_df2t import plan as i1_plan
from pothoscomms_tpu_torch.ops import filter as fops
from pothoscomms_tpu_torch.parallel import compiler

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
NAME = "resampler_fir99_3to2_ellip6"
TOL = 1e-5


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "_resampler_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CFG = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
REF = _load(BENCH / "reference" / f"{NAME}.py")
MOD = _load(BENCH / "configs" / f"{NAME}.py")
W = MOD.weights(CFG, 3000000019)


def _x(rng, c, t):
    return torch.from_numpy(rng.normal(size=(c, t, 2)).astype(np.float32))


def _chain(c, t, device="cpu"):
    return MOD.step_entry(CFG, W, c, t, torch.device(device))


def host_spans(prof, prefix="pc."):
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == DeviceType.CPU and e.name.startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


def inside(spans, outer, name):
    _, a, b = outer
    return [s for s in spans if a <= s[1] and s[2] <= b and s[0] == name]


def test_designs():
    """The configuration's IIR is scipy's ellip(6, 0.1, 60, 0.3) (0.15 of
    the rate is 0.3 of Nyquist), and the port's elliptic design gives it;
    the FIR is GNU Radio's 99 taps (compute_ntaps: int(72.2 x 3 / 2.2) =
    98, made odd), symmetric, summing to the interpolation's gain of 3."""
    b, a = design_iir("elliptic", "LOW_PASS", 6, 0.15, 0.1, 60.0)
    eb, ea = scipy.signal.ellip(6, 0.1, 60, 0.3)
    assert np.array_equal(W["b"], eb) and np.array_equal(W["a"], ea)
    np.testing.assert_allclose(b, eb, rtol=0, atol=1e-9)
    np.testing.assert_allclose(a, ea, rtol=0, atol=1e-9)
    h = W["fir"]
    ntaps = int((7.0 / 0.1102 + 8.7) * 3 / (22.0 * 0.1))
    assert len(h) == ntaps + 1 - ntaps % 2 == CFG["taps"] == 99
    assert h.sum() == pytest.approx(3.0, abs=1e-12)
    np.testing.assert_allclose(h, h[::-1], rtol=0, atol=1e-15)
    assert np.array_equal(h, MOD.weights(CFG, 7)["fir"])


def test_three_chained_steps_match_the_plain_reference():
    """C = 3, T = 4096 (the benchmark's CPU size): each of three chained
    steps within TOL of the reference, the FIR's carry exactly the step's
    last 32 inputs, the IIR's state within TOL."""
    rng = np.random.default_rng(61)
    C, T = 3, 4096
    step, carry = _chain(C, T)
    assert [tuple(c.shape) for c in carry] == [(C, 32, 2), (6, C, 2)]
    prev = None
    for _ in range(3):
        x = _x(rng, C, T)
        y, carry = step(x, carry)
        assert y.shape == (C, T * 3 // 2, 2)
        assert REF.check_step(CFG, W, prev, x, y)["out_err"] < TOL
        got = REF.check_carry(CFG, W, x, carry)
        assert got["carry_err"] == 0.0 and got["state_err"] < TOL
        assert torch.equal(carry[0], x[:, T - 32:])
        prev = x


def test_spans_nest_inside_their_blocks():
    rng = np.random.default_rng(62)
    step, carry = _chain(3, 4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_x(rng, 3, 4096), carry)
    spans = host_spans(prof)
    fir = [s for s in spans if s[0] == "pc.chain.FIRFilter"]
    iir = [s for s in spans if s[0] == "pc.chain.IIRFilter"]
    assert len(fir) == len(iir) == 1
    assert len(inside(spans, fir[0], "pc.op.rational_operand")) == 1
    assert len(inside(spans, iir[0], "pc.op.iir_scan")) == 1
    assert len(inside(spans, iir[0], "pc.op.iir_products")) == 2
    assert {s[0] for s in spans} == {
        "pc.chain.FIRFilter", "pc.op.rational_operand",
        "pc.chain.IIRFilter", "pc.op.iir_products", "pc.op.iir_scan"}


@pytest.mark.parametrize("swap", [False, True])
def test_counters_count_one_call_a_step(monkeypatch, swap):
    """One resampler product and one blocked IIR step a step: one
    ``pc.op.rational_operand`` span a step under a CPU profiler, at
    (C, T) = (3, 4096) in and 6144 out, the FIR's carry its K-1 = 32
    last inputs; the IIR at (P, T, L, order) = (6, 6144, 256, 6) and no
    other shape, which sets ceil(log2(6144 / 256)) = 5 scan rounds a
    step; no fallback. ``swap``: with both module names rebound to
    wrappers that carry the originals' attributes, as a caller that notes
    the calls does, the span and the counters still count."""
    rng = np.random.default_rng(63)
    iir = fops.iir_blocked_step.by_shape
    if swap:
        for name in ("rational_fir_mm", "iir_blocked_step"):
            fn = getattr(fops, name)
            monkeypatch.setattr(fops, name, functools.wraps(fn)(
                lambda *a, _fn=fn, **k: _fn(*a, **k)))
    step, carry = _chain(3, 4096)
    i_key = (6, 6144, 256, 6)
    before = (iir.copy(), IIRFilter.fallback_steps)
    rounds = math.ceil(math.log2(4096 * 3 // 2 // 256))
    assert rounds == (i_key[1] // i_key[2] - 1).bit_length() == 5
    for i in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y, carry = step(_x(rng, 3, 4096), carry)
        names = [s[0] for s in host_spans(prof)]
        assert names.count("pc.op.rational_operand") == 1
        assert y.shape == (3, 6144, 2) and carry[0].shape == (3, 32, 2)
        assert iir - before[0] == {i_key: i}
        assert IIRFilter.fallback_steps == before[1]


def test_fallback_counts_a_step_no_block_length_divides():
    """T = 100: no block length in (256, 128, 64, 32) divides it, so each
    step takes the per-sample fallback (counted) and no blocked step; the
    output still follows the DF-II-T recursion."""
    blk = pkg.BlockRegistry.make("/comms/iir_filter", "complex_float32")
    blk.set_taps(np.concatenate([W["b"], W["a"]]))
    step, carry = compiler.compile_chain([blk], 2, device="cpu")
    rng = np.random.default_rng(64)
    blocked = fops.iir_blocked_step.by_shape
    before = (IIRFilter.fallback_steps, blocked.copy())
    xs = [_x(rng, 2, 100) for _ in range(2)]
    ys = []
    for i, x in enumerate(xs, 1):
        y, carry = step(x, carry)
        ys.append(y)
        assert IIRFilter.fallback_steps == before[0] + i
        assert blocked == before[1]
    x = torch.cat(xs, dim=1).double().numpy()
    exp = scipy.signal.lfilter(W["b"], W["a"], x[..., 0] + 1j * x[..., 1])
    got = torch.cat(ys, dim=1).double().numpy()
    got = got[..., 0] + 1j * got[..., 1]
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < TOL


@pytest.mark.cuda
def test_card_chain_matches_the_reference_and_launches_k1_once_a_step():
    """On the card at C = 8, T = 8192: one K1 launch and one I1 call a
    step (two launches: its plan cuts the 8 rows of 12288 output samples
    into segments), each step within TOL of the reference, the carry
    exact, I1's
    span inside the IIR's block (no blocked form's spans) and no ``pc.``
    row on the device timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(65)
    C, T = 8, 8192
    step, carry = _chain(C, T, "cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_step = 2 if i1_plan(6, T * 3 // 2, 2, C, sms).segs > 1 else 1
    before = (k1.cgemm.launches, iir_df2t.launches)
    prev = None
    for i in range(1, 4):
        x = _x(rng, C, T).cuda()
        y, carry = step(x, carry)
        torch.cuda.synchronize()
        assert k1.cgemm.launches == before[0] + i
        assert iir_df2t.launches == before[1] + per_step * i
        assert REF.check_step(CFG, W, prev, x, y)["out_err"] < TOL
        got = REF.check_carry(CFG, W, x, carry)
        assert got["carry_err"] == 0.0 and got["state_err"] < TOL
        prev = x
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            _, carry = step(x, carry)
        torch.cuda.synchronize()
    spans = host_spans(prof)
    iir = [s for s in spans if s[0] == "pc.chain.IIRFilter"]
    assert len(iir) == 2
    assert all(len(inside(spans, s, "pc.kernel.iir_df2t")) == 1
               for s in iir)
    assert not [s for s in spans if s[0].startswith("pc.op.iir")]
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert any("cgemm" in n for n in device)
    assert not [n for n in device if n.startswith("pc.")]
