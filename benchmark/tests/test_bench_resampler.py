"""The resampler bank's files (``resampler_fir99_3to2_ellip6``, cell
``resampler_3to2_ch256``): the plain reference against a scipy oracle in
float64, its IIR rows and the IIR control's blocked form against one
sequential run, the weights made outside the port, the TF32 controls
(the IIR in float64 or on TF32 operands too) against the limits they
have to fail and a float32 sequential IIR against the limit it has to
pass, the closed-loop faults caught in the cell, the
work count against numbers worked out by hand, and the two stage readers
on synthetic traces."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch

from bench_helpers import run_cell
from benchmark import generate, harness
from test_bench_harness import FAULTS

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME, CELL = "resampler_fir99_3to2_ellip6", "resampler_3to2_ch256"
PEAKS = json.loads((BENCH / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


def load():
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    return (cfg, harness.load_module(BENCH / "reference" / f"{NAME}.py"),
            harness.load_module(BENCH / "configs" / f"{NAME}.py"))


def as_complex(planar: torch.Tensor) -> np.ndarray:
    a = planar.double().numpy()
    return a[..., 0] + 1j * a[..., 1]


def oracle(w, x):
    """Upsample by 3, filter with the taps, keep outputs u = 2 t + 1, then
    scipy's lfilter from the zero state; float64, per channel: (resampled,
    output) [C, 3 T / 2]."""
    res, out = [], []
    for row in x:
        up = np.zeros(3 * len(row), np.complex128)
        up[::3] = row
        r = np.convolve(up, w["fir"])[:len(up)][1::2]
        res.append(r)
        out.append(scipy.signal.lfilter(w["b"], w["a"], r))
    return np.stack(res), np.stack(out)


def pool(count, c, t, seed):
    return generate.pool({"kind": "complex_normal"}, count, c, t, seed,
                         torch.device("cpu"))


# ---------------------------------------------------------------------- #
# the reference and the control
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("with_prev", [False, True])
def test_reference_against_scipy(with_prev):
    """One step (the stream's first, or its second behind a previous
    input) against the oracle over the whole stream: the resampled
    samples and the output within 1e-13 of max |oracle|, the IIR's state
    after the step within 1e-13 of scipy's."""
    cfg, ref, mod = load()
    w = mod.weights(cfg, 3000000041)
    x0, x1 = pool(2, 3, 4096, 31)
    prev, x = (x0, x1) if with_prev else (None, x0)
    whole = np.concatenate([as_complex(x0), as_complex(x1)], axis=1) \
        if with_prev else as_complex(x0)
    res, exp = oracle(w, whole)
    n = 6144
    got = ref.output(cfg, w, prev, x).numpy()
    assert got.shape == (3, n)
    assert np.max(np.abs(got - exp[:, -n:])) / np.max(np.abs(exp)) < 1e-13
    v = ref._stream(cfg, w, prev, x, False).numpy()
    assert np.max(np.abs(v - res[:, -n:])) / np.max(np.abs(res)) < 1e-13
    zf = np.stack([scipy.signal.lfilter(w["b"], w["a"], r,
                                        zi=np.zeros(6, np.complex128))[1]
                   for r in res], axis=1)
    state = ref._tail_state(cfg, w, x).numpy()
    assert np.max(np.abs(state - zf)) / np.max(np.abs(zf)) < 1e-13


def test_rows_restart_against_one_sequential_run():
    """The IIR's rows, each from the zero state ``warm_len`` samples
    before it, against one sequential run over the whole stream."""
    cfg, ref, mod = load()
    w = mod.weights(cfg, 0)
    assert ref.warm_len(w["a"]) == 1536  # 2 x 701 rounded up to 256s
    rng = np.random.default_rng(32)
    v = rng.normal(size=(2, 9000)) + 1j * rng.normal(size=(2, 9000))
    exp = scipy.signal.lfilter(w["b"], w["a"], v)
    for count in (9000 - 1536, 5000, 700, 6):
        got = ref.iir_tail(w, torch.from_numpy(v), count).numpy()
        err = np.max(np.abs(got - exp[:, -count:])) / np.max(np.abs(exp))
        assert err < 1e-13, count
    got = ref.iir_tail(w, torch.from_numpy(v), 9000).numpy()  # the start
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < 1e-13


def test_blocked_form_against_one_sequential_run():
    """The IIR control's blocked state-space form, unrounded, against
    scipy's lfilter over the whole stream from the zero state: the output
    (a length that is no multiple of the block) and the final state."""
    cfg, ref, mod = load()
    w = mod.weights(cfg, 0)
    rng = np.random.default_rng(35)
    v = rng.normal(size=(2, 9000)) + 1j * rng.normal(size=(2, 9000))
    runs = [scipy.signal.lfilter(w["b"], w["a"], r,
                                 zi=np.zeros(6, np.complex128)) for r in v]
    exp = np.stack([y for y, _ in runs])
    zf = np.stack([z for _, z in runs], axis=1)
    y, z = ref.iir_blocks(w, torch.from_numpy(v), 7000, False)
    assert np.max(np.abs(y.numpy() - exp[:, -7000:])) \
        / np.max(np.abs(exp)) < 1e-13
    assert np.max(np.abs(z.numpy() - zf)) / np.max(np.abs(zf)) < 1e-13


@pytest.mark.parametrize("iir", [False, True])
def test_control_fails_its_limits(iir):
    """The TF32 control, with the IIR in float64 or (``iir``) on TF32
    operands too, fails ``out_err`` and ``state_err`` by 3x or more."""
    cfg, ref, mod = load()
    w = mod.weights(cfg, 0)
    x0, x1 = pool(2, 4, 4096, 33)
    y = ref.control_output(cfg, w, x0, x1, iir=iir)
    assert y.shape == (4, 6144, 2)
    err = ref.check_step(cfg, w, x0, x1, y)["out_err"]
    assert err > 3 * cfg["limits"]["out_err"]
    got = ref.check_carry(cfg, w, x1, ref.control_carry(cfg, w, x1, iir=iir))
    assert got["carry_err"] == 0.0
    assert got["state_err"] > 3 * cfg["limits"]["state_err"]


def test_float32_sequential_iir_passes_out_err():
    """scipy's lfilter on complex64 (a float32 sequential DF-II-T) of the
    float64 resampled stream: float32 rounding, which the limit admits."""
    cfg, ref, mod = load()
    w = mod.weights(cfg, 0)
    x0, x1 = pool(2, 4, 4096, 34)
    v = ref._stream(cfg, w, None, torch.cat([x0, x1], dim=1), False)
    v32 = v.numpy().astype(np.complex64)
    y = np.stack([scipy.signal.lfilter(w["b"].astype(np.float32),
                                       w["a"].astype(np.float32), r)
                  for r in v32])
    assert y.dtype == np.complex64
    y1 = torch.view_as_real(torch.from_numpy(y[:, 6144:]).contiguous())
    err = ref.check_step(cfg, w, x0, x1, y1)["out_err"]
    assert 1e-7 < err < cfg["limits"]["out_err"]


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
    """256 x 131072 samples in, 3/2 as many out (50,331,648): the
    resampler 4 x 33 flops an output, the IIR 2 x 2 x 13; bytes: 8 in a
    sample and 8 out an output, the FIR's 32-sample carry in and out a
    channel, the IIR's 6-sample state in and out a channel, 99 + 14
    float32 taps."""
    got = work(256, 131072)
    out = 256 * 196608
    res_flops, iir_flops = out * 132, out * 52
    res_bytes = 256 * 131072 * 8 + 2 * 256 * 32 * 8 + 99 * 4 + out * 8
    iir_bytes = out * 8 + 2 * 256 * 6 * 8 + 14 * 4 + out * 8
    nbytes = 256 * 131072 * 8 + 2 * 256 * 32 * 8 + 99 * 4 \
        + 2 * 256 * 6 * 8 + 14 * 4 + out * 8
    assert (res_flops, iir_flops, res_bytes, iir_bytes, nbytes) == (
        6643777536, 2617245696, 671220108, 805331000, 671244740)
    assert got["flops"] == res_flops + iir_flops
    assert got["bytes"] == nbytes
    assert got["stages"] == {
        "resampler": {"flops": res_flops, "bytes": res_bytes},
        "iir": {"flops": iir_flops, "bytes": iir_bytes}}


def test_weights_are_made_outside_the_port():
    """The IIR's taps are scipy's design, not the port's designer, so the
    reference and the program take them from neither side."""
    cfg, _, mod = load()
    w = mod.weights(cfg, 3000000041)
    eb, ea = scipy.signal.ellip(6, 0.1, 60, 0.3)
    assert np.array_equal(w["b"], eb) and np.array_equal(w["a"], ea)
    src = (BENCH / "configs" / f"{NAME}.py").read_text()
    assert "iirdes" not in src and "design_iir" not in src


def test_counts_read_only_the_shape():
    src = (BENCH / "counts" / f"{NAME}.py").read_text()
    assert "pothoscomms" not in src and "import torch" not in src


def reader(stage):
    return harness.load_module(
        BENCH / "metrics" / f"kernel_roofline_pct.{stage}.py")


def synthetic(fir_s=1.1e-3, iir_s=2.4e-3, steps=10):
    """A trace of ``steps`` steps: K1's product and operator kernels and
    the operand's copy launched inside the FIR's core, the IIR's kernel and
    a copy inside the IIR's, each core's time a step as given."""
    ops = [["void (anonymous namespace)::cgemm_tc_kernel(CUtensorMap, "
            "CUtensorMap, CUtensorMap, float*, long, int, int)",
            0.78 * fir_s * steps],
           ["void at::native::CatArrayBatchedCopy", 0.2 * fir_s * steps],
           ["void (anonymous namespace)::tf32_operator_kernel(float const*)",
            0.02 * fir_s * steps],
           ["void (anonymous namespace)::iir_df2t_kernel<6, 2>",
            0.9 * iir_s * steps],
           ["void at::native::direct_copy_kernel", 0.1 * iir_s * steps]]
    return {"steps": steps, "kernel_s": (fir_s + iir_s) * steps,
            "device_ops": ops,
            "device_by_span": {"pc.chain.IIRFilter": iir_s * steps,
                               "pc.chain.FIRFilter": fir_s * steps,
                               "pc.kernel.iir_df2t": 0.9 * iir_s * steps,
                               "pc.kernel.cgemm": 0.8 * fir_s * steps}}


def test_stage_readers_on_a_synthetic_trace():
    w = work(256, 131072)
    m = {"work": w, "peaks": PEAKS, "trace": synthetic()}
    res_least = 671220108 / 3.35e12
    iir_least = 805331000 / 3.35e12
    assert reader("resampler").read(m) == pytest.approx(
        100 * res_least / 1.1e-3)
    assert reader("iir").read(m) == pytest.approx(100 * iir_least / 2.4e-3)
    assert 15 < reader("resampler").read(m) < 20
    assert 9 < reader("iir").read(m) < 11


def test_stage_readers_read_device_by_span():
    """Each stage divides by the device time launched inside its core's
    span, whatever the kernels' names: the operand's copy counts to the
    resampler, and renaming or dropping K1's rows changes nothing."""
    w = work(256, 131072)
    base = {"work": w, "peaks": PEAKS, "trace": synthetic()}
    renamed = synthetic()
    renamed["device_ops"] = [["some_other_kernel", s]
                             for _, s in renamed["device_ops"]]
    for stage in ("resampler", "iir"):
        read = reader(stage).read
        assert read({**base, "trace": renamed}) == read(base)
    moved = synthetic()
    moved["device_by_span"]["pc.chain.FIRFilter"] *= 2
    assert reader("resampler").read({**base, "trace": moved}) == \
        pytest.approx(reader("resampler").read(base) / 2)
    assert reader("iir").read({**base, "trace": moved}) == \
        reader("iir").read(base)
    for stage in ("resampler", "iir"):
        src = (BENCH / "metrics" / f"kernel_roofline_pct.{stage}.py"
               ).read_text()
        assert "device_by_span" in src and "K1_KERNELS" not in src


@pytest.mark.parametrize("stage", ["resampler", "iir"])
def test_stage_readers_find_nothing_to_read(stage):
    w = work(256, 131072)
    read = reader(stage).read
    no_span = synthetic()
    no_span["device_by_span"] = {}
    assert read({"work": w, "peaks": PEAKS, "trace": no_span}) is None
    no_key = synthetic()
    del no_key["device_by_span"]
    assert read({"work": w, "peaks": PEAKS, "trace": no_key}) is None
    assert read({"work": w, "peaks": PEAKS}) is None
    assert read({"work": w, "peaks": None, "trace": synthetic()}) is None
    flat = {k: v for k, v in w.items() if k != "stages"}
    assert read({"work": flat, "peaks": PEAKS, "trace": synthetic()}) is None
    cpu = {"steps": 4, "kernel_s": 0.0, "device_ops": [],
           "device_by_span": {}}
    assert read({"work": w, "peaks": PEAKS, "trace": cpu}) is None
