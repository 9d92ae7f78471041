"""The link receiver's files (``digital_link_bpsk_4000b``, cell
``link_rx_ch256``): the cell run on the CPU from a tiny copy and judged
correct, three faults planted under the timed path each caught, the
bfloat16 control against the limits it has to fail, the work count
against numbers worked out by hand, and the three readers on synthetic
measurements."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_helpers import make_tiny_root, run_cell
from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME, CELL = "digital_link_bpsk_4000b", "link_rx_ch256"
TRAFFIC = "link_ch256_b4000_pool4"
PEAKS = json.loads((BENCH / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]
# the tiny copy: 3 channels of 512-bit frames in 4096-sample windows
TINY = {"channels": 3, "samples_per_step": 4096, "gap_min": 300,
        "gap_max": 1500, "warmup_s": 0.05, "warmup_steps": 1,
        "profile_steps": 1}


def load():
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    return cfg, harness.load_module(BENCH / "reference" / f"{NAME}.py")


@pytest.fixture
def link_root(tmp_path):
    """A tiny copy of the benchmark with the link cell cut to :data:`TINY`
    and 512-bit frames."""
    root = make_tiny_root(tmp_path)
    p = root / "benchmark" / "traffic" / f"{TRAFFIC}.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **TINY}))
    p = root / "benchmark" / "configs" / f"{NAME}.json"
    p.write_text(json.dumps({**json.loads(p.read_text()),
                             "payload_bits": 512}))
    return root


def tiny_cfg():
    cfg, ref = load()
    return {**cfg, "payload_bits": 512}, ref


# ---------------------------------------------------------------------- #
# the cell
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(link_root, capsys, trace):
    rc, res, err = run_cell(link_root, CELL, capsys, trace=trace)
    assert rc == 0, err
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] % 3 == 0
    assert res["attempted"] >= 3
    assert set(res["checks"]) == {"bit_errors", "frames_lost", "offset_err",
                                  "scale_rel", "dfc_abs", "phase_abs"}
    names = set(res["metrics"])
    if trace:
        assert {"link.decode_pct", "link.d2h_mb"} <= names
        assert res["metrics"]["link.d2h_mb"]["value"] == 0.0  # no card
    else:
        assert {"throughput.host_paced", "step_p95.host_paced",
                "setup_s"} == names


def flip_bit(got):
    got.bits[0, 7] ^= 1


def shift_offset(got):
    got.offset[:] += 1


def bend_scale(got):
    got.scale[:] *= 1 + 1e-3


FAULTS = {"flipped_bit": flip_bit, "offset_off_by_one": shift_offset,
          "scale_off": bend_scale}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_under_the_timed_path_is_caught(link_root, capsys, monkeypatch,
                                              fault):
    c = harness.Cell(json.loads((link_root / "BENCHMARK.json").read_text()),
                     CELL, link_root)
    entry = c.config_module.step_entry

    def broken_entry(*a, **k):
        receive = entry(*a, **k)

        def broken(x, lengths):
            got = receive(x, lengths)
            FAULTS[fault](got)
            return got

        return broken

    monkeypatch.setattr(c.config_module, "step_entry", broken_entry)
    rc, res, err = run_cell(link_root, CELL, capsys)
    assert rc == 0, err
    assert res["correct"] is False
    if fault == "flipped_bit":
        assert res["failed"] > 0 and res["checks"]["bit_errors"]["value"] > 0
    elif fault == "offset_off_by_one":
        assert res["checks"]["offset_err"]["value"] == 1.0
    else:
        assert res["checks"]["scale_rel"]["value"] > 5e-4


@pytest.mark.parametrize("layout", ["as_sent", "int64", "fortran"])
def test_payload_errors_by_hand(layout):
    """Frames lost, bit errors of the found frames and frames that fail,
    against the transmitted bits: a lost frame counts once, whatever its
    bits. Payloads laid out otherwise than the transmitted bits (another
    type, another order) are compared value by value."""
    driver = harness.load_module(BENCH / "drivers" / "link_rx.py")
    bits = np.zeros((4, 16), np.uint8)
    got = bits.copy()
    as_laid = {"as_sent": lambda g: g,
               "int64": lambda g: g.astype(np.int64),
               "fortran": np.asfortranarray}[layout]
    found = np.array([1, 1, 0, 1], bool)

    def errors():
        frames = SimpleNamespace(found=found, bits=as_laid(got))
        return driver.payload_errors(frames, bits)

    assert errors() == (1, 0, 1)
    got[1, [3, 9]] = 1
    got[2, 0] = 1   # the lost frame's bits
    assert errors() == (1, 2, 2)
    got[3, 15] = 1
    assert errors() == (1, 3, 3)


def test_window_keeps_only_the_frames_it_checks(link_root):
    """Each step's payloads are judged as it returns; the frames of the
    steps the reservoir takes and of the last step are all that stay."""
    cell = harness.Cell(json.loads((link_root / "BENCHMARK.json")
                                   .read_text()), CELL, link_root)
    ctx = harness.Context(cell, 3000000061, torch.device("cpu"), 0.0)
    st = cell.driver.setup(ctx)
    meas = cell.driver.measure(st, 0.5, False)
    k = int(ctx.traffic["check_steps"])
    assert meas["steps"] > k + 1
    assert len(st.kept) <= k + 1 and st.i - 1 in st.kept
    assert st.attempted == meas["steps"] * st.channels
    assert st.payload == {"bit_errors": 0, "frames_lost": 0, "failed": 0}
    checks, attempted, failed = cell.driver.check(st)
    assert attempted == st.attempted and failed == 0
    assert all(v <= lim for v, lim in checks.values())


# ---------------------------------------------------------------------- #
# the reference and the control
# ---------------------------------------------------------------------- #
def test_reference_receiver_recovers_the_pool():
    cfg, ref = tiny_cfg()
    traffic = {**json.loads((BENCH / "traffic" / f"{TRAFFIC}.json")
                            .read_text()), **TINY, "pool": 2}
    for batch in ref.pool(cfg, traffic, 3000000041, torch.device("cpu")):
        assert batch["x"].shape == (3, 4096, 2)
        assert batch["x"].dtype == torch.float32
        got, arr, _ = ref.receive(cfg, batch["x"])
        assert got.found.all()
        np.testing.assert_array_equal(got.bits, batch["bits"])
        assert np.all(np.abs(got.offset - batch["gaps"]) <= 2)
        checks = ref.check_step(cfg, batch["x"], got, batch["bits"])
        assert all(v == 0 for v in checks.values()), checks


def test_pool_is_the_seeds():
    cfg, ref = tiny_cfg()
    traffic = {**TINY, "pool": 2}
    a = ref.pool(cfg, traffic, 77, torch.device("cpu"))
    b = ref.pool(cfg, traffic, 77, torch.device("cpu"))
    c = ref.pool(cfg, traffic, 78, torch.device("cpu"))
    assert torch.equal(a[1]["x"], b[1]["x"])
    assert not np.array_equal(a[0]["bits"], a[1]["bits"])
    assert not np.array_equal(a[0]["bits"], c[0]["bits"])
    assert all(300 <= g <= 1500 for g in a[0]["gaps"])


def test_control_fails_a_limit():
    """The receiver with its search in bfloat16 fails ``scale_rel`` and
    ``phase_abs`` by far: its frames are still found and exact."""
    cfg, ref = tiny_cfg()
    batch = ref.pool(cfg, {**TINY, "pool": 1}, 3000000053,
                     torch.device("cpu"))[0]
    got = ref.control_output(cfg, batch["x"])
    vals = ref.check_step(cfg, batch["x"], got, batch["bits"])
    lim = cfg["limits"]
    assert vals["scale_rel"] > 100 * lim["scale_rel"]
    assert vals["phase_abs"] > 3 * lim["phase_abs"]


def test_accepted_offsets_take_near_integer_floors_both_ways():
    """A peak whose |L| lies within 1e-3 of an integer is floored either
    way: the set holds the float64 offset and, where the floor decides,
    its neighbour."""
    cfg, ref = tiny_cfg()
    batch = ref.pool(cfg, {**TINY, "pool": 1}, 5, torch.device("cpu"))[0]
    got, arr, waves = ref.receive(cfg, batch["x"])
    for ch in range(3):
        assert ref.accepted_offsets(cfg, arr, waves[ch], ch) == {
            got.offset[ch]}
    # put the peak's |L| a hair below its integer and the one before it
    # a hair above its own: the floors then decide between two offsets
    ch, p = 0, int(got.offset[0]) + 1
    arr2 = {k: v.copy() for k, v in arr.items()}
    top = np.floor(arr["abs_L"][ch][p]) + 1
    arr2["abs_L"][ch][p] = top - 2e-4
    arr2["abs_L"][ch][p - 1] = top - 1 + 2e-4
    arr2["corr_peak"][ch][p] = top - 1
    arr2["corr_peak"][ch][p - 1] = top - 1
    ok = ref.accepted_offsets(cfg, arr2, waves[ch], ch)
    assert ok == {got.offset[ch], got.offset[ch] - 1}


# ---------------------------------------------------------------------- #
# the work count and the readers
# ---------------------------------------------------------------------- #
def work(channels, samples, n_bits=4000):
    counts = harness.load_module(BENCH / "counts" / f"{NAME}.py")
    cfg, _ = load()
    return counts.work({**cfg, "payload_bits": n_bits},
                       {"channels": channels, "samples": samples})


@pytest.mark.parametrize("c,t,n_bits,flops,nbytes", [
    # 806 operations at each of t - 312 + 1 offsets; the window's 8 bytes
    # a sample read once, one byte a payload bit written
    (256, 32768, 4000, 256 * 32457 * 806, 256 * 32768 * 8 + 256 * 4000),
    (3, 4096, 512, 3 * 3785 * 806, 3 * 4096 * 8 + 3 * 512)])
def test_counts_by_hand(c, t, n_bits, flops, nbytes):
    got = work(c, t, n_bits)
    assert (got["flops"], got["bytes"]) == (flops, nbytes)
    assert got["stages"] == {"sync_search": {"flops": flops,
                                             "bytes": nbytes}}


def test_counts_at_the_cell_size():
    got = work(256, 32768)
    assert got["flops"] == 6697047552  # 6.70 GFLOP
    assert got["bytes"] == 68132864    # 20.3 us at 3.35 TB/s


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def test_link_readers_on_synthetic_counters():
    m = {"steps": 20, "window_s": 10.0,
         "counters": {"decode_s": 7.5, "d2h_bytes": 20 * 200e6,
                      "window_s": 10.0}}
    assert reader("link.decode_pct").read(m) == pytest.approx(75.0)
    assert reader("link.d2h_mb").read(m) == pytest.approx(200.0)


def test_link_readers_find_nothing_to_read():
    """The parent's program has no link counters: the readers return
    None and raise nothing."""
    for name in ("link.decode_pct", "link.d2h_mb"):
        read = reader(name).read
        assert read({"steps": 20, "window_s": 10.0}) is None
        assert read({"steps": 20, "counters": {"window_s": 10.0}}) is None


def synthetic(s1_s=0.43e-3, copy_s=40e-3, steps=2):
    return {"steps": steps, "kernel_s": (s1_s + copy_s) * steps,
            "device_ops": [["Memcpy DtoH (Device -> Pageable)",
                            copy_s * steps],
                           ["void sync_search_kernel<2>(float2 const*, "
                            "float2 const*, float*, long long, long long, "
                            "int, int, int, int, float)", s1_s * steps]]}


def test_sync_search_roofline_reader():
    w = work(256, 32768)
    read = reader("kernel_roofline_pct.sync_search").read
    got = read({"work": w, "peaks": PEAKS, "trace": synthetic()})
    assert got == pytest.approx(100 * 68132864 / 3.35e12 / 0.43e-3)
    assert 4.5 < got < 5.0
    # the whole step's share takes the copies too
    whole = reader("kernel_roofline_pct").read(
        {"work": w, "peaks": PEAKS, "trace": synthetic()})
    assert whole < 0.1 * got
    no_s1 = synthetic()
    no_s1["device_ops"] = no_s1["device_ops"][:1]
    assert read({"work": w, "peaks": PEAKS, "trace": no_s1}) is None
    assert read({"work": w, "peaks": PEAKS}) is None
    flat = {k: v for k, v in w.items() if k != "stages"}
    assert read({"work": flat, "peaks": PEAKS, "trace": synthetic()}) is None


def test_counts_read_only_the_shape():
    src = (BENCH / "counts" / f"{NAME}.py").read_text()
    assert "pothoscomms" not in src and "import torch" not in src
