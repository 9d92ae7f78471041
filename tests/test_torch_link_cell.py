"""The link's receive entry (``parallel/link.make_link_receiver``) against
the plain reference of the benchmark's ``digital_link_bpsk_4000b``
(``benchmark/reference/``, float64 numpy and torch, none of the port),
on the CPU.

Tolerances: the reference TX equal to the port's ``tx_waveform`` +
``apply_channel`` for the same bits, gaps, impairments and noise draws
within float32 rounding (2 ulps of max |x|); every payload bit-exact;
every frame offset one the float64 automaton accepts, and the estimates
at the accepted peak within the configuration's limits.
"""

import gc
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pothoscomms_tpu_torch.core.topology import Topology
from pothoscomms_tpu_torch.parallel import link

ROOT = Path(__file__).resolve().parents[1]
NAME = "digital_link_bpsk_4000b"
REF_PATH = ROOT / "benchmark" / "reference" / f"{NAME}.py"

torch.set_num_threads(1)


def load_reference():
    import importlib.util

    spec = importlib.util.spec_from_file_location("_link_reference", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = load_reference()


def config(n_bits=256):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{NAME}.json")
                     .read_text())
    cfg["payload_bits"] = n_bits
    return cfg


def traffic(channels=4, window=4096, gap_max=2000):
    return {"channels": channels, "samples_per_step": window, "pool": 1,
            "gap_min": 300, "gap_max": gap_max}


def receiver(cfg, channels, window):
    return link.make_link_receiver(
        channels, window, cfg["payload_bits"], device="cpu")


# ---------------------------------------------------------------------- #
# the reference's TX against the port's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("noise", [0.0, 0.001])
def test_reference_tx_equals_port_tx_and_channel(noise):
    cfg = config(96)
    rng = np.random.default_rng(40)
    c, win = 5, 2048
    bits = rng.integers(0, 2, (c, 96)).astype(np.uint8)
    gaps = rng.integers(300, 900, c)
    att, ph, fo = REF.impairments(c)
    frames = REF.tx_frames(cfg, bits)
    awgn = np.zeros((c, win), np.complex128)
    port = []
    for ch in range(c):
        wave = link.tx_waveform(bits[ch], device="cpu")
        assert len(wave) == frames.shape[1]
        draw = np.random.default_rng(ch)
        port.append(link.apply_channel(
            wave, gap_pre=gaps[ch], gap_post=win - gaps[ch] - len(wave),
            attenuation=att[ch], phase=ph[ch], freq_offset=fo[ch],
            noise=noise, rng=draw))
        if noise > 0:
            draw = np.random.default_rng(ch)
            awgn[ch] = noise * (draw.normal(size=win)
                                + 1j * draw.normal(size=win))
    np.testing.assert_array_equal(
        frames, np.stack([link.tx_waveform(b, device="cpu") for b in bits]))
    got = REF.channel(frames, gaps, win, att, ph, fo, awgn).numpy()
    got32 = got.astype(np.complex64)
    port = np.stack(port)
    assert port.dtype == np.complex64
    ulp = np.finfo(np.float32).eps * np.abs(port).max()
    assert np.abs(got32 - port).max() <= 2 * ulp
    assert np.abs(got - port).max() <= 2 * ulp


def test_reference_header_codec_round_trip():
    """Every single flipped bit of a Hamming(8,4) word is corrected, every
    double flip detected; the header of the cell's frame reads back."""
    for nib in range(16):
        word = REF.hamming84(nib)
        assert REF.unhamming84(word) == (nib, False)
        for i in range(8):
            one = list(word)
            one[i] ^= 1
            assert REF.unhamming84(one) == (nib, False)
            for j in range(i + 1, 8):
                two = list(one)
                two[j] ^= 1
                assert REF.unhamming84(two)[1]
    h = REF.read_header(REF.header_bits(0x55, 4016))
    assert (h["id"], h["length"], h["error"]) == (0x55, 4016, False)
    assert h["chksum"] == REF.checksum8([0x55, 4016 & 0xFF, 4016 >> 8])


def test_reference_loads_without_jax_or_the_port():
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('r', {str(REF_PATH)!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'pothoscomms_tpu', 'pothoscomms_tpu_torch')]\n"
            "assert not bad, bad\n"
            "assert hasattr(m, 'check_step') and hasattr(m, 'pool')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------- #
# the receiver against the reference
# ---------------------------------------------------------------------- #
def test_receiver_against_reference_4_channels():
    """4 channels x 256-bit frames: every payload exact, every offset the
    float64 receiver's, the estimates within the limits."""
    cfg = config()
    batch = REF.pool(cfg, traffic(), 3000000019, "cpu")[0]
    receive = receiver(cfg, 4, 4096)
    got = receive(batch["x"], np.full(4, 4096))
    assert got.found.all()
    np.testing.assert_array_equal(got.bits, batch["bits"])
    ref, _, _ = REF.receive(cfg, batch["x"])
    assert ref.found.all()
    np.testing.assert_array_equal(ref.bits, batch["bits"])
    np.testing.assert_array_equal(got.offset, ref.offset)
    # each frame's offset is where its gap puts it (the automaton's frame
    # offset sits a sample before the peak, one sample either side of the
    # frame's first sample)
    assert np.all(np.abs(got.offset - batch["gaps"]) <= 2)
    checks = REF.check_step(cfg, batch["x"], got, batch["bits"])
    for k, v in checks.items():
        assert v <= cfg["limits"][k], (k, v)
    assert np.abs(got.scale - ref.scale).max() / ref.scale.min() <= 1e-5


def test_receiver_keeps_the_search_arrays_only_when_asked():
    cfg = config(64)
    batch = REF.pool(cfg, traffic(2, 2048, 900), 5, "cpu")[0]
    receive = receiver(cfg, 2, 2048)
    assert receive(batch["x"], [2048, 2048]).arrays is None
    got = receive(batch["x"], [2048, 2048], keep_arrays=True)
    scale, dfc, pho, peak = got.arrays
    assert scale.shape == (2, receive.n_pad) and peak.dtype == np.int64
    assert receive.lp == 2048


def test_receiver_reports_no_frame_on_noise():
    """A channel of noise alone and one whose frame is cut short: found
    false, bits 0; the cut frame's offset and estimates stand (its header
    decoded), the empty channel's are -1 and NaN; the counters move."""
    cfg = config(64)
    batch = REF.pool(cfg, traffic(2, 2048, 900), 9, "cpu")[0]
    x = batch["x"].clone()
    x[0] = 0.001 * torch.randn(x.shape[1:], dtype=torch.float32,
                               generator=torch.Generator().manual_seed(1))
    before = (link.frames, link.frames_found)
    receive = receiver(cfg, 2, 2048)
    cut = int(batch["gaps"][1]) + 80 + 232 + 200  # in the payload
    got = receive(x, [2048, cut])
    assert not got.found.any() and not got.bits.any()
    assert got.offset[0] == -1 and np.isnan(got.scale[0])
    assert got.offset[1] >= 0 and got.scale[1] > 0
    assert (link.frames, link.frames_found) == (before[0] + 2, before[1])


def test_receiver_counters_and_shapes():
    cfg = config(64)
    batch = REF.pool(cfg, traffic(3, 2048, 900), 11, "cpu")[0]
    receive = receiver(cfg, 3, 2048)
    names = ("search_s", "decode_s", "d2h_bytes", "frames", "frames_found")
    before = {k: getattr(link, k) for k in names}
    shifts = sum(link.align_shift.values())
    got = receive(batch["x"], [2048] * 3)
    after = {k: getattr(link, k) for k in names}
    assert after["frames"] - before["frames"] == 3
    assert after["frames_found"] - before["frames_found"] == 3
    assert after["search_s"] > before["search_s"]
    assert after["decode_s"] > before["decode_s"]
    assert after["d2h_bytes"] == before["d2h_bytes"]  # no copy on the CPU
    assert sum(link.align_shift.values()) - shifts == 3
    assert got.bits.dtype == np.uint8 and got.offset.dtype == np.int64
    assert got.scale.dtype == np.float64
    with pytest.raises(ValueError):
        receive(batch["x"][:2], [2048] * 2)
    with pytest.raises(ValueError):
        receive(batch["x"], [4096] * 3)


def test_receiver_pads_a_short_window():
    """A window shorter than the search's bucket is padded on the device,
    and decodes as the same window padded by the caller."""
    cfg = config(64)
    batch = REF.pool(cfg, traffic(2, 1800, 700), 13, "cpu")[0]
    receive = receiver(cfg, 2, 1800)
    assert receive.lp == 2048
    a = receive(batch["x"], [1800, 1800])
    padded = torch.nn.functional.pad(batch["x"], (0, 0, 0, 248))
    b = receive(padded, [1800, 1800])
    assert a.found.all()
    for k in ("bits", "offset", "scale", "dfc", "phase"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_header_rejects_are_counted():
    """A frame whose header id is not the receiver's is refused: its peak
    is accepted, the header counted as a reject, no frame found."""
    cfg = config(64)
    batch = REF.pool(cfg, traffic(1, 2048, 900), 17, "cpu")[0]
    receive = link.make_link_receiver(1, 2048, 64, header_id=0x56,
                                      device="cpu")
    before = link.header_rejects
    got = receive(batch["x"], [2048])
    assert not got.found[0] and got.offset[0] == -1
    assert link.header_rejects > before


def test_receiver_is_steady_over_many_calls():
    """Repeated calls leave no topology, tensor or thread behind."""
    import threading

    cfg = config(64)
    batch = REF.pool(cfg, traffic(2, 2048, 900), 19, "cpu")[0]
    receive = receiver(cfg, 2, 2048)

    def live():
        gc.collect()
        with warnings.catch_warnings():  # torch's deprecated aliases
            warnings.simplefilter("ignore")
            return sum(isinstance(o, Topology) for o in gc.get_objects())

    receive(batch["x"], [2048, 2048])
    base, threads = live(), threading.active_count()
    for _ in range(20):
        got = receive(batch["x"], [2048, 2048])
        assert got.found.all()
    assert live() <= base and threading.active_count() == threads


def test_run_link_goes_through_the_receiver(monkeypatch):
    """run_link builds one receiver and calls it once for its batch."""
    calls = []
    make = link.make_link_receiver

    def counting(*a, **k):
        receive = make(*a, **k)

        def wrapped(x, lengths, keep_arrays=False):
            calls.append(tuple(x.shape))
            return receive(x, lengths, keep_arrays)

        wrapped.lp, wrapped.n_pad = receive.lp, receive.n_pad
        return wrapped

    monkeypatch.setattr(link, "make_link_receiver", counting)
    res = link.run_link(3, n_bits=48, seed=5, device="cpu")
    assert res["all_exact"] and calls == [(3, res["lp"], 2)]
    assert set(res["seconds"]) == {"tx", "upload", "search", "rx_decode"}

