"""D1, the link's frame decode on the card (``kernels/frame_decode.py``),
and the receiver's two paths (``parallel/link.make_link_receiver``).

On a card the receiver decodes every channel with one D1 launch; on the
CPU it decodes a channel at a time on the host (``link.host_decode``),
and that host decode is D1's oracle: the card tests run both on the same
window and the same S1 arrays and want every field equal (``found``,
``bits``, ``offset``, ``scale``, ``dfc``, ``phase``; the estimates are
S1's float32 values widened on both sides, so exactly) and the counters
moved alike (``header_rejects``, ``align_shift``, ``frames_found``). The
CPU tests hold the keystream table to the ``/comms/descrambler`` block,
the host path's reject of a header past the valid samples, the CPU
path's counters, D1's refusals and the record layout.

The file imports no JAX; its card tests run on a card with

    python -m pytest tests/test_torch_frame_decode.py --noconftest -q
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pothoscomms_tpu_torch.blocks.framing import process_header_bits
from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource
from pothoscomms_tpu_torch.core.registry import BlockRegistry
from pothoscomms_tpu_torch.core.topology import Topology
from pothoscomms_tpu_torch.kernels import frame_decode as d1
from pothoscomms_tpu_torch.native import NativeLfsr
from pothoscomms_tpu_torch.parallel import link

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
NAME = "digital_link_bpsk_4000b"
FIELDS = ("found", "bits", "offset", "scale", "dfc", "phase")


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "_d1_reference", BENCH / "reference" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def planar(waves, length):
    """Complex waves zero-padded into planar float32 [C, length, 2]."""
    x = np.zeros((len(waves), length, 2), np.float32)
    for c, w in enumerate(waves):
        n = min(len(w), length)
        x[c, :n, 0], x[c, :n, 1] = w[:n].real, w[:n].imag
    return x


def frame(bits, rng, c, *, noise=0.001, gap=300, post=300, **tx):
    """One frame of ``bits`` through channel c's impairments."""
    wave = link.tx_waveform(bits, device="cpu", **tx)
    return link.apply_channel(
        wave, gap_pre=gap, gap_post=post, attenuation=0.4 + 0.05 * (c % 8),
        phase=0.3 * c, freq_offset=1e-4 * ((c % 5) - 2), noise=noise,
        rng=rng)


def ramp_frame(bits, rng):
    """A frame whose header samples fall steadily: the first-bit search
    runs to the frame head's last sample, so the header's 58 bits reach
    57 bits past it."""
    wave = link.tx_waveform(bits, device="cpu").copy()
    wave[80:80 + 232] = -(0.1 + 0.001 * np.arange(232))
    return link.apply_channel(wave, gap_pre=300, gap_post=100,
                              attenuation=0.5, noise=0.0, rng=rng)


def counters():
    return (link.header_rejects, dict(link.align_shift), link.frames_found,
            link.host_decode_channels, d1.frame_decode.launches)


def gained(after, before):
    shifts = {k: v - before[1].get(k, 0) for k, v in after[1].items()}
    return (after[0] - before[0], {k: v for k, v in shifts.items() if v},
            after[2] - before[2], after[3] - before[3], after[4] - before[4])


# ---------------------------------------------------------------------- #
# on the CPU
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("poly,seed", [(0x19, 1), (0x8E, 0x5A)])
def test_keystream_equals_the_descrambler_block_on_zeros(poly, seed):
    n = d1.KEYSTREAM_BITS
    desc = BlockRegistry.make("/comms/descrambler")
    desc.set_mode("additive")
    desc.set_poly(poly)
    desc.set_seed(seed)
    feed = FeederSource("uint8")
    feed.feed_buffer(np.zeros(n, np.uint8))
    sink = CollectorSink("uint8")
    topo = Topology(device="cpu")
    topo.connect(feed, 0, desc, 0)
    topo.connect(desc, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive(timeout=60.0)
    table = NativeLfsr(poly, seed).keystream(n)
    assert n == 4095 + 2 and table.dtype == np.uint8
    np.testing.assert_array_equal(table, sink.get_buffer())
    assert table.any() and not (table > 1).any()


def test_host_decode_refuses_a_header_past_the_valid_samples():
    """The first-bit search runs to the frame head's end, so the header's
    bits run past a channel cut 100 samples after it: the host counts a
    header reject where process_header_bits alone raises IndexError, and
    the window's other channel decodes."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 64).astype(np.uint8)
    waves = [ramp_frame(bits, rng), frame(bits, rng, 1)]
    x = planar(waves, 2048)
    cut = 300 + 312 + 100
    wave = x[0, :cut].view(np.complex64)[:, 0]
    with pytest.raises(IndexError):
        process_header_bits(wave[299:], 0.0, 2.0, 0.0, 80, 20, 4, 312, 1.0)
    receive = link.make_link_receiver(2, 2048, 64, device="cpu")
    before = counters()
    got = receive(torch.from_numpy(x), [cut, 2048])
    assert gained(counters(), before)[0] >= 1
    assert not got.found[0] and got.offset[0] == -1
    assert np.isnan(got.scale[0])
    assert got.found[1] and np.array_equal(got.bits[1], bits)


def test_cpu_tensors_decode_on_the_host():
    rng = np.random.default_rng(4)
    bits = [rng.integers(0, 2, 48).astype(np.uint8) for _ in range(3)]
    x = torch.from_numpy(planar([frame(b, rng, c, gap=200 + 100 * c)
                                 for c, b in enumerate(bits)], 2048))
    receive = link.make_link_receiver(3, 2048, 48, device="cpu")
    d2h = link.d2h_bytes
    for call in range(2):
        before = counters()
        got = receive(x, [2048] * 3)
        rejects, shifts, found, host, launches = gained(counters(), before)
        assert (host, launches, found) == (3, 0, 3)
        assert sum(shifts.values()) == 3
        assert got.found.all()
    np.testing.assert_array_equal(got.bits, np.stack(bits))
    assert link.d2h_bytes == d2h


def _operands(C=2, lp=1024, n_bits=16, sw=80, dw=4):
    n_pad = lp - (sw + 58 * dw) + 1
    arrays = [torch.zeros((C, n_pad)) for _ in range(4)]
    return dict(arrays=arrays, x=torch.zeros((C, lp, 2)),
                lengths=torch.full((C,), lp, dtype=torch.int64),
                keystream=torch.zeros(d1.KEYSTREAM_BITS, dtype=torch.uint8),
                out=torch.zeros((C, d1.record_bytes(n_bits)),
                                dtype=torch.uint8))


GEOMETRY = dict(link.frame_geometry((1.0,), 20, 4), n_bits=16, dw=4,
                header_id=0x55, last_symbol=1.0)


def test_frame_geometry():
    """The link's one statement of a frame's geometry, which the search,
    the host decode and D1 share: FrameSync's widths and thresholds."""
    assert GEOMETRY["sw"] == GEOMETRY["w"] == 80 and GEOMETRY["fw"] == 312
    assert (GEOMETRY["mag"], GEOMETRY["dur"]) == (56, 40)
    g = link.frame_geometry((1.0, -1.0, 1j), 10, 8)
    assert (g["w"], g["sw"], g["fw"]) == (80, 240, 240 + 58 * 8)
    _, lp, n_pad = link.make_channel_search((1.0,), 20, 4, 0.01, 5000,
                                            device="cpu")
    assert lp - n_pad == GEOMETRY["fw"] - 1


@pytest.mark.parametrize("case", ["float64", "other_device"])
def test_receive_refuses_x_off_its_device_or_dtype(case):
    """receive takes the window where the receiver lives, as float32: it
    moves and converts nothing."""
    receive = link.make_link_receiver(2, 2048, 64, device="cpu")
    x = torch.zeros((2, 2048, 2), dtype=torch.float64) if case == "float64" \
        else torch.zeros((2, 2048, 2), device="meta")
    with pytest.raises(ValueError, match="float32 on cpu"):
        receive(x, [2048, 2048])


def _bad(name):
    ops = _operands()
    C, n_pad = ops["arrays"][0].shape
    if name == "three_arrays":
        ops["arrays"] = ops["arrays"][:3]
    elif name == "arrays_shape":
        ops["arrays"][2] = torch.zeros((C, n_pad - 1))
    elif name == "x_planes":
        ops["x"] = torch.zeros((C, 1024, 3))
    elif name == "x_channels":
        ops["x"] = torch.zeros((C + 1, 1024, 2))
    elif name == "arrays_dtype":
        ops["arrays"][3] = ops["arrays"][3].double()
    elif name == "x_dtype":
        ops["x"] = ops["x"].half()
    elif name == "lengths_dtype":
        ops["lengths"] = ops["lengths"].int()
    elif name == "lengths_shape":
        ops["lengths"] = torch.zeros(C + 1, dtype=torch.int64)
    elif name == "keystream_short":
        ops["keystream"] = ops["keystream"][:-1]
    elif name == "keystream_dtype":
        ops["keystream"] = ops["keystream"].int()
    elif name == "out_shape":
        ops["out"] = torch.zeros((C, d1.record_bytes(32)), dtype=torch.uint8)
    elif name == "out_dtype":
        ops["out"] = ops["out"].int()
    elif name == "not_contiguous":
        ops["x"] = torch.zeros((C, 2, 1024)).transpose(1, 2)
    elif name == "cpu":
        pass
    return ops


@pytest.mark.parametrize("name", [
    "three_arrays", "arrays_shape", "x_planes", "x_channels", "arrays_dtype",
    "x_dtype", "lengths_dtype", "lengths_shape", "keystream_short",
    "keystream_dtype", "out_shape", "out_dtype", "not_contiguous", "cpu"])
def test_frame_decode_refuses(name):
    """Wrong shapes, dtypes or layouts raise before any launch; CPU
    tensors raise too: the host decode is the receiver's, not D1's."""
    ops = _bad(name)
    launches = d1.frame_decode.launches
    with pytest.raises((ValueError, TypeError)) as err:
        d1.frame_decode(ops.pop("arrays"), **ops, **GEOMETRY)
    if name == "cpu":
        assert "no kernel for device cpu" in str(err.value)
    assert d1.frame_decode.launches == launches


@pytest.mark.parametrize("n_bits", [0, 1, 16, 4000])
def test_records_unpack(n_bits):
    """read_records reads the source's layout into arrays of their own."""
    rec = d1.record_bytes(n_bits)
    assert rec % 16 == 0 and rec >= 32 + n_bits and rec < 48 + n_bits
    buf = np.zeros((2, rec), np.uint8)
    buf[0, :8] = np.array([1234], np.int64).view(np.uint8)
    buf[0, 8:20] = np.array([0.5, -1e-4, 2.5], np.float32).view(np.uint8)
    buf[0, 20:28] = np.array([3, 1], np.int32).view(np.uint8)
    buf[0, 32:32 + n_bits] = np.arange(n_bits) % 2
    buf[1, :8] = np.array([-1], np.int64).view(np.uint8)
    buf[1, 8:20] = np.full(3, np.nan, np.float32).view(np.uint8)
    buf[1, 20:28] = np.array([0, -1], np.int32).view(np.uint8)
    got = d1.read_records(buf, n_bits)
    assert got["offset"].tolist() == [1234, -1]
    assert got["offset"].dtype == np.int64 and got["scale"].dtype == np.float64
    assert got["scale"][0] == 0.5 and got["phase"][0] == 2.5
    assert got["dfc"][0] == np.float32(-1e-4)
    assert np.isnan([got["scale"][1], got["dfc"][1], got["phase"][1]]).all()
    assert got["rejects"].tolist() == [3, 0]
    assert got["shift"].tolist() == [1, -1]
    assert got["found"].tolist() == [True, False]
    assert got["bits"].shape == (2, n_bits)
    np.testing.assert_array_equal(got["bits"][0], np.arange(n_bits) % 2)
    into = np.full((2, n_bits), 7, np.uint8)  # the bits where asked
    assert d1.read_records(buf, n_bits, into)["bits"] is into
    np.testing.assert_array_equal(into, got["bits"])
    buf[:] = 0xFF  # the arrays are the caller's own
    assert got["offset"].tolist() == [1234, -1]
    np.testing.assert_array_equal(got["bits"][0], np.arange(n_bits) % 2)
    np.testing.assert_array_equal(into[0], np.arange(n_bits) % 2)


# ---------------------------------------------------------------------- #
# on the card: D1 against the host decode
# ---------------------------------------------------------------------- #
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (D1 has no CPU mode)")
    return torch.device("cuda:0")


def decode_both(receive, x, lengths, n_bits, **settings):
    """The card's frames and the host decode's on the same window and S1
    arrays, with the counters each moved."""
    before = counters()
    got = receive(x, lengths, keep_arrays=True)
    mid = counters()
    xh = torch.nn.functional.pad(
        x, (0, 0, 0, receive.lp - x.shape[1])).cpu().numpy()
    want = link.host_decode(xh, got.arrays, np.asarray(lengths, np.int64),
                            n_bits, device="cpu", **settings)
    return got, want, gained(mid, before), gained(counters(), mid)


def assert_same(got, want, card, host):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.offset.dtype == np.int64 and got.bits.dtype == np.uint8
    # header rejects and align_shift alike; frames found, one launch and no
    # channel decoded on the host for the card, each channel on the host
    assert card[:2] == host[:2], (card, host)
    assert card[2:] == (int(want.found.sum()), 0, 1)
    assert host[2:] == (0, len(got.found), 0)


def link_settings(**kw):
    out = dict(poly=0x19, seed=1, header_id=0x55, symbol_width=20,
               data_width=4, preamble=(1.0,))
    out.update(kw)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000019, 7, 2 ** 31 + 11, 123456789])
def test_d1_equals_host_decode_at_the_cell_shape(dev, seed):
    """256 channels x 32768 samples x 4000-bit frames from the benchmark's
    reference TX: every channel as the host decodes it, every payload
    the transmitted bits."""
    ref = load_reference()
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "link_ch256_b4000_pool4.json")
                         .read_text())
    batch = ref.pool(cfg, {**traffic, "pool": 1}, seed, dev)[0]
    receive = link.make_link_receiver(256, 32768, 4000, device=dev)
    got, want, card, host = decode_both(receive, batch["x"],
                                        np.full(256, 32768), 4000,
                                        **link_settings())
    assert_same(got, want, card, host)
    assert got.found.all()
    np.testing.assert_array_equal(got.bits, batch["bits"])


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
def test_d1_equals_host_decode_at_few_channels(dev, channels):
    ref = load_reference()
    cfg = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    cfg["payload_bits"] = 512
    traffic = {"channels": channels, "samples_per_step": 8192, "pool": 2,
               "gap_min": 300, "gap_max": 4000}
    receive = link.make_link_receiver(channels, 8192, 512, device=dev)
    for batch in ref.pool(cfg, traffic, 41 + channels, dev):
        got, want, card, host = decode_both(
            receive, batch["x"], np.full(channels, 8192), 512,
            **link_settings())
        assert_same(got, want, card, host)
        assert got.found.all()


@pytest.mark.cuda
def test_d1_planted_cases(dev):
    """Noise alone; a wrong header id before a good frame (a reject, then
    the walk carries on); two frames in one window; a payload and a
    header past lengths[c]; lengths below the frame head, and random;
    noise 0.01 and 0.03, where frames and headers are lost; no noise."""
    rng = np.random.default_rng(5)
    nb, L = 200, 20480
    bits = [rng.integers(0, 2, nb).astype(np.uint8) for _ in range(10)]
    waves = [0.01 * (rng.normal(size=L) + 1j * rng.normal(size=L))]
    waves.append(np.concatenate([
        frame(bits[1], rng, 1, header_id=0x56, gap=4000, post=50),
        frame(bits[1], rng, 1, gap=50, post=300)]))
    waves.append(np.concatenate([frame(bits[2], rng, 2, gap=4090, post=40),
                                 frame(bits[0], rng, 2, gap=60, post=100)]))
    waves += [frame(bits[c], rng, c, gap=500 + 1500 * c) for c in (3, 4)]
    waves.append(frame(bits[5], rng, 5, noise=0.01, gap=900))
    waves.append(frame(bits[6], rng, 6, noise=0.03, gap=12000))
    waves.append(frame(bits[7], rng, 7, gap=10))
    waves.append(ramp_frame(bits[8], rng))
    waves.append(frame(bits[9], rng, 9, noise=0.0, gap=8191))
    x = torch.from_numpy(planar(waves, L)).to(dev)
    lengths = np.full(10, L)
    lengths[3] = 500 + 4500 + 312 + 300  # inside the payload
    lengths[4] = 6500 + 312 + 20         # just past the frame head
    lengths[7] = 100                     # below a frame head
    lengths[8] = 300 + 312 + 100         # the header runs past it
    receive = link.make_link_receiver(10, L, nb, device=dev)
    got, want, card, host = decode_both(receive, x, lengths, nb,
                                        **link_settings())
    assert_same(got, want, card, host)
    assert got.found[[1, 2, 9]].all() and not got.found[[0, 3, 4, 7, 8]].any()
    assert card[0] >= 2  # channel 1's wrong id, channel 8's cut header
    for c in (1, 2, 9):
        np.testing.assert_array_equal(got.bits[c], bits[c])
    got, want, card, host = decode_both(
        receive, x[:, :L - 1000], np.random.default_rng(6).integers(
            0, L - 999, 10), nb, **link_settings())
    assert_same(got, want, card, host)
    receive = link.make_link_receiver(10, L, nb, header_id=0x57, device=dev)
    got, want, card, host = decode_both(receive, x, np.full(10, L), nb,
                                        **link_settings(header_id=0x57))
    assert_same(got, want, card, host)
    assert not got.found.any() and card[0] > 10


@pytest.mark.cuda
@pytest.mark.parametrize("tx", [
    dict(preamble=(1.0, -1.0, 1.0)), dict(data_width=2),
    dict(data_width=8), dict(preamble=(1.0, 1j), data_width=8,
                             symbol_width=10)],
    ids=["preamble3", "dw2", "dw8", "complex_preamble_dw8"])
def test_d1_equals_host_decode_at_other_settings(dev, tx):
    rng = np.random.default_rng(8)
    nb = 300
    bits = [rng.integers(0, 2, nb).astype(np.uint8) for _ in range(6)]
    waves = [frame(b, rng, c, gap=100 + 1997 * c, post=10, **tx)
             for c, b in enumerate(bits)]
    L = max(len(w) for w in waves) + 50
    receive = link.make_link_receiver(6, L, nb, device=dev, **tx)
    got, want, card, host = decode_both(
        receive, torch.from_numpy(planar(waves, L)).to(dev),
        np.full(6, L), nb, **link_settings(**tx))
    assert_same(got, want, card, host)
    assert got.found.all()
    np.testing.assert_array_equal(got.bits, np.stack(bits))


@pytest.mark.cuda
def test_d1_once_a_call_and_the_frames_stay_the_callers(dev):
    """One D1 launch a call, no channel decoded on the host, only the
    records copied back; the frames a call returns survive later calls."""
    rng = np.random.default_rng(9)
    nb, C = 256, 8
    batches, sent = [], []
    for _ in range(3):
        bits = [rng.integers(0, 2, nb).astype(np.uint8) for _ in range(C)]
        sent.append(np.stack(bits))
        batches.append(torch.from_numpy(planar(
            [frame(b, rng, c, gap=int(rng.integers(100, 3000)))
             for c, b in enumerate(bits)], 8192)).to(dev))
    receive = link.make_link_receiver(C, 8192, nb, device=dev)
    kept = []
    for x in batches:
        before, d2h = counters(), link.d2h_bytes
        got = receive(x, np.full(C, 8192))
        assert gained(counters(), before)[3:] == (0, 1)
        assert link.d2h_bytes - d2h == C * d1.record_bytes(nb)
        assert got.arrays is None
        kept.append((got, {k: getattr(got, k).copy() for k in FIELDS}))
    for (got, copy), bits in zip(kept, sent):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(got, k), copy[k])
        np.testing.assert_array_equal(got.bits, bits)
