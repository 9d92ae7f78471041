"""The port's framing layer — the header codec, /comms/preamble_framer,
/comms/frame_insert, /comms/preamble_correlator (its Hamming profile) and
/comms/frame_sync on S1's plain version — against the JAX package on the
same feeds (the cases of tests/test_framing.py), and the sync search
against a float64 numpy oracle of its formulas.

Inputs are explicit uint8 / complex64 / complex128 arrays from
numpy.random.default_rng(seed) (JAX x64 is on in the tests). Tolerances:
- integers, symbols, frames and labels' ids, indices and widths: exact;
- frame_sync's output samples and its phase label within 1e-5 absolute
  of the JAX block (the same host arithmetic on search estimates that
  differ in float32 rounding);
- the search arrays against the float64 oracle (core/testing.py
  ``search_agreement``), leaving out the offsets whose ``ok`` test lies
  within 1e-5 relative of a threshold and those whose K cancels to below
  1e-3 of its terms' magnitudes (both counted): scale within 1e-5
  relative and zero exactly where the oracle's is; delta_fc within 1e-5
  absolute (float32 products in K, amplified where K's terms cancel in
  noise); phase_off within 2e-3 rad where |L| >= 1 (delta_fc's error over
  up to sw taps); corr_peak exact except where the oracle's |L| lies
  within 1e-3 of an integer (counted);
- JAX's arrays against the same oracle at buckets of <= 4096 samples
  only: its window sums and K are differences of float32 prefix sums
  over the whole bucket (pothoscomms_tpu/ops/framing.py:50-54, 79-84),
  which already cost it precision there (the 4096 link bucket: scale off
  by 2.6e-4 relative, delta_fc by 3.1e-3 in the noisy gaps, three floors
  of |L| < 20 off by one). So JAX is held to scale within 1e-3 relative,
  delta_fc within 1e-2, and, at the automaton's candidate offsets
  (|L| >= 0.7 sw), to the port's phase bound and exact peaks.
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu.ops import framing as jframing
from pothoscomms_tpu_torch.blocks import framing as pframing
from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                sync_search_f64)
from pothoscomms_tpu_torch.kernels.sync_search import (sync_search,
                                                       sync_search_plain)
from pothoscomms_tpu_torch.ops import framing as ops
from tests.test_framing import make_tx_frame

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}
TOL = {"scale_rel": 1e-5, "delta_fc_abs": 1e-5, "phase_abs": 2e-3}
TOL_JAX = {"scale_rel": 1e-3, "delta_fc_abs": 1e-2, "phase_abs": 2e-3}


def _topo(p):
    return p.Topology(device="cpu") if p is pkg else p.Topology()


def run_chain(p, fx, blocks, feeds, dtype_in, dtype_out, copier=False):
    feed = fx.FeederSource(dtype_in)
    sink = fx.CollectorSink(dtype_out)
    topo = _topo(p)
    chain = [feed] + ([fx.Copier(seed=5)] if copier else []) + blocks \
        + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    for item in feeds:
        if isinstance(item, tuple):
            feed.feed_buffer(item[0], [p.Label(*lb) for lb in item[1]])
        else:
            feed.feed_buffer(item)
    topo.commit()
    assert topo.wait_inactive(timeout=60.0)
    return sink


def _labels(sink):
    return [(lb.id, lb.data, lb.index, lb.width) for lb in sink.get_labels()]


def assert_tolerances(agree: dict, tol=TOL, peaks=True):
    assert agree["scale_zero_mismatch"] == 0, agree
    assert not peaks or agree["peak_mismatch"] == 0, agree
    for k, bound in tol.items():
        assert agree[k] <= bound, (k, agree)


# ---------------------------------------------------------------------- #
# header codec (tests/test_framing.py:28-49)
# ---------------------------------------------------------------------- #
def test_hamming84_roundtrip_and_correction():
    from pothoscomms_tpu.blocks import framing as jf

    for x in range(16):
        bits = pframing.encode_hamming84(x)
        np.testing.assert_array_equal(bits, jf.encode_hamming84(x))
        for flip in range(8):
            b = bits.copy()
            b[flip] ^= 1
            assert pframing.decode_hamming84(b) == (x, False)


def test_header_word_roundtrip():
    from pothoscomms_tpu.blocks import framing as jf

    for hid, length in [(0x55, 100), (0xAB, 4095), (0, 1)]:
        ck = pframing.header_checksum(hid, length)
        assert ck == jf.header_checksum(hid, length)
        bits = pframing.encode_header_word(hid, length, ck)
        np.testing.assert_array_equal(bits,
                                      jf.encode_header_word(hid, length, ck))
        assert len(bits) == pframing.NUM_HEADER_BITS == 58
        assert pframing.decode_header_word(bits) == {
            "id": hid, "length": length, "chksum": ck, "error": False}


# ---------------------------------------------------------------------- #
# framer, correlator, loopback (tests/test_framing.py:55-177)
# ---------------------------------------------------------------------- #
def test_preamble_framer_splices():
    preamble = np.array([1, 1, 0, 1], np.uint8)
    data = (np.arange(20) % 2).astype(np.uint8)
    outs = []
    for p, fx in PACKAGES.values():
        framer = p.BlockRegistry.make("/comms/preamble_framer")
        framer.set_preamble(preamble)
        framer.set_frame_start_id("start")
        framer.set_frame_end_id("end")
        framer.set_padding_size(3)
        outs.append(run_chain(p, fx, [framer], [
            (data, [("start", None, 5), ("end", None, 14)])], "uint8",
            "uint8"))
    exp = np.concatenate([data[:5], preamble, data[5:15],
                          np.zeros(3, np.uint8), data[15:]])
    np.testing.assert_array_equal(outs[0].get_buffer(), exp)
    assert _labels(outs[0]) == _labels(outs[1])
    assert {lb.id: lb.index for lb in outs[0].get_labels()} == {
        "start": 5, "end": 14 + len(preamble) + 3}


def test_preamble_correlator_detects():
    preamble = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8)
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.integers(0, 2, 40).astype(np.uint8), preamble,
                           rng.integers(0, 2, 30).astype(np.uint8),
                           np.zeros(len(preamble), np.uint8)])
    outs = []
    for p, fx in PACKAGES.values():
        corr = p.BlockRegistry.make("/comms/preamble_correlator")
        corr.set_preamble(preamble)
        corr.set_threshold(0)
        outs.append(run_chain(p, fx, [corr], [data], "uint8", "uint8"))
    np.testing.assert_array_equal(outs[0].get_buffer(),
                                  data[: len(data) - len(preamble)])
    assert _labels(outs[0]) == _labels(outs[1])
    assert 40 + len(preamble) in [lb.index for lb in outs[0].get_labels()]


def test_preamble_correlator_threshold_tolerance():
    preamble = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8)
    corrupted = preamble.copy()
    corrupted[3] ^= 1  # one bit error
    data = np.concatenate([corrupted, np.zeros(len(preamble) + 4, np.uint8)])
    for threshold, expect_hit in [(0, False), (1, True)]:
        corr = pkg.BlockRegistry.make("/comms/preamble_correlator")
        corr.set_preamble(preamble)
        corr.set_threshold(threshold)
        sink = run_chain(pkg, fix, [corr], [data], "uint8", "uint8")
        hits = [lb for lb in sink.get_labels()
                if lb.id == "frameStart" and lb.index == len(preamble)]
        assert bool(hits) == expect_hit, f"threshold={threshold}"


@pytest.mark.parametrize("nbits,plen", [(8, 8), (1, 32), (8, 61)])
def test_hamming_profile_bit_exact(nbits, plen):
    """The conv1d bit-plane profile equals the JAX one and a direct XOR
    popcount, exactly."""
    rng = np.random.default_rng(plen)
    pre = rng.integers(0, 1 << nbits, plen).astype(np.uint8)
    x = rng.integers(0, 1 << nbits, 3000).astype(np.uint8)
    n = len(x) - plen + 1
    got = ops.make_hamming_profile(pre, nbits, device="cpu")(x, n)
    exp = jframing.make_hamming_profile(pre, nbits)(x, n)
    np.testing.assert_array_equal(got, exp)
    pop = np.unpackbits((x[np.arange(n)[:, None] + np.arange(plen)]
                         ^ pre)[..., None], axis=-1).sum(axis=(1, 2))
    np.testing.assert_array_equal(got, pop)


def test_framer_to_correlator_loopback():
    rng = np.random.default_rng(7)
    mtu = 107
    preamble = rng.integers(0, 2, 32).astype(np.uint8)
    payloads = [rng.integers(0, 2, mtu).astype(np.uint8) for _ in range(6)]
    got = []
    for p, fx in PACKAGES.values():
        feeder = fx.FeederSource("uint8")
        for pl in payloads:
            feeder.feed_packet(p.Packet(pl))
        feeder.feed_packet(p.Packet(np.zeros(len(preamble), np.uint8)))
        gen = p.BlockRegistry.make("/blocks/packet_to_stream")
        gen.set_frame_start_id("txFrameStart")
        gen.set_frame_end_id("txFrameEnd")
        framer = p.BlockRegistry.make("/comms/preamble_framer")
        framer.set_preamble(preamble)
        framer.set_frame_start_id("txFrameStart")
        framer.set_frame_end_id("txFrameEnd")
        framer.set_padding_size(10)
        copier = p.BlockRegistry.make("/blocks/copier", 3)
        corr = p.BlockRegistry.make("/comms/preamble_correlator")
        corr.set_preamble(preamble)
        corr.set_threshold(0)
        corr.set_frame_start_id("rxFrameStart")
        deframer = p.BlockRegistry.make("/blocks/stream_to_packet")
        deframer.set_frame_start_id("rxFrameStart")
        deframer.set_mtu(mtu)
        sink = fx.CollectorSink("uint8")
        topo = _topo(p)
        chain = [feeder, gen, framer, copier, corr, deframer, sink]
        for a, b in zip(chain[:-1], chain[1:]):
            topo.connect(a, 0, b, 0)
        topo.commit()
        assert topo.wait_inactive()
        got.append([pk.payload for pk in sink.packets])
    assert len(got[0]) >= len(payloads) and len(got[0]) == len(got[1])
    for a, b, exp in zip(got[0], got[1], payloads):
        np.testing.assert_array_equal(a, exp)
        np.testing.assert_array_equal(a, b)


def test_frame_insert_structure():
    data = np.ones(10, np.complex128) * (0.5 + 0.5j)
    outs = []
    for p, fx in PACKAGES.values():
        insert = p.BlockRegistry.make("/comms/frame_insert",
                                      "complex_float64")
        insert.set_symbol_width(4)
        insert.set_preamble([1 + 0j])
        insert.set_header_id(0x55)
        insert.set_frame_start_id("s")
        insert.set_frame_end_id("")
        outs.append(run_chain(p, fx, [insert], [(data, [("s", 7, 2, 1)])],
                              "complex_float64", "complex_float64"))
    out = outs[0].get_buffer()
    np.testing.assert_array_equal(out, outs[1].get_buffer())
    assert _labels(outs[0]) == _labels(outs[1])
    nh = pframing.NUM_HEADER_BITS
    assert len(out) == 10 + 4 + nh
    bits = pframing.encode_header_word(0x55, 7,
                                       pframing.header_checksum(0x55, 7))
    np.testing.assert_array_equal(out[6:6 + nh].real,
                                  np.where(bits != 0, 1.0, -1.0))
    np.testing.assert_array_equal(out[6 + nh:], data[2:])


# ---------------------------------------------------------------------- #
# frame sync (tests/test_framing.py:231-342)
# ---------------------------------------------------------------------- #
def _impaired_frame(seed, n_syms, header_id=0x55, n_pre=500, n_post=800):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 2, n_syms) * 2.0 - 1.0
    frame = make_tx_frame(syms, 4, 20, header_id=header_id)
    sig = np.concatenate([np.zeros(n_pre, np.complex128), frame,
                          np.zeros(n_post, np.complex128)])
    return syms, sig * 0.5 * np.exp(1j * (0.7 + 2e-4 * np.arange(len(sig))))


def _frame_sync(p, mode="RAW", header_id=0x55):
    fs = p.BlockRegistry.make("/comms/frame_sync", "complex_float64")
    fs.set_output_mode(mode)
    fs.set_preamble([1.0])
    fs.set_symbol_width(20)
    fs.set_data_width(4)
    fs.set_header_id(header_id)
    fs.set_frame_start_id("rxStart")
    fs.set_frame_end_id("rxEnd")
    fs.set_phase_offset_id("phOff")
    fs.set_input_threshold(0.01)
    return fs


def assert_same_sync_output(a, b):
    la, lb = a.get_labels(), b.get_labels()
    assert [(x.id, x.index, x.width) for x in la] == \
        [(x.id, x.index, x.width) for x in lb]
    for x, y in zip(la, lb):
        if isinstance(x.data, float):
            assert abs(x.data - y.data) <= 1e-5, (x, y)
        else:
            assert x.data == y.data
    oa, ob = a.get_buffer(), b.get_buffer()
    assert oa.shape == ob.shape
    np.testing.assert_allclose(oa, ob, rtol=0, atol=1e-5)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("mode", ["RAW", "PHASE", "TIMING", "DEBUG"])
def test_frame_sync_finds_frame(mode, split):
    """All four output modes, with and without randomized buffer-boundary
    splitting through a Copier; the port's block against the JAX block."""
    syms, sig = _impaired_frame(21, 40)
    sinks = [run_chain(p, fx, [_frame_sync(p, mode)], [sig],
                       "complex_float64", "complex_float64", copier=split)
             for p, fx in PACKAGES.values()]
    assert_same_sync_output(*sinks)
    labels = {lb.id: lb for lb in sinks[0].get_labels()}
    label_width = 1 if mode == "TIMING" else 4
    assert labels["rxStart"].data == len(syms)
    assert labels["rxStart"].width == label_width
    assert (labels["rxEnd"].index - labels["rxStart"].index
            == (len(syms) - 1) * label_width)
    seg = sinks[0].get_buffer()[labels["rxStart"].index:]
    samples = seg[np.arange(len(syms) - 1) * label_width]

    def decodes(shift):
        # one symbol late is the reference's rectangular-pulse alignment
        # (tests/test_framing.py:292-313)
        exp = syms[shift: shift + len(samples)]
        s = samples
        if mode == "RAW":
            s = s * np.exp(-1j * np.angle((s * np.conj(exp)).sum()))
        return np.array_equal(np.sign(s.real), exp)

    assert decodes(0) or decodes(1)


def test_frame_sync_rejects_wrong_id():
    _, sig = _impaired_frame(22, 30, header_id=0x12, n_pre=300, n_post=600)
    sink = run_chain(pkg, fix, [_frame_sync(pkg)], [sig], "complex_float64",
                     "complex_float64")
    assert not [lb for lb in sink.get_labels() if lb.id == "rxStart"]


def test_frame_sync_state_carried_from_jax_mid_stream():
    """A JAX FrameSync's automaton dict, taken while a correlation peak is
    pending and carried into the port's block with
    ``sync_state_from_numpy``, makes the two blocks go on producing equal
    output on the rest of the stream."""
    _, sig = _impaired_frame(23, 40)
    fw = 80 + pframing.NUM_HEADER_BITS * 4
    # the JAX block searches offsets 0 .. 497 before the cut: 496 and 497
    # are peaks above the automaton's threshold, the frame's own at 500
    cut = 498 + fw - 1
    jfs = _frame_sync(jpkg)
    jfeed, jsink = jfix.FeederSource("complex_float64"), \
        jfix.CollectorSink("complex_float64")
    jtopo = jpkg.Topology()
    jtopo.connect(jfeed, 0, jfs, 0)
    jtopo.connect(jfs, 0, jsink, 0)
    jfeed.feed_buffer(sig[:cut])
    jtopo.commit()
    assert jtopo.wait_inactive()
    state = dict(jfs._auto)
    assert state["max_corr_peak"] > 56 and not jsink.get_labels()
    rest = np.concatenate([np.asarray(jfs.input(0).buffer()), sig[cut:]])
    jfeed.feed_buffer(sig[cut:])
    assert jtopo.wait_inactive()

    pfs = _frame_sync(pkg)
    pfeed, psink = fix.FeederSource("complex_float64"), \
        fix.CollectorSink("complex_float64")
    ptopo = pkg.Topology(device="cpu")
    ptopo.connect(pfeed, 0, pfs, 0)
    ptopo.connect(pfs, 0, psink, 0)
    ptopo.commit()  # activate() resets the automaton: carry it after
    pfs._auto = pframing.sync_state_from_numpy(state)
    pfeed.feed_buffer(rest)
    assert ptopo.wait_inactive()
    assert [lb.id for lb in psink.get_labels()] == ["phOff", "rxStart",
                                                    "rxEnd"]
    assert_same_sync_output(psink, jsink)


def test_sync_automaton_event_driven_matches_scalar():
    """The port's event-driven acceptance walk equals the reference-shaped
    per-offset loop (and so the JAX package's) on random arrays, carried
    state and decode outcomes (tests/test_framing.py:491-545)."""
    import copy

    rng = np.random.default_rng(42)
    for trial in range(200):
        n = int(rng.integers(1, 400))
        mag, dur = int(rng.integers(1, 30)), int(rng.integers(1, 12))
        cp = rng.integers(0, mag, n)
        spikes = rng.integers(0, n, max(1, n // 20))
        cp[spikes] = rng.integers(0, 3 * mag, len(spikes))
        arrays = (rng.normal(size=n), rng.normal(size=n),
                  rng.normal(size=n), cp)
        s1, s2 = pframing.new_sync_state(), pframing.new_sync_state()
        if trial % 3 == 0:
            s1["max_corr_peak"] = s2["max_corr_peak"] = int(
                rng.integers(0, 2 * mag))
            s1["count_since_max"] = s2["count_since_max"] = int(
                rng.integers(0, 2 * dur))
        mode = trial % 4

        def mk(calls):
            def try_decode(fo, state):
                calls.append((fo, copy.deepcopy(state)))
                if mode == 0:
                    return None
                if mode == 1 or len(calls) % (mode + 1) == 0:
                    return ("hit", fo)
                return None
            return try_decode

        c1, c2 = [], []
        r1 = pframing.run_sync_automaton_scalar(s1, arrays, mag, dur, mk(c1))
        r2 = pframing.run_sync_automaton(s2, arrays, mag, dur, mk(c2))
        assert (r1, c1, s1) == (r2, c2, s2), trial


# ---------------------------------------------------------------------- #
# the sync search: S1's plain version, JAX and the float64 oracle
# ---------------------------------------------------------------------- #
def _planar(x):
    return np.stack([x.real, x.imag], -1).astype(np.float32)


def _link_bucket(C, L, noise, seed=7):
    from pothoscomms_tpu_torch.parallel.link import channel_waves

    _, waves = channel_waves(C, (L - 1200 - 40 * C) // 4 - 16, seed, noise,
                             device="cpu")
    x = np.zeros((C, L, 2), np.float32)
    for c, wv in enumerate(waves):
        x[c, :len(wv)] = _planar(wv)
    return x


def _search_cases():
    rng = np.random.default_rng(77)
    xr = (rng.normal(size=(3, 2048)) + 1j * rng.normal(size=(3, 2048)))
    pre2 = np.exp(1j * rng.uniform(0, 2 * np.pi, 2))
    return {
        # random samples, a two-symbol random-phase preamble (the tiled
        # test's case, tests/test_framing.py:443-488)
        "random": (_planar(xr), pre2, 0.1, 40, 4),
        # link channels with noise at a 4096 bucket
        "link4096": (_link_bucket(4, 4096, 0.01), np.array([1.0]), 0.01,
                     80, 4),
    }


@pytest.mark.parametrize("case", ["random", "link4096"])
def test_sync_search_plain_and_jax_against_oracle(case):
    """At buckets of <= 4096 samples both the port's plain search and the
    JAX program stay within the stated bounds of the float64 oracle, and
    their floored peaks agree wherever the oracle's are clear of an
    integer."""
    import jax.numpy as jnp

    x, pre, thr, w, dw = _search_cases()[case]
    npre = len(pre)
    sw = w * npre
    n = x.shape[1] - sw - 58 * dw + 1
    pre_p = _planar(np.asarray(pre, np.complex128))
    got = [a.numpy() for a in sync_search_plain(
        torch.from_numpy(x), torch.from_numpy(pre_p), thr, sw, w, dw, npre,
        n)]
    jax_out = [np.stack([np.asarray(a) for a in jframing.sync_search_planar(
        jnp.asarray(x[c]), jnp.asarray(pre_p), thr, sw, w, dw, npre, n)])
        for c in range(x.shape[0])]
    jgot = [np.stack([o[k] for o in jax_out]) for k in range(4)]
    ref = sync_search_f64(x, pre, thr, sw, w, dw, npre, n)
    assert_tolerances(search_agreement(got, ref))
    assert_tolerances(search_agreement(jgot, ref, peak_floor=0.7 * sw),
                      TOL_JAX, peaks=False)
    live = (ref["scale"] != 0) & ~ref["borderline"] \
        & ~ref["ill_conditioned"]
    near = np.abs(ref["abs_L"] - np.round(ref["abs_L"])) < 1e-3
    cand = live & ~near & (ref["abs_L"] >= 0.7 * sw)
    assert live.sum() > 100  # the test exercises accepted offsets
    assert cand.any() == (case == "link4096")  # and frames where there are
    np.testing.assert_array_equal(jgot[3][cand], ref["corr_peak"][cand])
    np.testing.assert_array_equal(got[3][cand], jgot[3][cand])


def test_sync_search_at_32768_against_oracle():
    """The link's bucket: 3 channels at lp = 32768, the plain version held
    to the oracle (the JAX program's float32 prefix sums no longer
    resolve its windows here)."""
    x = _link_bucket(3, 32768, 0.01, seed=9)
    n = 32768 - 312 + 1
    got = [a.numpy() for a in sync_search_plain(
        torch.from_numpy(x), torch.tensor([[1.0, 0.0]]), 0.01, 80, 80, 4, 1,
        n)]
    ref = sync_search_f64(x, [1.0], 0.01, 80, 80, 4, 1, n)
    agree = search_agreement(got, ref)
    assert_tolerances(agree)
    assert (ref["corr_peak"] > 56).any()  # frames are in the bucket


def test_sync_search_plain_tiles_equal_one_tile(monkeypatch):
    """Tiling the correlation over channels and offsets changes nothing:
    each offset's sum is the same arithmetic (tiles of 1000 window samples
    cross channel and offset boundaries and leave a ragged tile)."""
    import pothoscomms_tpu_torch.kernels.sync_search as ss

    x = torch.from_numpy(_link_bucket(3, 2048, 0.02, seed=3))
    pre = torch.tensor([[1.0, 0.0]])
    args = (0.01, 80, 80, 4, 1, 2048 - 312 + 1)
    one = sync_search_plain(x, pre, *args)
    monkeypatch.setattr(ss, "TILE_ELEMENTS", 1000 * 80)
    tiled = sync_search_plain(x, pre, *args)
    for a, b in zip(one, tiled):
        assert torch.equal(a, b)


def test_sync_search_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_link_bucket(2, 2048, 0.0))
    pre = torch.tensor([[1.0, 0.0]])
    args = (0.01, 80, 80, 4, 1, 2048 - 312 + 1)
    before = sync_search.launches
    for a, b in zip(sync_search(x, pre, *args),
                    sync_search_plain(x, pre, *args)):
        assert torch.equal(a, b)
    assert sync_search.launches == before  # no launch on the CPU
    with pytest.raises(ValueError):
        sync_search(x[:, :400], pre, *args)  # too short for n offsets
    with pytest.raises(TypeError):
        sync_search(x.double(), pre, *args)
