"""Channel-batched full digital link (BASELINE.json config #5), the port of
the JAX package's ``parallel/link.py`` on one device.

    scrambler -> symbol_mapper -> frame_insert -> [upsample] -> channel
    -> batched sync search (device, S1) -> frame automaton + header
    decode -> symbol_slicer -> descrambler

TX runs per channel through the port's blocks on the streaming runtime
(bit-level fidelity); the receive-side search — the expensive part, the
reference's hottest loop (digital/FrameSync.cpp:470-497) — runs as ONE
launch of S1 (``kernels/sync_search.py``) over all channels of the batch.
The small per-channel acceptance automaton and Hamming header decode stay
on the host (blocks/framing.py, the code the FrameSync block runs); then
SymbolSlicer and Descrambler blocks recover the payload bits. (The JAX
package shards the search over a device mesh's "ch" axis; sharding over
several cards is still to port.)

Bit-exactness note: with rectangular pulses the reference's optimal
bit-sampling search can settle one symbol late (FrameSync.cpp:709-721),
so each frame carries an 8-bit zero pilot prefix + 8-bit zero pad; the
pilot resolves the alignment and the recovered payload is then exactly
the transmitted bits.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pothoscomms_tpu_torch.blocks.framing import (
    CORR_DUR_PERCENT,
    CORR_MAG_PERCENT,
    NUM_HEADER_BITS,
    header_checksum,
    new_sync_state,
    process_header_bits,
    run_sync_automaton,
)
from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource
from pothoscomms_tpu_torch.core.labels import Label
from pothoscomms_tpu_torch.core.registry import BlockRegistry
from pothoscomms_tpu_torch.core.topology import Topology
from pothoscomms_tpu_torch.ops.framing import bucket_len, sync_search_planar
from pothoscomms_tpu_torch.parallel import cplx

PILOT_BITS = 8  # known-zero prefix/suffix resolving bit-clock alignment


def _run_topology(blocks, feed, sink, device):
    topo = Topology(device=device)
    chain = [feed] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()
    if not topo.wait_inactive(timeout=60.0):
        raise RuntimeError("topology did not quiesce")
    return sink


def tx_waveform(bits: np.ndarray, *, poly: int = 0x19, seed: int = 1,
                header_id: int = 0x55, symbol_width: int = 20,
                data_width: int = 4, preamble=(1.0,),
                device=None) -> np.ndarray:
    """One channel's TX: scrambler -> BPSK mapper -> frame_insert ->
    rectangular-pulse upsample (fir_filter interp=data_width), on a
    topology on ``device`` (the card unless the caller names one; these
    blocks stream on the host). Returns the complex64 baseband waveform
    of one frame."""
    payload = np.concatenate([
        np.zeros(PILOT_BITS, np.uint8),
        np.asarray(bits, np.uint8) & 1,
        np.zeros(PILOT_BITS, np.uint8),
    ])

    scr = BlockRegistry.make("/comms/scrambler")
    scr.set_mode("additive")
    scr.set_poly(poly)
    scr.set_seed(seed)
    mapper = BlockRegistry.make("/comms/symbol_mapper", "complex_float64")
    mapper.set_map([-1.0, 1.0])
    insert = BlockRegistry.make("/comms/frame_insert", "complex_float64")
    insert.set_preamble(np.asarray(preamble, np.complex128))
    insert.set_symbol_width(symbol_width)
    insert.set_header_id(header_id)
    insert.set_frame_start_id("txStart")
    insert.set_frame_end_id("")
    up = BlockRegistry.make("/comms/fir_filter", "complex_float64", "COMPLEX")
    up.set_interpolation(data_width)
    up.set_taps(np.ones(data_width))

    feed = FeederSource("uint8")
    feed.feed_buffer(payload, [Label("txStart", len(payload), 0, 1)])
    sink = CollectorSink("complex_float64")
    _run_topology([scr, mapper, insert, up], feed, sink, device)
    return sink.get_buffer().astype(np.complex64)


def apply_channel(wave: np.ndarray, *, gap_pre: int = 400,
                  gap_post: int = 600, attenuation: float = 0.5,
                  phase: float = 0.0, freq_offset: float = 0.0,
                  noise: float = 0.0,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Physical channel: idle gaps, attenuation, static phase, carrier
    frequency offset, AWGN."""
    sig = np.concatenate([
        np.zeros(gap_pre, np.complex64), wave,
        np.zeros(gap_post, np.complex64),
    ])
    n = len(sig)
    sig = sig * attenuation * np.exp(
        1j * (phase + freq_offset * np.arange(n)))
    if noise > 0:
        rng = rng or np.random.default_rng(0)
        sig = sig + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return sig.astype(np.complex64)


def make_channel_search(preamble, symbol_width: int, data_width: int,
                        input_threshold: float, length: int, device=None):
    """Build the channel-batched search on one device (the card unless the
    caller names one).

    Returns (search, lp, n_pad): search(x [C, lp, 2]) -> 4 tensors
    [C, n_pad] on the device, one S1 launch for the whole batch;
    lp = bucket_len of ``length`` (pad inputs with zeros)."""
    dev = placement.resolve(device)
    pre = np.asarray(preamble)
    npre = len(pre)
    w = symbol_width * data_width
    sw = w * npre
    fw = sw + NUM_HEADER_BITS * data_width
    lp = bucket_len(length, minimum=max(2 * fw, 1024))
    n_pad = lp - fw + 1
    pre_p = cplx.to_planar(np.asarray(pre, np.complex64)).to(dev)
    thr = float(input_threshold)

    def search(x):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return sync_search_planar(x, pre_p, thr, sw, w, data_width, npre,
                                  n_pad)

    return search, lp, n_pad


def rx_decode(wave: np.ndarray, arrays, n_bits: int, *, poly: int = 0x19,
              seed: int = 1, header_id: int = 0x55, symbol_width: int = 20,
              data_width: int = 4, preamble=(1.0,),
              device=None) -> Optional[np.ndarray]:
    """One channel's RX given precomputed search arrays: acceptance
    automaton + header decode (shared FrameSync code), payload symbol
    recovery with phase-ramp compensation, then SymbolSlicer ->
    Descrambler blocks (on topologies on ``device``; they stream on the
    host). Returns the recovered payload bits or None."""
    pre = np.asarray(preamble, np.complex128)
    w = symbol_width * data_width
    sw = w * len(pre)
    fw = sw + NUM_HEADER_BITS * data_width
    mag_thresh = int(sw * CORR_MAG_PERCENT)
    dur_thresh = int(sw * CORR_DUR_PERCENT)

    est = {}  # estimates captured from the automaton state at detection

    def try_decode(frame_offset, st):
        # frame_offset >= 0 guaranteed by run_sync_automaton's guard
        first_bit, fields = process_header_bits(
            wave[frame_offset:], st["delta_fc_max"], st["scale_at_max"],
            st["phase_off_max"], sw, symbol_width, data_width, fw, pre[-1])
        if fields is None or fields["error"]:
            return None
        if fields["chksum"] != header_checksum(fields["id"],
                                               fields["length"]):
            return None
        if fields["id"] != header_id or fields["length"] == 0:
            return None
        est.update(scale=st["scale_at_max"], dfc=st["delta_fc_max"],
                   pho=st["phase_off_max"])
        return first_bit, fields["length"]

    hit = run_sync_automaton(new_sync_state(), arrays, mag_thresh,
                             dur_thresh, try_decode)
    if hit is None:
        return None
    _, frame_offset, (first_bit, length) = hit
    # payload symbol recovery (TIMING-style: 1 sample per symbol at the
    # decimated bit clock, scale + phase-ramp compensated)
    rel0 = first_bit + NUM_HEADER_BITS * data_width
    rel = rel0 + np.arange(length) * data_width
    idx = frame_offset + rel
    if idx[-1] >= len(wave):
        return None
    # phase/scale correction from the automaton's accepted estimates
    # (same math as FrameSync TIMING output: y = x*scale*e^{j(ph0+dfc rel)})
    syms = wave[idx] * est["scale"] * np.exp(
        1j * (est["pho"] + est["dfc"] * rel))

    slicer = BlockRegistry.make("/comms/symbol_slicer", "complex_float64")
    slicer.set_map([-1.0, 1.0])
    feed = FeederSource("complex_float64")
    feed.feed_buffer(syms.astype(np.complex128))
    rx_bits = _run_topology([slicer], feed, CollectorSink("uint8"),
                            device).get_buffer()
    return align_payload(rx_bits, n_bits, poly=poly, seed=seed,
                         device=device)


def align_payload(rx_bits: np.ndarray, n_bits: int, *, poly: int = 0x19,
                  seed: int = 1, device=None) -> Optional[np.ndarray]:
    """Descramble sliced bits at the candidate alignments and return the
    payload where the zero pilot comes out all zeros (None if none):
    ``shift`` dummies ahead of the bits align the keystream with the TX
    payload position of each received bit."""
    for shift in (0, 1, 2):
        desc = BlockRegistry.make("/comms/descrambler")
        desc.set_mode("additive")
        desc.set_poly(poly)
        desc.set_seed(seed)
        feed = FeederSource("uint8")
        feed.feed_buffer(np.concatenate([np.zeros(shift, np.uint8),
                                         rx_bits]))
        out = _run_topology([desc], feed, CollectorSink("uint8"),
                            device).get_buffer()[shift:]
        pilot = out[: PILOT_BITS - shift]
        if pilot.size and not pilot.any():
            rec = out[PILOT_BITS - shift: PILOT_BITS - shift + n_bits]
            if len(rec) == n_bits:
                return rec
    return None


def channel_waves(n_channels: int, n_bits: int, seed: int, noise: float,
                  device=None):
    """The TX side of :func:`run_link`: each channel's bits and its wave
    after ``run_sharded_link``'s per-channel channel schedule (gaps,
    attenuation, phase, frequency offset, AWGN)."""
    rng = np.random.default_rng(seed)
    tx_bits = [rng.integers(0, 2, n_bits).astype(np.uint8)
               for _ in range(n_channels)]
    waves = []
    for c in range(n_channels):
        wave = tx_waveform(tx_bits[c], symbol_width=20, data_width=4,
                           device=device)
        waves.append(apply_channel(
            wave,
            gap_pre=300 + 40 * c,
            gap_post=500 - 40 * (c % 8),
            attenuation=0.4 + 0.05 * (c % 8),
            phase=0.3 * c,
            freq_offset=1e-4 * ((c % 5) - 2),
            noise=noise,
            rng=np.random.default_rng(seed + 100 + c),
        ))
    return tx_bits, waves


def run_link(n_channels: int, n_bits: int = 64, seed: int = 7,
             noise: float = 0.0, device=None) -> dict:
    """End-to-end link over ``n_channels`` independent channels, the
    search batched over all of them on ``device`` (the card unless the
    caller names one). Returns per-channel exactness, the padded search
    input, the search arrays and the seconds of each stage."""
    dev = placement.resolve(device)
    t0 = time.perf_counter()
    tx_bits, waves = channel_waves(n_channels, n_bits, seed, noise, dev)
    t1 = time.perf_counter()
    length = max(len(w) for w in waves)
    search, lp, n_pad = make_channel_search([1.0], 20, 4, 0.01, length,
                                            device=dev)
    x = np.zeros((n_channels, lp, 2), np.float32)
    for c, wv in enumerate(waves):
        x[c, : len(wv), 0] = wv.real
        x[c, : len(wv), 1] = wv.imag
    xd = torch.from_numpy(x).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    arrays = [a.cpu().numpy() for a in search(xd)]
    t3 = time.perf_counter()
    scale, dfc, pho, peak = arrays
    peak = peak.astype(np.int64)
    ok = []
    for c in range(n_channels):
        n_off = len(waves[c]) - (lp - n_pad)  # valid offsets for channel c
        rec = rx_decode(waves[c], (scale[c][:n_off], dfc[c][:n_off],
                                   pho[c][:n_off], peak[c][:n_off]),
                        n_bits, symbol_width=20, data_width=4, device=dev)
        ok.append(rec is not None and np.array_equal(rec, tx_bits[c]))
    t4 = time.perf_counter()
    return {
        "channels": n_channels,
        "bit_exact": ok,
        "all_exact": all(ok),
        "lp": lp,
        "n_pad": n_pad,
        "x": xd,
        "arrays": (scale, dfc, pho, peak),
        "seconds": {"tx": t1 - t0, "upload": t2 - t1, "search": t3 - t2,
                    "rx_decode": t4 - t3},
    }
