"""Channel-batched full digital link (BASELINE.json config #5), the port of
the JAX package's ``parallel/link.py`` on one device.

    scrambler -> symbol_mapper -> frame_insert -> [upsample] -> channel
    -> batched sync search (device, S1) -> frame automaton + header
    decode -> symbol_slicer -> descrambler

TX runs per channel through the port's blocks on the streaming runtime
(bit-level fidelity); the receive-side search — the expensive part, the
reference's hottest loop (digital/FrameSync.cpp:470-497) — runs as ONE
launch of S1 (``kernels/sync_search.py``) over all channels of the batch.
:func:`make_link_receiver` builds that receive side once, for a receiver
that calls it step after step on window batches already on the device;
:func:`run_link` and :func:`run_sharded_link` go through it.
:func:`run_sharded_link` splits the channels over the ranks of a
``parallel/mesh.Mesh``, as the JAX package shards its search over a
device mesh's "ch" axis.

The decode after the search takes one of two paths, by the receiver's
device:

* on a card, ONE launch of D1 (``kernels/frame_decode.py``) decodes every
  channel where S1's arrays and the window lie: the acceptance automaton,
  the header, the slicer and the descrambler (an XOR with the
  descrambler's keystream, made once); one copy brings the frames back;
* on the CPU, a channel at a time :func:`decode_frame`: the automaton and
  the Hamming header decode on the host (blocks/framing.py, the code the
  FrameSync block runs), then SymbolSlicer and Descrambler blocks. It is
  D1's oracle in the tests.

The receive path's spans (``parallel/profiling.annotate``):
``pc.link.receive`` around a call, and inside it ``pc.link.search`` (S1;
on a card also D1, span ``pc.kernel.frame_decode``, and the copy of the
frames; on the CPU the arrays and the window), then on the CPU a channel
at a time ``pc.link.decode`` (the automaton and the header),
``pc.link.slice`` and ``pc.link.descramble``. Its counters are the
module's globals below, on the host clock and never gated on the
profiler: ``search_s``, ``decode_s``, ``d2h_bytes``, ``frames``,
``frames_found``, ``header_rejects``, ``align_shift`` (by shift) and
``host_decode_channels``; D1 counts its launches in
``frame_decode.launches``, one a call on a card.

Bit-exactness note: with rectangular pulses the reference's optimal
bit-sampling search can settle one symbol late (FrameSync.cpp:709-721),
so each frame carries an 8-bit zero pilot prefix + 8-bit zero pad; the
pilot resolves the alignment and the recovered payload is then exactly
the transmitted bits.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
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
from pothoscomms_tpu_torch.kernels import frame_decode as d1
from pothoscomms_tpu_torch.native import NativeLfsr
from pothoscomms_tpu_torch.ops.framing import bucket_len, sync_search_planar
from pothoscomms_tpu_torch.parallel import cplx
from pothoscomms_tpu_torch.parallel.profiling import annotate

PILOT_BITS = 8  # known-zero prefix/suffix resolving bit-clock alignment

# the receive path's counters (host clock, whatever the profiler does)
search_s = 0.0    # seconds from the call until the decode's input is on
                  # the host: S1 and the copies (on a card S1, D1 and the
                  # copy of the frames)
decode_s = 0.0    # seconds from then to the frames
d2h_bytes = 0     # bytes the receiver copied from the device to the host
frames = 0        # frames looked for: one a channel a call
frames_found = 0  # of them, those whose payload was recovered
header_rejects = 0  # accepted peaks whose header the decode refused
align_shift = collections.Counter()  # recovered payloads by pilot shift
host_decode_channels = 0  # channels decoded on the host (decode_frame)


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


def frame_geometry(preamble, symbol_width: int, data_width: int) -> dict:
    """A frame's geometry in samples, as FrameSync works it out: ``w`` a
    preamble symbol, ``sw`` the sync word (the preamble), ``fw`` the
    frame's head (the sync word and the header's bits), and the
    acceptance automaton's thresholds ``mag`` and ``dur``."""
    w = symbol_width * data_width
    sw = w * len(preamble)
    return {"sw": sw, "w": w, "fw": sw + NUM_HEADER_BITS * data_width,
            "mag": int(sw * CORR_MAG_PERCENT),
            "dur": int(sw * CORR_DUR_PERCENT)}


def make_channel_search(preamble, symbol_width: int, data_width: int,
                        input_threshold: float, length: int, device=None):
    """Build the channel-batched search on one device (the card unless the
    caller names one).

    Returns (search, lp, n_pad): search(x [C, lp, 2]) -> 4 tensors
    [C, n_pad] on the device, one S1 launch for the whole batch;
    lp = bucket_len of ``length`` (pad inputs with zeros)."""
    dev = placement.resolve(device)
    pre = np.asarray(preamble)
    g = frame_geometry(pre, symbol_width, data_width)
    lp = bucket_len(length, minimum=max(2 * g["fw"], 1024))
    n_pad = lp - g["fw"] + 1
    pre_p = cplx.to_planar(np.asarray(pre, np.complex64)).to(dev)
    thr = float(input_threshold)

    def search(x):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return sync_search_planar(x, pre_p, thr, g["sw"], g["w"],
                                  data_width, len(pre), n_pad)

    return search, lp, n_pad


def decode_frame(wave: np.ndarray, arrays, n_bits: int, *,
                 poly: int = 0x19, seed: int = 1, header_id: int = 0x55,
                 symbol_width: int = 20, data_width: int = 4,
                 preamble=(1.0,), device=None):
    """One channel's RX given precomputed search arrays: acceptance
    automaton + header decode (shared FrameSync code), payload symbol
    recovery with phase-ramp compensation, then SymbolSlicer ->
    Descrambler blocks (on topologies on ``device``; they stream on the
    host).

    Returns (frame_offset, estimates, bits): the offset of the frame the
    automaton accepted and the estimates it accepted there (``scale``,
    ``dfc``, ``pho``), both None when no header decoded; the recovered
    payload bits, or None."""
    pre = np.asarray(preamble, np.complex128)
    g = frame_geometry(pre, symbol_width, data_width)

    est = {}  # estimates captured from the automaton state at detection

    def try_decode(frame_offset, st):
        global header_rejects
        # frame_offset >= 0 guaranteed by run_sync_automaton's guard
        try:
            first_bit, fields = process_header_bits(
                wave[frame_offset:], st["delta_fc_max"], st["scale_at_max"],
                st["phase_off_max"], g["sw"], symbol_width, data_width,
                g["fw"], pre[-1])
        except IndexError:  # the header's bits run past the valid samples
            fields = None
        if (fields is None or fields["error"]
                or fields["chksum"] != header_checksum(fields["id"],
                                                       fields["length"])
                or fields["id"] != header_id or fields["length"] == 0):
            header_rejects += 1
            return None
        est.update(scale=st["scale_at_max"], dfc=st["delta_fc_max"],
                   pho=st["phase_off_max"])
        return first_bit, fields["length"]

    with annotate("pc.link.decode"):
        hit = run_sync_automaton(new_sync_state(), arrays, g["mag"],
                                 g["dur"], try_decode)
    if hit is None:
        return None, None, None
    _, frame_offset, (first_bit, length) = hit
    # payload symbol recovery (TIMING-style: 1 sample per symbol at the
    # decimated bit clock, scale + phase-ramp compensated)
    rel0 = first_bit + NUM_HEADER_BITS * data_width
    rel = rel0 + np.arange(length) * data_width
    idx = frame_offset + rel
    if idx[-1] >= len(wave):
        return frame_offset, est, None
    # phase/scale correction from the automaton's accepted estimates
    # (same math as FrameSync TIMING output: y = x*scale*e^{j(ph0+dfc rel)})
    syms = wave[idx] * est["scale"] * np.exp(
        1j * (est["pho"] + est["dfc"] * rel))

    with annotate("pc.link.slice"):
        slicer = BlockRegistry.make("/comms/symbol_slicer", "complex_float64")
        slicer.set_map([-1.0, 1.0])
        feed = FeederSource("complex_float64")
        feed.feed_buffer(syms.astype(np.complex128))
        rx_bits = _run_topology([slicer], feed, CollectorSink("uint8"),
                                device).get_buffer()
    with annotate("pc.link.descramble"):
        bits = align_payload(rx_bits, n_bits, poly=poly, seed=seed,
                             device=device)
    return frame_offset, est, bits


def rx_decode(wave: np.ndarray, arrays, n_bits: int, *, poly: int = 0x19,
              seed: int = 1, header_id: int = 0x55, symbol_width: int = 20,
              data_width: int = 4, preamble=(1.0,),
              device=None) -> Optional[np.ndarray]:
    """One channel's recovered payload bits (:func:`decode_frame`), or
    None."""
    return decode_frame(wave, arrays, n_bits, poly=poly, seed=seed,
                        header_id=header_id, symbol_width=symbol_width,
                        data_width=data_width, preamble=preamble,
                        device=device)[2]


def align_payload(rx_bits: np.ndarray, n_bits: int, *, poly: int = 0x19,
                  seed: int = 1, device=None) -> Optional[np.ndarray]:
    """Descramble sliced bits at the candidate alignments and return the
    payload where the zero pilot comes out all zeros (None if none):
    ``shift`` dummies ahead of the bits align the keystream with the TX
    payload position of each received bit. ``align_shift`` counts the
    payloads recovered at each shift."""
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
                align_shift[shift] += 1
                return rec
    return None


@dataclass
class LinkFrames:
    """What FrameSync emits for each of a batch's C channels.

    ``found`` [C] bool: the payload was recovered; ``bits`` [C, n_bits]
    uint8, the payload bits (0 where not found); ``offset`` [C] int64,
    the accepted frame's offset in the window, as the automaton gives it
    (-1 where no header decoded); ``scale``, ``dfc``, ``phase`` [C]
    float64, the estimates the automaton accepted with it (NaN where no
    header decoded). ``arrays``: the search arrays (scale, delta_fc,
    phase_off, corr_peak as int64; [C, n_pad] numpy) where the caller
    asked to keep them, else None."""

    found: np.ndarray
    bits: np.ndarray
    offset: np.ndarray
    scale: np.ndarray
    dfc: np.ndarray
    phase: np.ndarray
    arrays: Optional[tuple] = None


def host_decode(x: np.ndarray, arrays, lengths, n_bits: int,
                **settings) -> LinkFrames:
    """Each channel's :func:`decode_frame` on the host: the receiver's
    decode on the CPU, and D1's oracle. x: the searched window, planar
    float32 [C, lp, 2]; arrays: S1's four [C, n_pad] arrays (corr_peak as
    int64) over it; channel c's samples valid up to ``lengths[c]``;
    ``settings`` :func:`decode_frame`'s keywords. Counts the channels in
    ``host_decode_channels``."""
    global host_decode_channels
    channels, lp = x.shape[:2]
    head = lp - arrays[0].shape[1]  # samples a frame's head spans
    scale, dfc, pho, peak = arrays
    waves = x.view(np.complex64)[..., 0]
    out = LinkFrames(
        found=np.zeros(channels, bool),
        bits=np.zeros((channels, n_bits), np.uint8),
        offset=np.full(channels, -1, np.int64),
        scale=np.full(channels, np.nan), dfc=np.full(channels, np.nan),
        phase=np.full(channels, np.nan))
    for c in range(channels):
        n_off = max(lengths[c] - head, 0)  # valid offsets for channel c
        off, est, bits = decode_frame(
            waves[c, :lengths[c]],
            (scale[c][:n_off], dfc[c][:n_off], pho[c][:n_off],
             peak[c][:n_off]), n_bits, **settings)
        if off is not None:
            out.offset[c] = off
            out.scale[c], out.dfc[c], out.phase[c] = \
                est["scale"], est["dfc"], est["pho"]
        if bits is not None:
            out.found[c] = True
            out.bits[c] = bits
    host_decode_channels += channels
    return out


def make_link_receiver(channels: int, window: int, n_bits: int, *,
                       preamble=(1.0,), symbol_width: int = 20,
                       data_width: int = 4, poly: int = 0x19, seed: int = 1,
                       header_id: int = 0x55, input_threshold: float = 0.01,
                       device=None):
    """The link's receive side for ``channels`` channels of ``window``
    samples, built once on ``device`` (the card unless the caller names
    one): the S1 search of :func:`make_channel_search`, its padded length
    ``lp`` and offsets ``n_pad``, and the decode's settings; on a card
    also D1's library, the descrambler's keystream on the card, D1's
    output and a page-locked host buffer for it.

    Returns ``receive(x, lengths, keep_arrays=False) -> LinkFrames``:
    x [C, L, 2] planar float32 on the device, L <= lp (zero-padded to lp
    on the device), channel c's samples valid up to ``lengths[c]``. One S1
    launch for the batch; on a card one D1 launch and one copy of the
    frames to the host, on the CPU each channel's :func:`decode_frame`.
    ``keep_arrays`` also copies S1's arrays to the host. ``receive.lp``
    and ``receive.n_pad`` give the search's shape."""
    dev = placement.resolve(device)
    search, lp, n_pad = make_channel_search(preamble, symbol_width,
                                            data_width, input_threshold,
                                            window, device=dev)
    settings = dict(poly=poly, seed=seed, header_id=header_id,
                    symbol_width=symbol_width, data_width=data_width,
                    preamble=preamble, device=dev)
    on_card = dev.type == "cuda"
    if on_card:
        d1.load()
        geometry = dict(
            frame_geometry(preamble, symbol_width, data_width),
            n_bits=n_bits, dw=data_width, header_id=header_id,
            last_symbol=complex(np.asarray(preamble, np.complex128)[-1]))
        # additive descrambling is an XOR with the keystream, whatever the
        # data: the /comms/descrambler block's LFSR, run on zeros
        keystream = torch.from_numpy(
            NativeLfsr(poly, seed).keystream(d1.KEYSTREAM_BITS)).to(dev)
        records = torch.empty((channels, d1.record_bytes(n_bits)),
                              dtype=torch.uint8, device=dev)
        host_records = torch.empty(records.shape, dtype=torch.uint8,
                                   pin_memory=True)

    def card_decode(x, lengths, arrays):
        """D1 over the batch, and the copy of its records to the host
        started (the caller synchronises). ``lengths`` on the card."""
        d1.frame_decode(arrays, x, lengths, keystream, records, **geometry)
        host_records.copy_(records, non_blocking=True)

    def card_frames(bits):
        """The copied records as the caller's own arrays, the payload bits
        in ``bits``."""
        global header_rejects
        got = d1.read_records(host_records.numpy(), n_bits, bits)
        header_rejects += int(got["rejects"].sum())
        align_shift.update(got["shift"][got["found"]].tolist())
        return LinkFrames(found=got["found"], bits=got["bits"],
                          offset=got["offset"], scale=got["scale"],
                          dfc=got["dfc"], phase=got["phase"])

    def receive(x: torch.Tensor, lengths, keep_arrays: bool = False):
        global search_s, decode_s, d2h_bytes, frames, frames_found
        lengths = np.asarray(lengths, np.int64)
        if x.dim() != 3 or x.shape[0] != channels or x.shape[2] != 2 \
                or x.shape[1] > lp or lengths.shape != (channels,) \
                or lengths.max() > x.shape[1] or lengths.min() < 0:
            raise ValueError(f"receive: x must be [{channels}, <= {lp}, 2] "
                             f"with lengths [{channels}] inside it, got "
                             f"{tuple(x.shape)} and {lengths.shape}")
        if x.device.type != dev.type or dev.index not in (
                None, x.device.index) or x.dtype != torch.float32:
            raise ValueError(f"receive: x must be float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        with annotate("pc.link.receive"):
            t0 = time.perf_counter()
            with annotate("pc.link.search"):
                if x.shape[1] < lp:
                    x = torch.nn.functional.pad(x, (0, 0, 0,
                                                    lp - x.shape[1]))
                x = x.contiguous()
                if on_card:  # uploaded ahead of S1, so no wait on it
                    lengths_dev = torch.from_numpy(lengths).to(dev)
                arrays = search(x)
                if on_card:
                    card_decode(x, lengths_dev, arrays)
                    kept = [a.cpu().numpy() for a in arrays] \
                        if keep_arrays else []
                    # the bits go to fresh pages, which a caller that keeps
                    # its frames has never touched: fault them in while
                    # the card works
                    bits = np.empty((channels, n_bits), np.uint8)
                    bits.fill(0)
                    torch.cuda.current_stream(dev).synchronize()
                    copied = host_records.nbytes + sum(a.nbytes
                                                       for a in kept)
                else:
                    kept, copied = [a.numpy() for a in arrays], 0
            t1 = time.perf_counter()
            d2h_bytes += copied
            if kept:
                kept[3] = kept[3].astype(np.int64)
            out = card_frames(bits) if on_card else host_decode(
                x.numpy(), kept, lengths, n_bits, **settings)
            out.arrays = tuple(kept) if keep_arrays else None
            t2 = time.perf_counter()
        search_s += t1 - t0
        decode_s += t2 - t1
        frames += channels
        frames_found += int(out.found.sum())
        return out

    receive.lp, receive.n_pad = lp, n_pad
    return receive


def channel_wave(c: int, bits: np.ndarray, seed: int, noise: float,
                 device=None) -> np.ndarray:
    """Channel c's wave: the TX frame of ``bits`` after the link's channel
    schedule for channel c (gaps, attenuation, phase, frequency offset,
    AWGN from ``seed + 100 + c``), as the JAX package's
    ``run_sharded_link`` draws it."""
    wave = tx_waveform(bits, symbol_width=20, data_width=4, device=device)
    return apply_channel(
        wave,
        gap_pre=300 + 40 * c,
        gap_post=500 - 40 * (c % 8),
        attenuation=0.4 + 0.05 * (c % 8),
        phase=0.3 * c,
        freq_offset=1e-4 * ((c % 5) - 2),
        noise=noise,
        rng=np.random.default_rng(seed + 100 + c),
    )


def channel_bits(n_channels: int, n_bits: int, seed: int):
    """Every channel's payload bits, drawn in channel order from one
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, n_bits).astype(np.uint8)
            for _ in range(n_channels)]


def channel_waves(n_channels: int, n_bits: int, seed: int, noise: float,
                  device=None):
    """The TX side of :func:`run_link`: each channel's bits and its wave
    (:func:`channel_wave`)."""
    tx_bits = channel_bits(n_channels, n_bits, seed)
    return tx_bits, [channel_wave(c, tx_bits[c], seed, noise, device)
                     for c in range(n_channels)]


def _receive(waves, tx_bits, receive, dev: torch.device):
    """The RX side of a link: pad the waves into one [C, lp, 2] batch on
    ``dev`` and hand it to ``receive`` (:func:`make_link_receiver`).
    Returns (per-channel exactness, the batch, the search arrays as numpy,
    the seconds of each stage)."""
    t0 = time.perf_counter()
    x = np.zeros((len(waves), receive.lp, 2), np.float32)
    for c, wv in enumerate(waves):
        x[c, : len(wv), 0] = wv.real
        x[c, : len(wv), 1] = wv.imag
    xd = torch.from_numpy(x).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    s0, d0 = search_s, decode_s
    got = receive(xd, [len(wv) for wv in waves], keep_arrays=True)
    ok = [bool(got.found[c]) and np.array_equal(got.bits[c], tx_bits[c])
          for c in range(len(waves))]
    return ok, xd, got.arrays, {
        "upload": t1 - t0, "search": search_s - s0,
        "rx_decode": decode_s - d0}


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
    receive = make_link_receiver(n_channels, max(len(w) for w in waves),
                                 n_bits, device=dev)
    ok, xd, arrays, seconds = _receive(waves, tx_bits, receive, dev)
    return {
        "channels": n_channels,
        "bit_exact": ok,
        "all_exact": all(ok),
        "lp": receive.lp,
        "n_pad": receive.n_pad,
        "x": xd,
        "arrays": arrays,
        "seconds": {"tx": t1 - t0, **seconds},
    }


def make_sharded_search(mesh, preamble, symbol_width: int, data_width: int,
                        input_threshold: float, length: int):
    """Build the channel-sharded search on this rank of ``mesh``.

    Returns (search, lp, n_pad): search(x [C/n, lp, 2]) -> 4 tensors
    [C/n, n_pad] on the rank's device, one S1 launch for the rank's
    channels (the mesh's "ch" axis splits C). ``length`` is the longest
    wave over every rank's channels, so every rank pads alike; lp =
    bucket_len of it (pad inputs with zeros)."""
    return make_channel_search(preamble, symbol_width, data_width,
                               input_threshold, length, device=mesh.device)


def run_sharded_link(mesh, n_channels: int, n_bits: int = 64, seed: int = 7,
                     noise: float = 0.0) -> dict:
    """End-to-end link over ``n_channels`` independent channels with the
    search sharded over the mesh's "ch" axis: this rank sends, searches
    and decodes its own contiguous block of C/n channels, drawn as the
    JAX package draws them (one generator for every channel's bits, in
    order; ``seed + 100 + c`` for channel c's noise), and pads to the
    longest wave of any rank.

    Every rank returns the JAX package's result dict (``channels``,
    ``bit_exact`` for every channel, gathered from every rank,
    ``all_exact``, ``devices``, the mesh's size), and beside it this
    rank's ``lp``, ``n_pad``, search input ``x``, search ``arrays`` and
    the ``seconds`` of each stage."""
    dev = mesh.device
    n, i = mesh.axis_size("ch"), mesh.axis_index("ch")
    if n_channels % n:
        raise ValueError(f"{n_channels} channels do not split into {n}")
    per = n_channels // n
    t0 = time.perf_counter()
    tx_bits = channel_bits(n_channels, n_bits, seed)[i * per:(i + 1) * per]
    waves = [channel_wave(i * per + c, bits, seed, noise, dev)
             for c, bits in enumerate(tx_bits)]
    t1 = time.perf_counter()
    length = mesh.all_reduce_max(max(len(w) for w in waves), "ch")
    receive = make_link_receiver(per, length, n_bits, device=dev)
    ok, xd, arrays, seconds = _receive(waves, tx_bits, receive, dev)
    ok = [v for part in mesh.all_gather_object(ok, "ch") for v in part]
    return {
        "channels": n_channels,
        "bit_exact": ok,
        "all_exact": all(ok),
        "devices": mesh.size,
        "lp": receive.lp,
        "n_pad": receive.n_pad,
        "x": xd,
        "arrays": arrays,
        "seconds": {"tx": t1 - t0, **seconds},
    }
