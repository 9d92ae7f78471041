"""Plain reference of ``digital_link_bpsk_4000b``: the framed BPSK link's
transmitter and its receiver, written out from PothosComms' formulas in
numpy and torch, in float64.

TX (it also makes the cell's traffic): the payload between two zero
pilots, scrambled by the additive Galois LFSR (digital/Scrambler.cpp,
lfsr.h), mapped to [-1, 1], behind FrameInsert's preamble and its 58-bit
Hamming(8,4) header of id, length and checksum (FrameInsert.cpp,
FrameHelper.hpp), each symbol a rectangular pulse of ``data_width``
samples; then the channel: the leading gap, attenuation, phase, carrier
offset and AWGN over the window.

RX, from FrameSync.cpp: the search over every offset (the envelope
windows and the scale, the frequency estimate over the last preamble
symbol, the dechirped correlation; :595-693), the acceptance automaton
(:488-502, magnitude above 70% of the sync word, duration 50%), the
header's bit-timing search and decode (:699-743), the payload sampled at
the bit clock with the phase ramp taken out, the slicer, and the
descrambler at the pilot's alignment.

``check_step`` holds a step of the program to it on the same window: the
payload bits against the transmitted ones, the frame offset against the
set of offsets the float64 automaton accepts (a peak's floor within 1e-3
of an integer may fall either way: a float32 sum of the sync word's 80
terms of |x| <= ~1.3 strays by up to ~4e-4),
and the estimates against the float64 search's at the accepted peak. The
control (``control_output``) is this receiver with its search in
bfloat16, the nearest precision below the configuration's float32.
"""

from __future__ import annotations

import functools
import itertools
from types import SimpleNamespace

import numpy as np
import torch

NUM_HEADER_BITS = 2 + (8 + 12 + 8) * 2  # FrameHelper.hpp:9
CORR_MAG_PERCENT, CORR_DUR_PERCENT = 0.7, 0.5
# |L| within this of an integer: its floor may go either way in float32
NEAR_INTEGER = 1e-3
# at most this many such peaks a frame are taken both ways (2^8 runs)
MAX_AMBIGUOUS = 8


# ---------------------------------------------------------------------- #
# settings
# ---------------------------------------------------------------------- #
def shape(cfg: dict) -> SimpleNamespace:
    """The link's sizes: w samples a preamble symbol, sw of sync word, fw
    of sync word and header, the magnitude and duration thresholds."""
    pre = np.asarray(cfg["preamble"], np.complex128)
    w = int(cfg["symbol_width"]) * int(cfg["data_width"])
    sw = w * len(pre)
    return SimpleNamespace(
        pre=pre, w=w, sw=sw, dw=int(cfg["data_width"]),
        fw=sw + NUM_HEADER_BITS * int(cfg["data_width"]),
        mag=int(sw * CORR_MAG_PERCENT), dur=int(sw * CORR_DUR_PERCENT),
        thr=float(cfg["input_threshold"]), n_bits=int(cfg["payload_bits"]),
        pilot=int(cfg["pilot_bits"]))


def impairments(channels: int):
    """run_sharded_link's schedule: (attenuation, phase, carrier offset)
    of each channel, float64 [C]."""
    c = np.arange(channels)
    return 0.4 + 0.05 * (c % 8), 0.3 * c, 1e-4 * ((c % 5) - 2)


# ---------------------------------------------------------------------- #
# bits: the LFSR, the header codec
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def keystream(poly: int, seed: int, n: int) -> np.ndarray:
    """The additive scrambler's n key bits (lfsr.h: shift left, and where
    the polynomial's top bit comes out xor the polynomial, with +1); the
    scrambler restarts from ``seed`` a frame. Read-only."""
    mask = 1 << (int(poly).bit_length() - 1)
    full = (int(poly) | 1)
    data = int(seed)
    out = np.empty(n, np.uint8)
    for i in range(n):
        data = (data << 1) & ((1 << 64) - 1)
        out[i] = 1 if data & mask else 0
        if out[i]:
            data ^= full
    out.flags.writeable = False
    return out


def checksum8(data) -> int:
    acc = 0
    for b in data:
        acc = (((acc >> 1) | ((acc & 1) << 7)) + int(b)) & 0xFF
    return acc


def hamming84(nibble: int) -> list:
    d = [(nibble >> i) & 1 for i in range(4)]
    return [d[0] ^ d[1] ^ d[3], d[0] ^ d[2] ^ d[3], d[0],
            d[1] ^ d[2] ^ d[3], d[1], d[2], d[3], d[0] ^ d[1] ^ d[2]]


def unhamming84(b) -> tuple:
    """(nibble, error): one flipped bit corrected, two detected."""
    b = [int(v) & 1 for v in b]
    syndrome = ((b[0] ^ b[2] ^ b[4] ^ b[6]) | (b[1] ^ b[2] ^ b[5] ^ b[6]) << 1
                | (b[3] ^ b[4] ^ b[5] ^ b[6]) << 2 | (sum(b) & 1) << 3)
    if 0 < syndrome < 8:
        return 0, True
    if syndrome >= 8:
        b[(syndrome - 9) % 8] ^= 1
    return b[2] | b[4] << 1 | b[5] << 2 | b[6] << 3, False


def header_bits(header_id: int, length: int) -> np.ndarray:
    """Two sync bits 0, 1, then Hamming(8,4) of the id's two nibbles,
    the length's three and the checksum's two."""
    chk = checksum8([header_id & 0xFF, length & 0xFF, (length >> 8) & 0xFF])
    nibbles = [header_id & 0xF, header_id >> 4 & 0xF, length & 0xF,
               length >> 4 & 0xF, length >> 8 & 0xF, chk & 0xF, chk >> 4]
    return np.array([0, 1] + [v for n in nibbles for v in hamming84(n)],
                    np.uint8)


def read_header(bits) -> dict:
    vals, error = [], False
    for k in range(7):
        v, e = unhamming84(bits[2 + 8 * k: 10 + 8 * k])
        vals.append(v)
        error |= e
    return {"id": vals[0] | vals[1] << 4,
            "length": vals[2] | vals[3] << 4 | vals[4] << 8,
            "chksum": vals[5] | vals[6] << 4, "error": error}


# ---------------------------------------------------------------------- #
# TX and the channel
# ---------------------------------------------------------------------- #
def tx_frames(cfg: dict, bits: np.ndarray) -> np.ndarray:
    """The baseband frames of payloads ``bits`` [C, n_bits]: complex128
    [C, (sw / dw + 58 + n_bits + 2 pilot) dw]."""
    s = shape(cfg)
    bits = np.asarray(bits, np.uint8) & 1
    pad = np.zeros((len(bits), s.pilot), np.uint8)
    payload = np.concatenate([pad, bits, pad], axis=1)
    ks = keystream(cfg["scrambler_poly"], cfg["scrambler_seed"],
                   payload.shape[1])
    smap = np.asarray(cfg["symbol_map"], np.complex128)
    data = smap[payload ^ ks]
    hdr = header_bits(int(cfg["header_id"]), payload.shape[1])
    head = np.concatenate([np.repeat(s.pre, int(cfg["symbol_width"])),
                           np.where(hdr != 0, s.pre[-1], -s.pre[-1])])
    syms = np.concatenate([np.broadcast_to(head, (len(bits), len(head))),
                           data], axis=1)
    return np.repeat(syms, s.dw, axis=1)


def channel(frames, gaps, window: int, attenuation, phase, freq_offset,
            awgn=None) -> torch.Tensor:
    """Each frame [C, F] at its gap in a window of ``window`` samples,
    times attenuation e^(j (phase + freq_offset n)) for n counted from the
    window's start, plus ``awgn`` [C, window] where given: complex128 [C,
    window] on the device of ``frames`` (a tensor) or the CPU."""
    frames = torch.as_tensor(frames, dtype=torch.complex128)
    dev = frames.device
    c, f = frames.shape
    gaps = torch.as_tensor(np.asarray(gaps), dtype=torch.int64, device=dev)
    sig = torch.zeros((c, window), dtype=torch.complex128, device=dev)
    sig.scatter_(1, gaps[:, None] + torch.arange(f, device=dev), frames)
    n = torch.arange(window, dtype=torch.float64, device=dev)

    def col(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=dev)[:, None]

    sig = sig * col(attenuation) * torch.exp(
        1j * (col(phase) + col(freq_offset) * n))
    if awgn is not None:
        sig = sig + torch.as_tensor(awgn, dtype=torch.complex128, device=dev)
    return sig


def pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """The cell's traffic: ``traffic["pool"]`` window batches, each a dict
    of ``x`` [C, W, 2] planar float32 on ``device``, the payload ``bits``
    [C, n_bits] uint8 and the ``gaps`` [C]; fresh bits, gaps and noise a
    batch, all from ``seed``."""
    s = shape(cfg)
    c, win = int(traffic["channels"]), int(traffic["samples_per_step"])
    att, ph, fo = impairments(c)
    noise = float(cfg["noise"])
    out = []
    for k in range(int(traffic["pool"])):
        rng = np.random.default_rng([seed, 24, k])
        bits = rng.integers(0, 2, (c, s.n_bits)).astype(np.uint8)
        gaps = rng.integers(int(traffic["gap_min"]),
                            int(traffic["gap_max"]) + 1, c)
        frames = torch.from_numpy(tx_frames(cfg, bits)).to(device)
        if gaps.max() + frames.shape[1] > win:
            raise ValueError("a frame does not fit its window")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(0, 2 ** 62)))
        awgn = torch.randn((2, c, win), generator=gen, dtype=torch.float64,
                           device=device) * noise
        sig = channel(frames, gaps, win, att, ph, fo,
                      torch.complex(awgn[0], awgn[1]))
        x = torch.view_as_real(sig.to(torch.complex64)).contiguous()
        out.append({"x": x, "bits": bits, "gaps": gaps})
        del frames, awgn, sig
    return out


# ---------------------------------------------------------------------- #
# RX
# ---------------------------------------------------------------------- #
def search(cfg: dict, x: torch.Tensor, dtype=torch.float64) -> dict:
    """FrameSync's per-offset quantities for the offsets 0 .. W - fw of
    every channel of x [C, W, 2], computed in ``dtype`` (every sum a direct
    sum of its terms), returned as float64 numpy [C, n]: scale, dfc,
    phase, abs_L and corr_peak (floor |L| where scale is not 0)."""
    s = shape(cfg)
    win = x.shape[1]
    n = win - s.fw + 1
    xr, xi = x[..., 0].to(dtype), x[..., 1].to(dtype)
    absx = torch.sqrt(xr * xr + xi * xi)
    half = s.w // 2

    def at(a, k):
        return a[:, k:k + n]

    def window_mean(lo, hi):
        acc = at(absx, lo).clone()
        for k in range(lo + 1, hi):
            acc = acc + at(absx, k)
        return acc / (hi - lo)

    sum0 = window_mean(s.dw, half)
    sum1 = window_mean(s.sw - half, s.sw - s.dw)
    ok = (at(absx, s.dw) >= s.thr) & (at(absx, s.sw - s.dw) >= s.thr) \
        & (sum0 >= s.thr) & (sum1 >= s.thr)
    s0 = sum0 / float(np.abs(s.pre[0]))
    s1 = sum1 / float(np.abs(s.pre[-1]))
    ratio = torch.where(s1 != 0, s0 / torch.where(s1 == 0, 1.0, s1),
                        torch.inf)
    ok &= (ratio <= 2) & (ratio >= 0.5)
    scale = torch.where(ok, 2.0 / torch.where(ok, s0 + s1, 1.0),
                        0.0).to(dtype)
    # the frequency estimate: K = sum x[m] conj(x[m + w/2]) over the last
    # preamble symbol, its angle over w/2
    off = s.w * (len(s.pre) - 1)
    kr = ki = None
    for k in range(off + s.dw, off + s.w - half - s.dw):
        ar, ai, br, bi = at(xr, k), at(xi, k), at(xr, k + half), \
            at(xi, k + half)
        tr, ti = ar * br + ai * bi, ai * br - ar * bi
        kr, ki = (tr, ti) if kr is None else (kr + tr, ki + ti)
    dfc = torch.where(scale != 0, torch.atan2(ki, kr) / half, 0.0).to(dtype)
    # the dechirped correlation with the preamble, each symbol w samples
    prep = np.repeat(s.pre, s.w)
    lr = li = None
    for j in range(s.sw):
        ang = dfc * j
        cr, ci = torch.cos(ang), torch.sin(ang)
        pr, pi = float(prep[j].real), -float(prep[j].imag)
        ar, ai = at(xr, j), at(xi, j)
        yr, yi = ar * cr - ai * ci, ar * ci + ai * cr
        tr, ti = yr * pr - yi * pi, yr * pi + yi * pr
        lr, li = (tr, ti) if lr is None else (lr + tr, li + ti)
    lr, li = lr * scale, li * scale
    abs_l = torch.sqrt(lr * lr + li * li)
    out = {"scale": scale, "dfc": dfc, "phase": -torch.atan2(li, lr),
           "abs_L": abs_l,
           "corr_peak": torch.where(scale != 0, torch.floor(abs_l), 0.0)}
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def automaton(cp: np.ndarray, mag: int, dur: int, decode):
    """FrameSync.cpp:488-502 over the offsets of ``cp`` (the floored
    peaks): a peak above the magnitude threshold and above the pending one
    becomes the pending one; once ``dur`` offsets have passed since it,
    the frame at (that offset - dur) is tried with ``decode(frame_offset,
    peak)``. Only offsets above ``mag`` change anything, so only they are
    visited. Returns (frame_offset, peak, decode's result) or None."""
    cand = np.flatnonzero(cp > mag)
    n, ci, best, peak = len(cp), 0, 0, -1
    while True:
        if peak < 0:
            if ci >= len(cand):
                return None
            peak = int(cand[ci])
            best = int(cp[peak])
            ci += 1
            continue
        accept = peak + dur - 1
        while ci < len(cand) and cand[ci] <= accept \
                and int(cp[cand[ci]]) <= best:
            ci += 1
        if ci < len(cand) and cand[ci] <= accept:
            peak = int(cand[ci])
            best = int(cp[peak])
            ci += 1
            continue
        if accept >= n:
            return None
        frame_offset, found = accept - dur, peak
        peak, best = -1, 0
        while ci < len(cand) and cand[ci] <= accept:
            ci += 1
        if frame_offset >= 0:
            got = decode(frame_offset, found)
            if got is not None:
                return frame_offset, found, got


def decode_header(cfg: dict, wave: np.ndarray, frame_offset: int,
                  scale: float, dfc: float, pho: float):
    """The header at ``frame_offset`` (FrameSync.cpp:699-743): the first
    bit's sampling offset, where the dechirped, scaled real part stops
    rising, then the 58 bits at the bit clock. Returns (first_bit,
    payload length) or None where the header is refused."""
    s = shape(cfg)
    x = wave[frame_offset:]
    sym = np.conj(s.pre[-1])
    first_bit, peak_val = s.sw + s.dw // 2, 0.0
    for i in range(s.sw - (s.dw * int(cfg["symbol_width"])) // 2, s.fw):
        v = (x[i] * scale * np.exp(1j * (pho + dfc * i)) * sym).real
        if v > peak_val:
            if peak_val == 0:
                continue
            break
        first_bit, peak_val = i, v
    if peak_val == 0:
        return None
    idx = first_bit + s.dw * np.arange(NUM_HEADER_BITS)
    bits = ((x[idx] * scale * np.exp(1j * (pho + dfc * idx)) * sym).real
            > 0).astype(np.uint8)
    h = read_header(bits)
    if h["error"] or h["id"] != int(cfg["header_id"]) or h["length"] == 0 \
            or h["chksum"] != checksum8([h["id"], h["length"] & 0xFF,
                                         h["length"] >> 8]):
        return None
    return first_bit, h["length"]


def payload(cfg: dict, wave: np.ndarray, frame_offset: int, first_bit: int,
            length: int, scale: float, dfc: float, pho: float):
    """The payload bits: each symbol sampled once at the bit clock after
    the header, the scale and phase ramp taken out, sliced to the nearer
    of the map's two points, descrambled at the shift (0, 1 or 2) where
    the leading pilot comes out all zeros. None where it does not."""
    s = shape(cfg)
    rel = first_bit + NUM_HEADER_BITS * s.dw + np.arange(length) * s.dw
    if frame_offset + rel[-1] >= len(wave):
        return None
    y = wave[frame_offset + rel] * scale * np.exp(1j * (pho + dfc * rel))
    smap = np.asarray(cfg["symbol_map"], np.complex128)
    sliced = np.argmin(np.abs(y[:, None] - smap[None, :]) ** 2,
                       axis=1).astype(np.uint8)
    ks = keystream(cfg["scrambler_poly"], cfg["scrambler_seed"],
                   length + 2)
    for shift in (0, 1, 2):
        out = sliced ^ ks[shift:shift + length]
        if not out[:s.pilot - shift].any():
            rec = out[s.pilot - shift:s.pilot - shift + s.n_bits]
            if len(rec) == s.n_bits:
                return rec
    return None


def receive(cfg: dict, x: torch.Tensor, dtype=torch.float64):
    """The receiver on window batch x [C, W, 2], its search in ``dtype``:
    what FrameSync emits for each channel (``found``, ``bits``,
    ``offset``, ``scale``, ``dfc``, ``phase``, as the program's frames),
    and the search's arrays."""
    s = shape(cfg)
    arr = search(cfg, x, dtype)
    waves = x[..., 0].double().cpu().numpy() \
        + 1j * x[..., 1].double().cpu().numpy()
    c = x.shape[0]
    out = SimpleNamespace(
        found=np.zeros(c, bool), bits=np.zeros((c, s.n_bits), np.uint8),
        offset=np.full(c, -1, np.int64), scale=np.full(c, np.nan),
        dfc=np.full(c, np.nan), phase=np.full(c, np.nan))
    for ch in range(c):
        est = (arr["scale"][ch], arr["dfc"][ch], arr["phase"][ch])

        def decode(off, peak):
            return decode_header(cfg, waves[ch], off, est[0][peak],
                                 est[1][peak], est[2][peak])

        hit = automaton(arr["corr_peak"][ch], s.mag, s.dur, decode)
        if hit is None:
            continue
        off, peak, (first_bit, length) = hit
        e = [float(a[peak]) for a in est]
        out.offset[ch] = off
        out.scale[ch], out.dfc[ch], out.phase[ch] = e
        bits = payload(cfg, waves[ch], off, first_bit, length, *e)
        if bits is not None:
            out.found[ch], out.bits[ch] = True, bits
    return out, arr, waves


def accepted_offsets(cfg: dict, arr: dict, wave: np.ndarray, ch: int):
    """Every frame offset the automaton accepts on channel ``ch`` when
    each peak whose |L| lies within :data:`NEAR_INTEGER` of an integer
    (and could pass the magnitude threshold) is floored either way: the
    float64 answer and the answers float32 rounding may give."""
    s = shape(cfg)
    cp = arr["corr_peak"][ch].astype(np.int64)
    abs_l = arr["abs_L"][ch]
    near = np.flatnonzero((arr["scale"][ch] != 0)
                          & (np.abs(abs_l - np.round(abs_l)) < NEAR_INTEGER)
                          & (np.round(abs_l) > s.mag))
    near = near[np.argsort(-abs_l[near])][:MAX_AMBIGUOUS]
    heads = {}

    def decode(off, peak):
        key = (off, peak)
        if key not in heads:
            heads[key] = decode_header(cfg, wave, off, arr["scale"][ch][peak],
                                       arr["dfc"][ch][peak],
                                       arr["phase"][ch][peak])
        return heads[key]

    offsets = set()
    rounded = np.round(abs_l[near]).astype(np.int64)
    for ups in itertools.product((0, 1), repeat=len(near)):
        v = cp.copy()
        v[near] = rounded - 1 + np.asarray(ups, np.int64)
        hit = automaton(v, s.mag, s.dur, decode)
        if hit is not None:
            offsets.add(hit[0])
    return offsets


def check_step(cfg: dict, x: torch.Tensor, frames, bits: np.ndarray) -> dict:
    """One step of the program (``frames``, what it emitted for window
    batch x [C, W, 2]) against the float64 receiver on the same window and
    the transmitted payloads ``bits`` [C, n_bits]:

    - ``bit_errors``: payload bits of found frames that differ from the
      transmitted ones;
    - ``frames_lost``: frames not found;
    - ``offset_err``: the largest distance of a frame's offset from the
      nearest offset the float64 automaton accepts (:func:`accepted_
      offsets`), over the frames with a header;
    - ``scale_rel``, ``dfc_abs``, ``phase_abs`` (wrapped): the largest
      distance of the estimates from the float64 search's at the frame's
      peak (offset + 1), the scale's relative to it."""
    arr = search(cfg, x)
    waves = x[..., 0].double().cpu().numpy() \
        + 1j * x[..., 1].double().cpu().numpy()
    found = np.asarray(frames.found, bool)
    out = {"bit_errors": float((np.asarray(frames.bits)[found]
                                != np.asarray(bits)[found]).sum()),
           "frames_lost": float((~found).sum()), "offset_err": 0.0,
           "scale_rel": 0.0, "dfc_abs": 0.0, "phase_abs": 0.0}
    n = arr["scale"].shape[1]
    for ch in range(x.shape[0]):
        off = int(frames.offset[ch])
        if off < 0:
            continue
        ok = accepted_offsets(cfg, arr, waves[ch], ch)
        err = min((abs(off - a) for a in ok), default=np.inf)
        out["offset_err"] = max(out["offset_err"], float(err))
        p = off + 1
        if not 0 <= p < n or arr["scale"][ch][p] == 0:
            out["scale_rel"] = np.inf
            continue
        ref_s = arr["scale"][ch][p]
        d_ph = np.angle(np.exp(1j * (frames.phase[ch]
                                     - arr["phase"][ch][p])))
        for key, v in (("scale_rel", abs(frames.scale[ch] - ref_s) / ref_s),
                       ("dfc_abs", abs(frames.dfc[ch] - arr["dfc"][ch][p])),
                       ("phase_abs", abs(d_ph))):
            out[key] = max(out[key], float(v))
    return out


def control_output(cfg: dict, x: torch.Tensor):
    """The control: this receiver with its search in bfloat16, in the
    program's place."""
    return receive(cfg, x, torch.bfloat16)[0]
