"""Filter blocks (reference: filter/ module, SURVEY.md §2.3); the port of
the JAX package's ``blocks/filter.py``. So far: /comms/fir_filter,
/comms/dc_removal and /comms/envelope_detector.

Where the FIR runs: a complex_float32 stream streams on the topology's
device (planar float32, as the JAX package does on its chip); every
other dtype streams on the host. Fused, a 1:1 FIR is the block-Toeplitz
matmul core (K1 on CUDA), or half of the FIR -> FFT pair operator. A
rational FIR (decimation or interpolation above 1) does not fuse yet:
its blocked operator (``rational_fir_operators`` / ``rational_fir_mm``)
comes with the resampler (ROADMAP Queue 1 item 9), so until then it
streams with the reference semantics.
"""

from __future__ import annotations

import numpy as np
import torch

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.qformat import Q_ACCUMULATOR
from pothoscomms_tpu_torch.core.registry import register_block
from pothoscomms_tpu_torch.ops import filter as fops


# ---------------------------------------------------------------------- #
# /comms/fir_filter — polyphase rational resampler
# (reference: filter/FIRFilter.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/fir_filter", "/blocks/fir_filter")
class FIRFilter(Block):
    """Rational-resampling FIR with Q-format fixed point, burst flushing,
    and waitTaps gating (reference: filter/FIRFilter.cpp:98-364)."""

    DOC = {
        "category": "/Filter",
        "keywords": ["fir", "filter", "taps", "resampler", "decimate",
                     "interpolate"],
        "params": {
            "taps": {"label": "Taps", "default": [1.0],
                     "desc": "FIR filter taps (set directly or wire a "
                             "designer's tapsChanged signal)."},
            "decimation": {"label": "Decimation", "default": 1,
                           "widget": "SpinBox(minimum=1)"},
            "interpolation": {"label": "Interpolation", "default": 1,
                              "widget": "SpinBox(minimum=1)"},
            "wait_taps": {"label": "Wait Taps", "default": False,
                          "widget": "ToggleSwitch",
                          "desc": "Defer work until setTaps is called."},
            "frame_start_id": {"label": "Frame Start ID", "default": "",
                               "desc": "Burst-mode frameStart label."},
            "frame_end_id": {"label": "Frame End ID", "default": ""},
        },
    }

    def __init__(self, dtype="complex_float32", taps_type: str = "REAL"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        taps_type = taps_type.upper()
        if taps_type not in ("REAL", "COMPLEX"):
            raise ValueError("tapsType must be REAL or COMPLEX")
        if taps_type == "COMPLEX" and not self.dtype.is_complex:
            raise ValueError("complex taps require a complex dtype")
        if self.dtype.kind == "uint":
            raise ValueError("unsupported dtype (reference matrix is "
                             "int/float)")
        self._complex_taps = taps_type == "COMPLEX"
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._M = 1  # decimation
        self._L = 1  # interpolation
        self._K = 1
        self._wait_taps = False
        self._wait_armed = False
        self._frame_start_id = ""
        self._frame_end_id = ""
        self._eob_samps_left = 0
        self._taps = np.asarray([1.0])
        self.set_taps([1.0])

    # -- configuration ---------------------------------------------------- #
    def set_taps(self, taps):
        taps = np.asarray(taps)
        if taps.size == 0:
            raise ValueError("taps cannot be empty")
        if self._complex_taps:
            taps = taps.astype(np.complex128)
        else:
            taps = np.real(taps).astype(np.float64)
        self._taps = taps
        self._wait_armed = False
        self._update_internals()

    def get_taps(self):
        return self._taps

    def set_decimation(self, decim: int):
        if decim == 0:
            raise ValueError("decimation cannot be 0")
        self._M = int(decim)
        self._update_internals()

    def get_decimation(self) -> int:
        return self._M

    def set_interpolation(self, interp: int):
        if interp == 0:
            raise ValueError("interpolation cannot be 0")
        self._L = int(interp)
        self._update_internals()

    def get_interpolation(self) -> int:
        return self._L

    def set_wait_taps(self, wait: bool):
        self._wait_taps = bool(wait)

    def get_wait_taps(self) -> bool:
        return self._wait_taps

    def set_frame_start_id(self, label_id: str):
        self._frame_start_id = label_id

    def get_frame_start_id(self) -> str:
        return self._frame_start_id

    def set_frame_end_id(self, label_id: str):
        self._frame_end_id = label_id

    def get_frame_end_id(self) -> str:
        return self._frame_end_id

    def _update_internals(self):
        self._bump_fuse_epoch()
        # polyphase split + Q-format conversion (reference :327-354)
        self._taps_q, self._K = fops.fir_tap_state(
            self._taps, self._L, self.dtype, self._complex_taps
        )
        self._input_require = self._M + (self._K - 1)
        self._taps_dev = None  # planar taps on the device, made at use
        if self.dtype.is_float:
            self._kind = "float"
            self._half_shift = 0
            if self.dtype.is_complex and not self._complex_taps:
                # real taps applied to complex stream: promote to complex
                self._taps_q = self._taps_q.astype(self.dtype.np)
        else:
            qbits = DType.parse(Q_ACCUMULATOR[self.dtype.scalar.name]).bits
            self._half_shift = qbits // 2
            if self.dtype.is_complex:
                self._kind = "cint_ctaps" if self._complex_taps else "cint_rtaps"
            else:
                self._kind = "int"

    def activate(self):
        self._wait_armed = self._wait_taps
        self._eob_samps_left = 0

    def _planar_taps(self) -> torch.Tensor:
        """The polyphase taps as a planar float32 [L, K, 2] tensor on the
        block's device (cached until the taps or the device change)."""
        dev = self.device
        if self._taps_dev is None or self._taps_dev.device != dev:
            tq = np.asarray(self._taps_q, np.complex128)
            planar = np.stack([tq.real, tq.imag], -1).astype(np.float32)
            self._taps_dev = torch.from_numpy(planar).to(dev)
        return self._taps_dev

    # -- streaming --------------------------------------------------------- #
    def work(self):
        if self._wait_armed:
            return
        port = self.input(0)
        available = port.elements()
        if available == 0:
            return

        # burst label scan (reference :218-231)
        if self._eob_samps_left == 0:
            for lb in sorted(port.labels, key=lambda l: l.index):
                if self._frame_start_id and lb.id == self._frame_start_id \
                        and lb.data is not None:
                    self._eob_samps_left = lb.index + int(lb.data) * lb.width
                    break
                if self._frame_end_id and lb.id == self._frame_end_id:
                    self._eob_samps_left = lb.index + lb.width
                    break

        flush_mode = False
        if self._eob_samps_left != 0:
            if self._eob_samps_left <= available:
                available = self._eob_samps_left
                flush_mode = self._eob_samps_left < self._input_require
            else:
                port.set_reserve(self._eob_samps_left)
                return
        elif available < self._input_require:
            port.set_reserve(self._input_require)
            return
        port.set_reserve(0)

        K, M, L = self._K, self._M, self._L
        buf = np.asarray(port.buffer(available))
        if flush_mode:
            # zero-padded flush buffer (reference :262-272)
            pad_shape = (K - 1,) + buf.shape[1:]
            xh = np.concatenate([buf, np.zeros(pad_shape, buf.dtype)])
            n_in = available
        else:
            xh = buf
            n_in = available - (K - 1)

        N = (n_in // M) * M
        if N == 0:
            if flush_mode:
                # burst shorter than one decimation step: drop it to avoid
                # a stuck tail (the reference would leave it queued forever)
                port.consume(available)
                self._eob_samps_left = 0
            return

        if (self._kind == "float" and self.dtype.is_complex
                and self.dtype.bits == 32):
            # planar float32 on the topology's device
            xin = np.ascontiguousarray(xh[: N + K - 1], np.complex64)
            xp = torch.from_numpy(xin.view(np.float32).reshape(-1, 2))
            y = fops.polyphase_fir(xp.to(self.device), self._planar_taps(),
                                   M, L, K, "planar", 0)
            out = y.cpu().numpy().view(np.complex64)[:, 0]
        else:
            y = fops.polyphase_fir(
                torch.from_numpy(np.ascontiguousarray(xh[: N + K - 1])),
                torch.from_numpy(self._taps_q), M, L, K, self._kind,
                self._half_shift)
            out = y.numpy()
        if self._kind in ("float", "int"):
            out = out.astype(self.dtype.np)
        else:
            out = out.astype(self.dtype.scalar.np)

        if flush_mode:
            # the zero-padded tail completed the burst: consume it all
            # (incl. any sub-M remainder the reference would leave stuck)
            port.consume(available)
            self._eob_samps_left = 0
        elif self._eob_samps_left != 0:
            port.consume(N)
            self._eob_samps_left -= N
        else:
            port.consume(N)  # K-1 history stays queued (reference :305)
        self.output(0).post(out)

    def propagate_labels(self, port, labels):
        # rescale indices and rxRate by L/M (reference :311-323)
        out = self.output(0)
        for lb in labels:
            new = lb.to_adjusted(self._L, self._M)
            if lb.id == "rxRate" and isinstance(lb.data, float):
                new.data = lb.data * self._L / self._M
            out.post_label(new)

    def device_core(self, channels: int, device=None):
        """Fused-chain core: block-Toeplitz matmul FIR over [C, T(, 2)]
        planar float32 on ``device`` (default: the block's; the K1 kernel
        on CUDA);
        carry = K-1 history samples per channel. Rational rates wait for
        the blocked rational operator (module docstring)."""
        from pothoscomms_tpu_torch.parallel.chain import (
            fir_multichannel_mm, fir_toeplitz_matrices)

        if self._M != 1 or self._L != 1:
            raise NotImplementedError(
                "fused rational FIR: rational_fir_mm is not ported yet")
        if len(self._taps) > 128:
            raise TypeError("fused FIR core requires <= 128 taps")
        dev = self.device if device is None else torch.device(device)
        t0, t1 = (t.to(dev) for t in fir_toeplitz_matrices(self._taps))
        k1 = len(self._taps) - 1

        def padded_mm(xp, hp):
            # the Toeplitz core consumes whole 128-sample blocks; pad
            # the tail with zeros and slice the outputs back — exact,
            # the convolution is causal (padding only affects outputs
            # past T). The history carry comes from the REAL tail.
            t = xp.shape[1]
            pad = (-t) % 128
            if not pad:
                return fir_multichannel_mm(xp, hp, t0, t1)
            xq = torch.cat([xp, xp.new_zeros(xp.shape[0], pad, 2)], dim=1)
            y, _ = fir_multichannel_mm(xq, hp, t0, t1)
            hist = torch.cat([hp, xp], dim=1)[:, t:]
            return y[:, :t], hist

        if self.dtype.is_complex:
            carry0 = torch.zeros((channels, k1, 2), device=dev)

            def step(carry, x):
                y, hist = padded_mm(x, carry)
                return hist, y
        else:
            carry0 = torch.zeros((channels, k1), device=dev)

            def step(carry, x):
                xp = torch.stack([x, torch.zeros_like(x)], dim=-1)
                hp = torch.stack([carry, torch.zeros_like(carry)], dim=-1)
                y, hist = padded_mm(xp, hp)
                return hist[..., 0], y[..., 0]

        return carry0, step

    # -- auto-fusion protocol (core/fusion.py) -------------------------- #
    fuse_kind = "fir"

    def fuse_retained(self) -> int:
        # an interior rational FIR retains K-1 history PLUS an input-
        # phase residue r in [0, M)
        if self._M > 1 or self._L > 1:
            k1 = self._K - 1
            avail = self.input(0).elements()
            if k1 <= avail < k1 + self._M:
                return avail
        return self._K - 1

    def fuse_granule(self) -> int:
        # a rational core would consume whole b_in blocks (128*M
        # samples); the 1:1 matmul core pads to its 128-sample Toeplitz
        # blocks internally (exact: the convolution is causal), so it
        # imposes no granule
        return 128 * self._M if (self._M != 1 or self._L != 1) else 1

    def fuse_ratio(self):
        """(out, in) sample-count ratio of the fused core."""
        return (self._L, self._M)

    def fuse_ready(self) -> bool:
        return (self._M == 1 and self._L == 1
                and not self._wait_armed
                and len(self._taps) <= 128
                and self._eob_samps_left == 0
                and self.dtype.is_float and self.dtype.bits == 32
                and self.input(0).elements() >= self._K - 1)

    def fuse_export(self, channels: int):
        """Streaming state -> device carry: the K-1 history samples are
        the first K-1 queued elements (reference FIRFilter.cpp:305 keeps
        them unconsumed); consume them into the fused carry."""
        from pothoscomms_tpu_torch.core.fusion import to_planar

        carry0, step = self.device_core(channels)
        k1 = self._K - 1
        if k1 == 0:
            return carry0, step
        parts = [to_planar(p, self.dtype, self.device)
                 for p in self.input(0).take(k1)]
        return torch.cat(parts)[None], step

    def fuse_import(self, carry) -> None:
        # restore from the carry's OWN length: a set_taps while engaged
        # may have changed self._K since export, and the old history
        # must re-enter the queue regardless (stream data, not config)
        h = carry[0].cpu().numpy()
        if h.shape[0] == 0:
            return
        if self.dtype.is_complex:
            arr = np.ascontiguousarray(h).view(np.complex64)[:, 0] \
                .astype(self.dtype.np)
        else:
            arr = h.astype(self.dtype.np)
        self.input(0).push_front_buffer(arr)


# ---------------------------------------------------------------------- #
# /comms/dc_removal (reference: filter/DCRemoval.cpp + MovingAverage.hpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/dc_removal")
class DCRemoval(Block):
    DOC = {
        "category": "/Filter",
        "keywords": ["dc", "removal", "average", "offset"],
        "params": {
            "average_size": {"label": "Average Size", "default": 1024,
                             "units": "samples",
                             "widget": "SpinBox(minimum=1)"},
            "cascade_size": {"label": "Cascade Size", "default": 1,
                             "widget": "SpinBox(minimum=1)"},
        },
    }

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if self.dtype.kind == "uint":
            raise ValueError("unsupported dtype")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        qname = Q_ACCUMULATOR[self.dtype.scalar.name]
        self._acc_np = DType.parse(qname).np
        self._average_size = 512
        self._cascade_size = 2
        self._reset()

    def set_average_size(self, num: int):
        if num == 0:
            raise ValueError("average size cannot be zero")
        self._average_size = int(num)
        self._reset()

    def get_average_size(self) -> int:
        return self._average_size

    def set_cascade_size(self, num: int):
        if num == 0:
            raise ValueError("cascade size cannot be zero")
        self._cascade_size = int(num)
        self._reset()

    def get_cascade_size(self) -> int:
        return self._cascade_size

    def _reset(self):
        self._bump_fuse_epoch()
        d, c = self._average_size, self._cascade_size
        shape = (c, d, 2) if self.dtype.is_complex_int else (c, d)
        base = self._acc_np if not (self.dtype.is_complex
                                    and self.dtype.is_float) \
            else self.dtype.np
        self._hists = np.zeros(shape, base)

    def activate(self):
        self._reset()

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        is_int = self.dtype.is_integer
        x = buf.astype(self._acc_np) if is_int else buf
        # float32 streams compute on the topology's device, the rest on
        # the host
        dev = (self.device if self.dtype.is_float and self.dtype.bits == 32
               else torch.device("cpu"))
        y, hists = fops.dc_removal(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev),
            torch.from_numpy(self._hists).to(dev),
            self._average_size, self._cascade_size, is_int)
        self._hists = hists.cpu().numpy()
        y = y.cpu().numpy()
        out = y.astype(self.dtype.scalar.np if self.dtype.is_complex_int
                       else self.dtype.np)
        port.consume(n)
        self.output(0).post(out)

    def device_core(self, channels: int, device=None):
        """Fused-chain core: moving-average cascade + delayed-input
        subtraction (float32, cumsum formulation, the prefix sums in
        float64: ``ops/filter.window_sum``) on ``device`` (default: the
        block's); carry = per-stage history [cascade, C, D(, 2)]."""
        d, casc = self._average_size, self._cascade_size
        shape = (casc, channels, d, 2) if self.dtype.is_complex \
            else (casc, channels, d)
        dev = self.device if device is None else torch.device(device)
        carry0 = torch.zeros(shape, dtype=torch.float32, device=dev)

        def step(carry, x):
            cur = x
            hists = []
            delayed = None
            for s in range(casc):
                ext = torch.cat([carry[s], cur], dim=1)
                avg = fops.window_sum(ext, d, dim=1) / d
                hists.append(ext[:, -d:])
                if s == 0:
                    delayed = ext[:, 1:1 + x.shape[1]]
                cur = avg
            return torch.stack(hists), delayed - cur

        return carry0, step

    # -- auto-fusion protocol (core/fusion.py) -------------------------- #
    def fuse_ready(self) -> bool:
        return self.dtype.is_float and self.dtype.bits == 32

    def fuse_export(self, channels: int):
        carry0, step = self.device_core(channels)
        h = self._hists  # [casc, d] complex64 or float32
        if self.dtype.is_complex:
            h = np.stack([h.real, h.imag], -1)
        carry = torch.from_numpy(h.astype(np.float32))[:, None]
        return carry.to(self.device), step

    def fuse_import(self, carry) -> None:
        c = carry.cpu().numpy()
        if self.dtype.is_complex:
            self._hists = (c[:, 0, :, 0]
                           + 1j * c[:, 0, :, 1]).astype(self.dtype.np)
        else:
            self._hists = c[:, 0].astype(self._hists.dtype)


# ---------------------------------------------------------------------- #
# /comms/envelope_detector (reference: filter/EnvelopeDetector.cpp)
# ---------------------------------------------------------------------- #
# Samples per row of the fused core's blocked follower (E1 steps W rounded
# up to a block, plus the block, per row). The JAX block takes 8192, a
# choice timed on its TPU; this one is the fastest of 1024, 2048 and 8192
# for the FM chain's step on an H100 (benches_torch/probe_fm_step.py).
ENVELOPE_BLOCK = 1024


@register_block("/comms/envelope_detector", "/blocks/envelope_detector")
class EnvelopeDetector(Block):
    """Attack/release envelope follower; any real/complex input, float
    output; lookahead delay via retained input samples. The follower runs
    on the topology's device: the E1 kernel on CUDA."""

    DOC = {
        "category": "/Filter",
        "keywords": ["envelope", "detector", "attack", "release", "agc"],
        "params": {
            "attack": {"label": "Attack", "default": 10.0,
                       "units": "samples",
                       "desc": "Attack time constant (gain e^{-1/attack})."},
            "release": {"label": "Release", "default": 10.0,
                        "units": "samples"},
            "lookahead": {"label": "Lookahead", "default": 0,
                          "units": "samples"},
        },
    }

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.out_dtype = DType.parse("float32")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.out_dtype)
        self._envelope = 0.0
        self._lookahead = 0
        self.set_attack(10.0)
        self.set_release(10.0)

    def set_attack(self, attack: float):
        self._attack = float(attack)
        self._attack_gain = float(np.exp(-1.0 / attack))
        self._bump_fuse_epoch()

    def get_attack(self) -> float:
        return self._attack

    def set_release(self, release: float):
        self._release = float(release)
        self._release_gain = float(np.exp(-1.0 / release))
        self._bump_fuse_epoch()

    def get_release(self) -> float:
        return self._release

    def set_lookahead(self, lookahead: int):
        self._lookahead = int(lookahead)
        self._bump_fuse_epoch()

    def get_lookahead(self) -> int:
        return self._lookahead

    def _gains(self):
        # float32, as the JAX block hands them to its scans
        return np.float32(self._attack_gain), np.float32(self._release_gain)

    def activate(self):
        self._envelope = 0.0

    def work(self):
        port = self.input(0)
        if port.elements() <= self._lookahead:
            port.set_reserve(self._lookahead + 1)
            return
        port.set_reserve(0)
        n = port.elements() - self._lookahead
        buf = np.asarray(port.buffer(port.elements()))[self._lookahead:]
        # |x| per dtype (reference FxptHelpers getAbs)
        if self.dtype.is_complex_int:
            mag2 = (buf[..., 0].astype(np.float64) ** 2
                    + buf[..., 1].astype(np.float64) ** 2)
            xabs = np.sqrt(mag2).astype(np.float32)
        elif self.dtype.is_complex:
            xabs = np.abs(buf).astype(np.float32)
        else:
            xabs = np.abs(buf.astype(np.float32))
        y, env = fops.envelope_scan(
            torch.from_numpy(np.ascontiguousarray(xabs)).to(self.device),
            np.float32(self._envelope), *self._gains())
        self._envelope = float(env)
        port.consume(n)
        self.output(0).post(y.cpu().numpy())

    def device_core(self, channels: int, device=None):
        """Fused-chain core: attack/release follower over [C, T(, 2)] on
        ``device`` (default: the block's), a scan over time with a [C]
        envelope carry. (Lookahead is a stream-windowing feature of the
        block runtime; the fused core requires lookahead == 0.)"""
        if self._lookahead != 0:
            raise TypeError("fused envelope core requires lookahead == 0")
        ga, gr = self._gains()
        dev = self.device if device is None else torch.device(device)
        carry0 = torch.zeros((channels,), dtype=torch.float32, device=dev)
        # blocked-parallel path: the follower is contractive, so blocks
        # warm-started W samples early are exact to f32 resolution
        # (ops/filter.envelope_blocked); W is static per taps-epoch.
        W = fops.envelope_warmup(self._attack, self._release)
        BLK = ENVELOPE_BLOCK

        def step(carry, x):
            if x.dim() == 3:  # planar complex -> magnitude
                mag = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
            else:
                mag = torch.abs(x)
            t = mag.shape[1]
            # the JAX package's rule: the blocked form pays W+L steps per
            # row, worth it only when t spans at least 4 blocks
            if t % BLK == 0 and t >= 4 * BLK and W <= 2 * BLK:
                y, env_f = fops.envelope_blocked(mag, carry, ga, gr, BLK, W)
            else:
                y, env_f = fops.envelope_scan(mag, carry, ga, gr)
            return env_f, y

        return carry0, step

    # -- auto-fusion protocol (core/fusion.py) -------------------------- #
    def fuse_ready(self) -> bool:
        return (self._lookahead == 0
                and self.dtype.is_float and self.dtype.bits == 32)

    def fuse_export(self, channels: int):
        _, step = self.device_core(channels)
        carry = torch.full((channels,), np.float32(self._envelope),
                           dtype=torch.float32, device=self.device)
        return carry, step

    def fuse_import(self, carry) -> None:
        self._envelope = float(carry[0])
