"""Filter blocks (reference: filter/ module, SURVEY.md §2.3); the port of
the JAX package's ``blocks/filter.py``: /comms/fir_filter,
/comms/iir_filter, /comms/dc_removal, /comms/envelope_detector and the
event-only designers /comms/fir_designer and /comms/iir_designer.

Where the FIR runs: a complex_float32 stream streams on the topology's
device (planar float32, as the JAX package does on its chip); every
other dtype streams on the host. Fused, a 1:1 FIR is the block-Toeplitz
matmul core (K1 on CUDA), or half of the FIR -> FFT pair operator; a
rational FIR (decimation or interpolation above 1) is the blocked
rational operator (``ops/filter.rational_fir_mm``, one K1 product a
quantum), its carry the K-1 input history plus any sub-M input-phase
residue. The IIR filter streams on the host in float64 / complex128 and
fuses as the I1 kernel on a card (``kernels/iir_df2t.py``), elsewhere as
the blocked state-space core (``ops/filter.iir_blocked_step``).
"""

from __future__ import annotations

import numpy as np
import torch

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.qformat import Q_ACCUMULATOR
from pothoscomms_tpu_torch.core.registry import register_block
from pothoscomms_tpu_torch.design import (
    design_complex_fir,
    design_fir,
    design_iir,
    design_window,
    remez_estimate_atten,
    remez_estimate_bw,
    remez_estimate_num_taps,
    remez_estimate_weight,
)
from pothoscomms_tpu_torch.kernels.iir_df2t import engages as i1_engages
from pothoscomms_tpu_torch.kernels.iir_df2t import iir_df2t
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
        on CUDA); carry = K-1 history samples per channel. Rational rates
        take the blocked rational operator (:meth:`_rational_device_core`);
        their quanta must be multiples of ``fuse_granule()``."""
        from pothoscomms_tpu_torch.parallel.chain import (
            fir_multichannel_mm, fir_toeplitz_matrices)

        dev = self.device if device is None else torch.device(device)
        if self._M != 1 or self._L != 1:
            return self._rational_device_core(channels, dev)
        if len(self._taps) > 128:
            raise TypeError("fused FIR core requires <= 128 taps")
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

    def _rational_device_core(self, channels: int, dev: torch.device):
        """Rational (L/M) resampling as the blocked-Toeplitz product
        (ops/filter.rational_fir_mm: one K1 launch a quantum); carry = K-1
        polyphase INPUT history samples PLUS any sub-M input-phase residue
        r (an interior rational FIR retains K-1+r on the streaming path;
        the residue rides the carry so the segment engages at ANY phase,
        not just r == 0). Quanta must be multiples of fuse_granule(), so
        r stays constant across quanta."""
        t0, t1, b_in, b_out = fops.rational_fir_operators(
            self._taps, self._M, self._L)
        gr, gi = (g.to(dev) for g in fops.stack_rational_operators(t0, t1))
        k1 = max(self._K - 1, 1)
        M = self._M

        def core(carry, xp):
            # carry [C, k1 + r, 2]: history then residue (oldest first)
            hist = carry[:, :k1]
            if carry.shape[1] > k1:
                xp = torch.cat([carry[:, k1:], xp], dim=1)
            n = (xp.shape[1] // M) * M
            y, hist2 = fops.rational_fir_mm(xp[:, :n], hist, gr, gi, b_in,
                                            b_out)
            return torch.cat([hist2, xp[:, n:]], dim=1), y

        if self.dtype.is_complex:
            carry0 = torch.zeros((channels, k1, 2), device=dev)
            step = core
        else:
            carry0 = torch.zeros((channels, k1), device=dev)

            def step(carry, x):
                xp = torch.stack([x, torch.zeros_like(x)], dim=-1)
                hp = torch.stack([carry, torch.zeros_like(carry)], dim=-1)
                c2, y = core(hp, xp)
                return c2[..., 0], y[..., 0]

        return carry0, step

    # -- auto-fusion protocol (core/fusion.py) -------------------------- #
    fuse_kind = "fir"

    def fuse_retained(self) -> int:
        # an interior rational FIR retains K-1 history PLUS an input-
        # phase residue r in [0, M); the export absorbs both, so the
        # retention check accepts the whole steady-state holding
        if self._M > 1 or self._L > 1:
            k1 = self._K - 1
            avail = self.input(0).elements()
            if k1 <= avail < k1 + self._M:
                return avail
        return self._K - 1

    def fuse_granule(self) -> int:
        # rational cores consume whole b_in blocks (128*M samples); the
        # 1:1 matmul core pads to its 128-sample Toeplitz blocks
        # internally (exact: the convolution is causal), so it imposes
        # no granule
        return 128 * self._M if (self._M != 1 or self._L != 1) else 1

    def fuse_ratio(self):
        """(out, in) sample-count ratio of the fused core."""
        return (self._L, self._M)

    def fuse_ready(self) -> bool:
        if self._M != 1 or self._L != 1:
            # rational path: history is K-1 INPUT samples; complex and
            # real taps both run in planar f32. K >= 2 so the carry is
            # non-degenerate (K == 1 streams on the host).
            return (not self._wait_armed and self._K >= 2
                    and self._eob_samps_left == 0
                    and self.dtype.is_float and self.dtype.bits == 32
                    and self.input(0).elements() >= self._K - 1)
        return (not self._wait_armed
                and len(self._taps) <= 128
                and self._eob_samps_left == 0
                and self.dtype.is_float and self.dtype.bits == 32
                and (self.input(0).elements() >= self._K - 1
                     or self.fuse_cold_start()))

    def fuse_cold_start(self) -> bool:
        """True when this FIR may engage with an EMPTY input port (no K-1
        retention yet): the fused core starts from a zero-length carry and
        takes the first K-1 samples of its first quantum as history —
        exactly the streaming semantics, where the first K-1 inputs
        produce nothing (reference FIRFilter.cpp:305). A freshly committed
        source-headed chain then engages on round one instead of paying a
        streaming round through every member first."""
        return (self._M == 1 and self._L == 1
                and self.input(0).elements() == 0)

    def fuse_export(self, channels: int):
        """Streaming state -> device carry: the K-1 history samples are
        the first K-1 queued elements (reference FIRFilter.cpp:305 keeps
        them unconsumed); consume them into the fused carry. An interior
        rational FIR also hands over its sub-M input-phase residue. With
        an empty port (cold start) the carry starts zero-length and the
        first quantum's leading K-1 samples become the history."""
        from pothoscomms_tpu_torch.core.fusion import to_planar

        carry0, step = self.device_core(channels)
        k1 = self._K - 1
        if k1 == 0:
            return carry0, step
        if self.fuse_cold_start():
            def cold_step(carry, x):
                # a zero-length carry marks the over-pulled FIRST quantum
                # (q + K-1, see FusedSegment.try_engage): its leading K-1
                # samples ARE the history, leaving a q-sample body (copied
                # once, so the K1 operand starts on a 16-byte boundary)
                if carry.shape[1] == k1:
                    return step(carry, x)
                return step(x[:, :k1], x[:, k1:].clone())

            return carry0[:, :0], cold_step
        take = k1
        if self._M > 1 or self._L > 1:
            avail = self.input(0).elements()
            if k1 <= avail < k1 + self._M:
                take = avail
        parts = [to_planar(p, self.dtype, self.device)
                 for p in self.input(0).take(take)]
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
# /comms/iir_filter (reference: filter/IIRFilter.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/iir_filter", "/blocks/iir_filter")
class IIRFilter(Block):
    """Direct-form II transposed IIR filter; taps are the [b...; a...]
    halves. Streaming runs on the host in float64 / complex128 (spuce
    parity); the fused core is I1 on a card, the blocked state-space form
    elsewhere."""

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if self.dtype.kind == "uint":
            raise ValueError("unsupported dtype")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._wait_taps = False
        self._wait_armed = False
        self.set_taps([0.0676, 0.135, 0.0676, 1, -1.142, 0.412])

    def set_taps(self, taps):
        taps = np.asarray(taps, np.float64)
        if taps.size == 0:
            raise ValueError("order cannot be 0")
        # [b...; a...] halves (reference filter/IIRFilter.cpp:29-36)
        half = taps.size // 2
        self._b = taps[:half]
        self._a = taps[half:]
        if self._a.size == 0 or self._a[0] == 0:
            raise ValueError("feedback taps must start with a nonzero a0")
        self._wait_armed = False
        self._bump_fuse_epoch()
        self.reset()

    def get_taps(self):
        return np.concatenate([self._b, self._a])

    def set_wait_taps(self, wait: bool):
        self._wait_taps = bool(wait)

    def get_wait_taps(self) -> bool:
        return self._wait_taps

    def reset(self):
        order = max(self._b.size, self._a.size) - 1
        sdt = np.complex128 if self.dtype.is_complex else np.float64
        self._state = np.zeros(max(order, 1), sdt)

    def activate(self):
        self.reset()
        self._wait_armed = self._wait_taps

    def work(self):
        if self._wait_armed:
            return
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        if self.dtype.is_complex_int:
            x = buf[..., 0].astype(np.float64) \
                + 1j * buf[..., 1].astype(np.float64)
        else:
            x = buf
        # iir_df computes in float64 / complex128 on the host
        y, z = fops.iir_df(x, self._b / self._a[0], self._a / self._a[0],
                           self._state)
        self._state = z.numpy()
        y = y.numpy()
        if self.dtype.is_complex_int:
            out = np.stack([np.trunc(y.real), np.trunc(y.imag)],
                           axis=-1).astype(self.dtype.scalar.np)
        elif self.dtype.is_integer:
            out = np.trunc(y.real).astype(self.dtype.np)
        else:
            out = y.astype(self.dtype.np)
        port.consume(n)
        self.output(0).post(out)

    # steps of every fused core that took the per-sample fallback
    fallback_steps = 0

    def device_core(self, channels: int, device=None):
        """Fused-chain core on ``device`` (default: the block's). On a card
        a step runs the I1 kernel (kernels/iir_df2t.py: the DF-II-T
        recurrence over the interleaved samples in one launch) where
        ``iir_df2t.engages`` holds (its ``fits`` at the order and the
        step's T; tables finite in float32, on which the kernel does not
        stray: ``iir_df2t.stray``). Elsewhere, on the CPU too, and for
        taps I1 refuses, the blocked state-space IIR over planar float32
        (ops/filter.py
        iir_blocked_operators / iir_blocked_step: block products and a
        log-depth scan over T/L block states; an exact reformulation of
        DF-II-T); it falls back to a per-sample scan when no block length
        divides the quantum or the float32 operators are not finite (an
        unstable filter): that is a Python loop of T steps, slow on a
        card. ``IIRFilter.fallback_steps`` counts the steps that take
        it."""
        bq = self._b / self._a[0]
        aq = self._a / self._a[0]
        order = max(self._b.size, self._a.size, 2) - 1
        dev = self.device if device is None else torch.device(device)
        bp = torch.zeros(order + 1)
        ap = torch.zeros(order + 1)
        bp[: bq.size] = torch.from_numpy(bq.astype(np.float32))
        ap[: aq.size] = torch.from_numpy(aq.astype(np.float32))
        # I1's taps in float64 (its recurrence runs their float32 values)
        bd, ad = np.zeros(order + 1), np.zeros(order + 1)
        bd[: bq.size], ad[: aq.size] = bq, aq
        bp, ap = bp.to(dev), ap.to(dev)
        is_cplx = self.dtype.is_complex
        shape = (order, channels, 2) if is_cplx else (order, channels)
        carry0 = torch.zeros(shape, dtype=torch.float32, device=dev)
        ops_cache: dict = {}

        def get_ops(L):
            """The blocked form's float32 operators for L on the device,
            or None (not finite: fall back to the per-sample scan)."""
            if L not in ops_cache:
                ops32 = fops.iir_blocked_operators32(bq, aq, L)
                ops_cache[L] = None if ops32 is None else tuple(
                    torch.from_numpy(m).to(dev) for m in ops32)
            return ops_cache[L]

        def step(carry, x):
            # I1 takes rows [R, T, W]: a real row is one plane
            xs, zs = (x, carry) if is_cplx else (x[..., None],
                                                 carry[..., None])
            if i1_engages(xs, bd, ad):
                y, z = iir_df2t(xs.contiguous(), zs.contiguous(), bd, ad)
                return (z, y) if is_cplx else (z[..., 0], y[..., 0])
            L = fops.iir_block_length(x.shape[1])
            ops = get_ops(L) if L is not None else None
            if ops is None:
                IIRFilter.fallback_steps += 1
                y, z = fops.iir_df_rows(x, carry, bp, ap)
                return z, y
            y, z = fops.iir_blocked_rows(x, carry, ops, L)
            return z, y

        return carry0, step

    # -- auto-fusion protocol (core/fusion.py): the streaming path keeps
    # the DF-II-transposed state in f64 (spuce parity); the fused core
    # carries the same layout in f32.
    def fuse_ready(self) -> bool:
        return (not self._wait_armed
                and self.dtype.is_float and self.dtype.bits == 32)

    def fuse_export(self, channels: int):
        carry0, step = self.device_core(channels)
        z = self._state
        if self.dtype.is_complex:
            carry = np.stack([z.real, z.imag], -1)[:, None, :]
        else:
            carry = z.real[:, None]
        return torch.from_numpy(carry.astype(np.float32)).to(self.device), \
            step

    def fuse_import(self, carry) -> None:
        c = carry.cpu().numpy()
        if self.dtype.is_complex:
            self._state = (c[:, 0, 0] + 1j * c[:, 0, 1]).astype(np.complex128)
        else:
            self._state = c[:, 0].astype(np.float64)


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
        subtraction (``ops/filter.dc_removal_rows``: float32, cumsum
        formulation, the prefix sums in float64) on ``device`` (default:
        the block's); carry = per-stage history [cascade, C, D(, 2)]."""
        d, casc = self._average_size, self._cascade_size
        shape = (casc, channels, d, 2) if self.dtype.is_complex \
            else (casc, channels, d)
        dev = self.device if device is None else torch.device(device)
        carry0 = torch.zeros(shape, dtype=torch.float32, device=dev)

        def step(carry, x):
            y, hists = fops.dc_removal_rows(x, carry, d, casc)
            return hists, y

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


# ---------------------------------------------------------------------- #
# /comms/fir_designer — event-only taps designer
# (reference: filter/FIRDesigner.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/fir_designer", "/blocks/fir_designer")
class FIRDesigner(Block):
    # Docs-plane schema: field parity with the reference's |PothosDoc
    # header (filter/FIRDesigner.cpp:20-137) — labels, option enums,
    # defaults, units, widget and preview rules, for the docs plane
    # (core/introspect.py).
    DOC = {
        "category": "/Filter",
        "keywords": ["fir", "filter", "taps", "highpass", "lowpass",
                     "bandpass", "remez"],
        "params": {
            "filter_type": {
                "label": "Filter Type",
                "desc": "The type of filter taps to generate.",
                "options": [
                    {"label": "Root Raised Cosine",
                     "value": "ROOT_RAISED_COSINE"},
                    {"label": "Raised Cosine", "value": "RAISED_COSINE"},
                    {"label": "Box-Car", "value": "SINC"},
                    {"label": "Maxflat", "value": "MAXFLAT"},
                    {"label": "Gaussian", "value": "GAUSSIAN"},
                    {"label": "Remez", "value": "REMEZ"},
                ],
                "default": "SINC",
            },
            "band_type": {
                "label": "Band Type",
                "desc": "The band type of filter",
                "options": [
                    {"label": "Low Pass", "value": "LOW_PASS"},
                    {"label": "High Pass", "value": "HIGH_PASS"},
                    {"label": "Band Pass", "value": "BAND_PASS"},
                    {"label": "Band Stop", "value": "BAND_STOP"},
                    {"label": "Complex Band Pass",
                     "value": "COMPLEX_BAND_PASS"},
                    {"label": "Complex Band Stop",
                     "value": "COMPLEX_BAND_STOP"},
                ],
            },
            "window_type": {
                "label": "Window Type",
                "desc": "The window function controls passband ripple.",
                "default": "hann",
                "options": [
                    {"label": "Rectangular", "value": "rectangular"},
                    {"label": "Hann", "value": "hann"},
                    {"label": "Hamming", "value": "hamming"},
                    {"label": "Blackman", "value": "blackman"},
                    {"label": "Bartlett", "value": "bartlett"},
                    {"label": "Flat-top", "value": "flattop"},
                    {"label": "Kaiser", "value": "kaiser"},
                    {"label": "Chebyshev", "value": "chebyshev"},
                ],
                "tab": "Window",
            },
            "window_args": {
                "label": "Window Args",
                "desc": "Optional window arguments (Kaiser: [beta]; "
                        "Chebyshev: [atten dB]).",
                "default": [],
                "preview": "valid",
                "tab": "Window",
            },
            "gain": {"label": "Gain", "desc": "The filter gain.",
                     "default": 1.0},
            "sample_rate": {
                "label": "Sample Rate",
                "desc": "The sample rate, in samples per second.",
                "default": 1e6, "units": "Sps",
            },
            "frequency_lower": {
                "label": "Lower Freq",
                "desc": "The lower transition frequency.",
                "default": 1000, "units": "Hz",
            },
            "frequency_upper": {
                "label": "Upper Freq",
                "desc": "The upper transition frequency (band filters).",
                "default": 2000, "units": "Hz",
                "preview": 'when(enum=band_type, "BAND_PASS", "BAND_STOP",'
                           ' "COMPLEX_BAND_PASS", "COMPLEX_BAND_STOP")',
            },
            "bandwidth_trans": {
                "label": "Transition Width",
                "desc": "The transition bandwidth for Remez filters.",
                "default": 1000, "units": "Hz",
                "preview": 'when(enum=filter_type, "REMEZ")',
                "tab": "Remez",
            },
            "num_taps": {
                "label": "Num Taps",
                "desc": "The number of filter taps.",
                "default": 51, "widget": "SpinBox(minimum=1)",
            },
            "alpha": {
                "label": "Alpha",
                "desc": "Excess bandwidth factor for (root-)raised "
                        "cosine, 0.0 to 1.0.",
                "default": 0.5,
                "preview": 'when(enum=filter_type, "RAISED_COSINE", '
                           '"ROOT_RAISED_COSINE")',
                "tab": "Cosine",
            },
            "stop_db": {
                "label": "Attenuation",
                "desc": "Desired Remez stopband attenuation.",
                "default": 60.0, "units": "dB",
                "preview": 'when(enum=filter_type, "REMEZ")',
                "tab": "Remez",
            },
            "pass_db": {
                "label": "Passband Ripple",
                "desc": "Desired Remez passband ripple.",
                "default": 0.1, "units": "dB",
                "preview": 'when(enum=filter_type, "REMEZ")',
                "tab": "Remez",
            },
        },
    }

    def __init__(self):
        super().__init__()
        self._filter_type = "GAUSSIAN"
        self._band_type = "LOW_PASS"
        self._window_type = "hann"
        self._window_args = []
        self._gain = 1.0
        self._samp_rate = 1.0
        self._freq_lower = 0.1
        self._freq_upper = 0.2
        self._trans_bw = 0.1
        self._alpha = 0.5
        self._weight = 1.0
        self._stop_db = 60.0
        self._pass_db = 0.1
        self._num_taps = 51
        self.register_signal("tapsChanged")

    # -- setters (each triggers recalculation, reference :193-360) -------- #
    def set_filter_type(self, ftype: str):
        bands = ("LOW_PASS", "HIGH_PASS", "BAND_PASS", "BAND_STOP",
                 "COMPLEX_BAND_PASS", "COMPLEX_BAND_STOP")
        if ftype in bands:
            # backwards-compat remap (reference :195-212)
            self._filter_type = "SINC"
            self._band_type = ftype
        else:
            self._filter_type = ftype
        self.recalculate()

    def filter_type(self) -> str:
        return self._filter_type

    def set_band_type(self, btype: str):
        self._band_type = btype
        self.recalculate()

    def band_type(self) -> str:
        return self._band_type

    def set_window_type(self, wtype: str):
        self._window_type = wtype
        self.recalculate()

    def window_type(self) -> str:
        return self._window_type

    def set_window_args(self, args):
        self._window_args = list(args)
        self.recalculate()

    def window_args(self):
        return self._window_args

    def set_sample_rate(self, rate: float):
        self._samp_rate = float(rate)
        self.recalculate()

    def sample_rate(self) -> float:
        return self._samp_rate

    def set_frequencies(self, freqs):
        if len(freqs) > 0:
            self._freq_lower = float(freqs[0])
        if len(freqs) > 1:
            self._freq_upper = float(freqs[1])
        self.recalculate()

    def set_frequency_lower(self, freq: float):
        self._freq_lower = float(freq)
        self.recalculate()

    def frequency_lower(self) -> float:
        return self._freq_lower

    def set_frequency_upper(self, freq: float):
        self._freq_upper = float(freq)
        self.recalculate()

    def frequency_upper(self) -> float:
        return self._freq_upper

    def set_bandwidth_trans(self, freq: float):
        self._trans_bw = float(freq)
        self.recalculate()

    def bandwidth_trans(self) -> float:
        return self._trans_bw

    def set_num_taps(self, num: int):
        self._num_taps = int(num)
        self.recalculate()

    def num_taps(self) -> int:
        return self._num_taps

    def set_alpha(self, alpha: float):
        self._alpha = float(alpha)
        self.recalculate()

    def alpha(self) -> float:
        return self._alpha

    def set_pass_db(self, db: float):
        self._pass_db = float(db)
        self.recalculate()

    def pass_db(self) -> float:
        return self._pass_db

    def set_stop_db(self, db: float):
        self._stop_db = float(db)
        self.recalculate()

    def stop_db(self) -> float:
        return self._stop_db

    def set_gain(self, gain: float):
        self._gain = float(gain)
        self.recalculate()

    def gain(self) -> float:
        return self._gain

    def activate(self):
        self.recalculate()

    def recalculate(self):
        """Validate, design, window, and emit (reference :387-477)."""
        if not self.is_active():
            return
        is_complex = "COMPLEX" in self._band_type
        is_stop = "STOP" in self._band_type

        if self._num_taps == 0:
            raise ValueError("num taps must be positive")
        if self._samp_rate <= 0:
            raise ValueError("sample rate must be positive")
        if is_complex and self._freq_lower <= -self._samp_rate / 2:
            raise ValueError("lower frequency below Nyquist range")
        if not is_complex and self._freq_lower <= 0:
            raise ValueError("lower frequency must be positive")
        if self._freq_lower >= self._samp_rate / 2:
            raise ValueError("lower frequency above Nyquist range")

        if self._band_type in ("BAND_PASS", "BAND_STOP",
                               "COMPLEX_BAND_PASS", "COMPLEX_BAND_STOP"):
            if self._num_taps % 2 == 0:
                raise ValueError(
                    "Band pass or Band stop FIRs must have an odd number of taps"
                )
            if is_complex and self._freq_upper <= -self._samp_rate / 2:
                raise ValueError("upper frequency below Nyquist range")
            if not is_complex and self._freq_upper <= 0:
                raise ValueError("upper frequency must be positive")
            if self._freq_upper >= self._samp_rate / 2:
                raise ValueError("upper frequency above Nyquist range")
            if self._freq_upper <= self._freq_lower:
                raise ValueError("upper frequency <= lower frequency")

        alpha, weight = self._alpha, self._weight
        if self._filter_type == "MAXFLAT" and is_stop:
            raise ValueError(
                "Can not use MAXFLAT as prototype for stop-band filter"
            )
        if self._filter_type == "REMEZ":
            if self._trans_bw <= 0:
                raise ValueError("Transition Bandwidth must be > 0")
            if self._pass_db <= 0:
                raise ValueError("Passband Attenuation must be > 0")
            if self._stop_db <= 0:
                raise ValueError("Stopband Attenuation must be > 0")
            alpha = self._alpha = self._trans_bw / self._samp_rate
            est = remez_estimate_num_taps(alpha, self._pass_db, self._stop_db)
            if est > self._num_taps:
                import logging
                logging.getLogger("FIRDesigner.Remez").warning(
                    "Remez order not large enough to meet specification: "
                    "either increase filter order to %d taps, decrease "
                    "stopband attenuation to %.1f dB, or increase transition "
                    "bandwidth to %.3f kHz",
                    est,
                    remez_estimate_atten(self._num_taps, alpha, self._pass_db),
                    remez_estimate_bw(self._num_taps, self._pass_db,
                                      self._stop_db) * self._samp_rate / 1e3,
                )
            weight = self._weight = remez_estimate_weight(
                self._pass_db, self._stop_db
            )

        fl = self._freq_lower / self._samp_rate
        fu = self._freq_upper / self._samp_rate
        if is_complex:
            taps = design_complex_fir(
                self._filter_type, self._band_type, self._num_taps,
                fl, fu, alpha, weight,
            )
        else:
            taps = design_fir(
                self._filter_type, self._band_type, self._num_taps,
                fl, fu, alpha, weight,
            )
        taps = taps * self._gain
        window = design_window(
            self._window_type, self._num_taps,
            self._window_args[0] if self._window_args else 0.0,
        )
        taps = taps * window
        self.emit_signal("tapsChanged", taps)


# ---------------------------------------------------------------------- #
# /comms/iir_designer (reference: filter/IIRDesigner.cpp)
# ---------------------------------------------------------------------- #
@register_block("/comms/iir_designer")
class IIRDesigner(Block):
    DOC = {
        "category": "/Filter",
        "keywords": ["iir", "filter", "taps", "butterworth", "elliptic"],
        "params": {
            "iir_type": {
                "label": "IIR Type",
                "options": [
                    {"label": "Butterworth", "value": "butterworth"},
                    {"label": "Chebyshev I", "value": "chebyshev"},
                    {"label": "Chebyshev II", "value": "chebyshev2"},
                    {"label": "Elliptic", "value": "elliptic"},
                ],
                "default": "butterworth",
            },
            "filter_type": {
                "label": "Band Type",
                "options": [
                    {"label": "Low Pass", "value": "LOW_PASS"},
                    {"label": "High Pass", "value": "HIGH_PASS"},
                    {"label": "Band Pass", "value": "BAND_PASS"},
                    {"label": "Band Stop", "value": "BAND_STOP"},
                ],
                "default": "LOW_PASS",
            },
            "sample_rate": {"label": "Sample Rate", "units": "Sps",
                            "default": 1.0},
            "frequency_lower": {"label": "Lower Freq", "units": "Hz",
                                "default": 0.1},
            "frequency_upper": {"label": "Upper Freq", "units": "Hz",
                                "default": 0.2},
            "order": {"label": "Order", "default": 2,
                      "widget": "SpinBox(minimum=1)"},
            "stop_atten": {"label": "Stop Attenuation", "units": "dB",
                           "default": 60.0},
            "ripple": {"label": "Passband Ripple", "units": "dB",
                       "default": 0.1},
        },
    }

    def __init__(self):
        super().__init__()
        self._filter_type = "LOW_PASS"
        self._iir_type = "butterworth"
        self._samp_rate = 1.0
        self._freq_lower = 0.1
        self._freq_upper = 0.2
        self._stop_atten = 60.0
        self._ripple = 0.1
        self._order = 2
        self.register_signal("tapsChanged")

    def set_filter_type(self, t: str):
        self._filter_type = t
        self.recalculate()

    def filter_type(self) -> str:
        return self._filter_type

    def set_iir_type(self, t: str):
        self._iir_type = t
        self.recalculate()

    def iir_type(self) -> str:
        return self._iir_type

    # reference exposes setIIRType/IIRType camel names
    setIIRType = set_iir_type

    def IIRType(self) -> str:
        return self._iir_type

    def set_sample_rate(self, rate: float):
        self._samp_rate = float(rate)
        self.recalculate()

    def sample_rate(self) -> float:
        return self._samp_rate

    def set_frequency_lower(self, f: float):
        self._freq_lower = float(f)
        self.recalculate()

    def frequency_lower(self) -> float:
        return self._freq_lower

    def set_frequency_upper(self, f: float):
        self._freq_upper = float(f)
        self.recalculate()

    def frequency_upper(self) -> float:
        return self._freq_upper

    def set_order(self, n: int):
        self._order = int(n)
        self.recalculate()

    def order(self) -> int:
        return self._order

    def set_ripple(self, r: float):
        self._ripple = float(r)
        self.recalculate()

    def ripple(self) -> float:
        return self._ripple

    def set_stop_band_atten(self, db: float):
        self._stop_atten = float(db)
        self.recalculate()

    def stop_band_atten(self) -> float:
        return self._stop_atten

    def activate(self):
        self.recalculate()

    def recalculate(self):
        if not self.is_active():
            return
        if self._order == 0:
            raise ValueError("order must be positive")
        if self._samp_rate <= 0:
            raise ValueError("sample rate must be positive")
        if self._freq_lower <= 0:
            raise ValueError("lower frequency must be positive")
        if self._freq_lower >= self._samp_rate / 2:
            raise ValueError("lower frequency Nyquist fail")
        center = 0.25
        if self._filter_type in ("BAND_PASS", "BAND_STOP"):
            if self._freq_upper <= 0:
                raise ValueError("upper frequency must be positive")
            if self._freq_upper >= self._samp_rate / 2:
                raise ValueError("upper frequency Nyquist fail")
            if self._freq_upper <= self._freq_lower:
                raise ValueError("upper frequency <= lower frequency")
            bw = 0.5 * (self._freq_upper - self._freq_lower) / self._samp_rate
            center = 0.5 * (self._freq_upper + self._freq_lower) / self._samp_rate
            if bw < 0.001:
                raise ValueError("bandpass bandwidth too small < 0.001")
        else:
            bw = self._freq_lower / self._samp_rate

        b, a = design_iir(
            self._iir_type, self._filter_type, self._order, bw,
            self._ripple, self._stop_atten, center,
        )
        # [b...; a...] concatenated (reference filter/IIRDesigner.cpp:217-223)
        self.emit_signal("tapsChanged", np.concatenate([b, a]))
