"""FFT block (reference: fft/ module, SURVEY.md §2.2); the port of the JAX
package's ``blocks/fft.py``.

Scaling contract (from the reference's kissfft configuration and tests):

- complex float forward: plain DFT, numpy semantics (fft/TestFFT.cpp:13-29).
- complex float inverse: UNnormalized — round-trip gains a factor of N
  (fft/TestFFT.cpp:79-80 checks ifft(fft(x)) == x*N), matching kissfft.
- complex int16 (FIXED_POINT=16 kiss_fft, fft/CMakeLists.txt:14-20):
  forward output is scaled by 1/N (fft/TestFFT.cpp:128-133); inverse is the
  exactly-normalized inverse DFT (TestFFT.cpp:152-156: ifft(N*scaled) == x).

All complete numBins windows queued on the input are batched into one
[k, numBins] transform instead of the reference's one transform per work
(fft/FFT.cpp:61-72). Where each dtype runs:

- complex_float32: on the topology's device through ``fft_planar`` (the
  K2 kernel on CUDA);
- complex_float64: on the host, in float64;
- complex_int16: on the host in complex64, rounded on output (far more
  precise than 16-bit kiss_fft butterflies), in the streaming and the
  fused path alike, so both give the same integers.
"""

from __future__ import annotations

import numpy as np
import torch

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.registry import register_block
from pothoscomms_tpu_torch.parallel.fft import fft_planar


def _fft_int16(x_ri: torch.Tensor, inverse: bool) -> torch.Tensor:
    """[k, numBins, 2] integer-valued re/im -> the kiss FIXED_POINT
    result as integer-valued float32 [k, numBins, 2], computed in
    complex64 on the host."""
    x = torch.complex(x_ri[..., 0].float(), x_ri[..., 1].float())
    n = x.shape[-1]
    if inverse:
        y = torch.fft.ifft(x, dim=-1)  # includes 1/n: matches TestFFT int16
    else:
        y = torch.fft.fft(x, dim=-1) / n
    return torch.round(torch.view_as_real(y))


@register_block("/comms/fft")
class FFTBlock(Block):
    """Forward/inverse complex FFT over numBins-sized windows
    (reference: fft/FFT.cpp)."""

    DOC = {
        "category": "/FFT",
        "keywords": ["fft", "dft", "fourier", "transform"],
        "params": {
            "num_bins": {"label": "Num FFT Bins", "default": 1024,
                         "widget": "ComboBox(editable=true)",
                         "options": [{"label": str(1 << p),
                                      "value": 1 << p}
                                     for p in range(4, 13)]},
            "inverse": {"label": "Inverse FFT", "default": False,
                        "widget": "ToggleSwitch"},
        },
    }

    def __init__(self, dtype="complex_float32", num_bins: int = 1024,
                 inverse: bool = False):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not self.dtype.is_complex:
            raise ValueError("fft: complex dtypes only")
        if self.dtype.is_integer and self.dtype.bits != 16:
            raise ValueError("fft: integer path supports complex_int16 only "
                             "(reference FFTAux.h:29-48)")
        self.num_bins = int(num_bins)
        self.inverse = bool(inverse)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self.input(0).set_reserve(self.num_bins)

    def work(self):
        port = self.input(0)
        nb = self.num_bins
        k = port.elements() // nb
        if k == 0:
            return
        buf = np.asarray(port.buffer(k * nb))
        if self.dtype.is_integer:
            x = torch.from_numpy(buf.reshape(k, nb, 2))
            out = _fft_int16(x, self.inverse).numpy().astype(np.int16)
            out = out.reshape(k * nb, 2)
        elif self.dtype.bits == 32:
            x = np.ascontiguousarray(buf, np.complex64).view(np.float32)
            xp = torch.from_numpy(x.reshape(k, nb, 2)).to(self.device)
            y = fft_planar(xp, nb, self.inverse).cpu().numpy()
            out = y.view(np.complex64).reshape(k * nb)
        else:
            x = buf.reshape(k, nb)
            y = np.fft.ifft(x, axis=-1) * nb if self.inverse \
                else np.fft.fft(x, axis=-1)
            out = y.astype(self.dtype.np).reshape(k * nb)
        port.consume(k * nb)
        self.output(0).post(out)

    def device_core(self, channels: int, device=None):
        """Fused-chain core (terminal stage): input [C, T, 2] planar with T
        a multiple of numBins; output [C, T/numBins, numBins, 2] spectra.
        complex_float32 runs ``fft_planar`` on the input's device (K2 on
        CUDA); complex_int16 takes the streaming path's host computation,
        so fused and streaming give bit-identical integers. The core is
        stateless and runs where its input lies, so ``device`` is not
        used."""
        nb, inverse = self.num_bins, self.inverse
        fixed = self.dtype.is_integer

        def step(carry, x):
            c, t, _ = x.shape
            frames = x.reshape(c * (t // nb), nb, 2)
            if fixed:
                spec = _fft_int16(frames.cpu(), inverse).to(x.device)
            else:
                spec = fft_planar(frames, nb, inverse)
            return carry, spec.reshape(c, t // nb, nb, 2)

        return (), step

    # -- auto-fusion protocol (core/fusion.py) -------------------------- #
    fuse_kind = "fft"  # frames out: terminates a fused run

    def fuse_retained(self):
        return None  # any sub-frame leftover is absorbed into the carry

    def fuse_ready(self) -> bool:
        # the queued sub-frame leftover becomes the carry; a full frame
        # still queued (e.g. congestion skipped work()) must drain first
        return (self.dtype.bits in (16, 32)
                and self.input(0).elements() < self.num_bins)

    def fuse_export(self, channels: int):
        """Streaming state = the sub-frame leftover queued on the input
        port (work() only consumes whole numBins windows); it becomes a
        [C, r, 2] carry so fused quanta stay frame-phase-accurate."""
        from pothoscomms_tpu_torch.core.fusion import to_planar

        port = self.input(0)
        r = port.elements()
        nb = self.num_bins
        assert r < nb
        if r == 0:
            left = torch.zeros((channels, 0, 2), device=self.device)
        else:
            parts = [to_planar(p, self.dtype, self.device)
                     for p in port.take(r)]
            left = torch.cat(parts)[None]
        _, core = self.device_core(channels)

        def step(carry, x):
            ext = torch.cat([carry, x], dim=1)  # [C, r+T, 2]
            m = ext.shape[1] // nb
            _, spec = core(None, ext[:, : m * nb])
            return ext[:, m * nb:], spec

        return left, step

    def fuse_import(self, carry) -> None:
        if carry is None or (isinstance(carry, tuple) and not carry):
            return
        c = carry[0].cpu().numpy()
        if c.shape[0] == 0:
            return
        if self.dtype.is_integer:
            arr = np.rint(c).astype(self.dtype.np)
        else:
            arr = np.ascontiguousarray(c).view(np.complex64)[:, 0] \
                .astype(self.dtype.np)
        self.input(0).push_front_buffer(arr)
