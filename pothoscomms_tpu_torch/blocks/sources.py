"""Waveform and noise sources (reference: waveform/ module, SURVEY.md §2.8);
the port of the JAX package's ``blocks/sources.py``.

Both sources are table-driven exactly like the reference
(waveform/WaveformSource.cpp:98-108 walks a power-of-2 lookup table by an
integer step+mask; waveform/NoiseSource.cpp:105-130 re-enters a pre-filled
pool at a random offset). Tables are built on the host in numpy float64 at
reconfiguration time, as the JAX package builds them, and the noise draws
come from ``np.random.default_rng(seed)`` in the same order, so both are
equal bit for bit to the JAX package's for the same settings and seed.

Streaming, a work() call gathers its samples from the table on the host.
Heading a fused segment (core/fusion.py), a source generates on the
segment's device: the table lives there, and each quantum is one gather
through one int64 index tensor, with the walk's position carried as a
Python int (no host-to-device copy per quantum).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.registry import register_block

DEFAULT_WAVE_TABLE_SIZE = 4096
MAX_WAVE_TABLE_SIZE = 1024 * 1024
MINIMUM_TABLE_STEP_SIZE = 16
# Odd stride ~ P/phi: the fused noise walk re-enters the pool at a
# low-discrepancy offset every DEFAULT_WAVE_TABLE_SIZE samples.
WEYL_STRIDE = 2531

# samples produced per streaming work() call when the quota allows (the
# analog of the reference's output-buffer-manager slab size)
_CHUNK = 16384


def _llround(x: float) -> int:
    """C++ llround: round half away from zero."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


def _planar_table(tab: np.ndarray, dtype: DType, device) -> torch.Tensor:
    """A float table as planar float32 on ``device``: [N, 2] complex,
    [N] real."""
    if dtype.is_complex:
        arr = np.stack([tab.real, tab.imag], -1).astype(np.float32)
    else:
        arr = np.asarray(tab, np.float32)
    return torch.from_numpy(arr).to(device)


class _TableSource(Block):
    """Shared machinery: dtype-aware element conversion + chunked output."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if self.dtype.kind == "uint":
            raise ValueError("unsupported type (reference factory matrix is "
                             "int/float only)")
        self.setup_output(0, self.dtype)
        self.unbounded_source = True
        self._offset = complex(0.0)
        self._scalar = complex(1.0)

    # reference setElem (waveform/WaveformSource.cpp:249-259): real dtypes
    # keep the real part; integer casts truncate toward zero like C.
    def _convert(self, vals: np.ndarray) -> np.ndarray:
        vals = self._scalar * np.asarray(vals, np.complex128) + self._offset
        dt = self.dtype
        if dt.is_complex:
            if dt.is_float:
                return vals.astype(dt.np)
            return np.stack(
                [np.trunc(vals.real), np.trunc(vals.imag)], axis=-1
            ).astype(dt.scalar.np)
        if dt.is_float:
            return vals.real.astype(dt.np)
        return np.trunc(vals.real).astype(dt.np)

    def set_offset(self, offset):
        self._offset = complex(offset)
        self._update_table()

    def get_offset(self):
        return self._offset

    def set_amplitude(self, scalar):
        self._scalar = complex(scalar)
        self._update_table()

    def get_amplitude(self):
        return self._scalar

    def _update_table(self):  # override
        pass

    def activate(self):
        self._update_table()

    def _work_size(self) -> int:
        return min(self._source_quota, _CHUNK) if self._source_quota \
            else _CHUNK


@register_block("/comms/waveform_source", "/blocks/waveform_source")
class WaveformSource(_TableSource):
    """CONST/SINE/RAMP/SQUARE cyclic source
    (reference: waveform/WaveformSource.cpp).

    Complex output is quadrature: im lags re by 90 degrees (table built from
    one complex rotation; RAMP/SQUARE use the i+(3N/4) mod N trick,
    WaveformSource.cpp:228,239).
    """

    DOC = {
        "category": "/Sources",
        "keywords": ["waveform", "source", "signal", "sine", "ramp"],
        "params": {
            "waveform": {
                "label": "Wave Type",
                "options": [{"label": w.title(), "value": w} for w in
                            ("CONST", "SINE", "RAMP", "SQUARE")],
                "default": "CONST",
            },
            "frequency": {"label": "Frequency", "units": "Hz",
                          "default": 0.0},
            "sample_rate": {"label": "Sample Rate", "units": "Sps",
                            "default": 1.0},
            "resolution": {"label": "Resolution", "units": "Hz",
                           "default": 0.0,
                           "desc": "Frequency resolution for table "
                                   "auto-sizing (0 = from frequency)."},
            "amplitude": {"label": "Amplitude", "default": [1.0, 0.0]},
            "offset": {"label": "Offset", "default": [0.0, 0.0]},
        },
    }

    def __init__(self, dtype="complex_float32"):
        super().__init__(dtype)
        self._index = 0
        self._step = 0
        self._mask = 0
        self._rate = 1.0
        self._freq = 0.0
        self._res = 0.0
        self._wave = "CONST"
        self._table: Optional[np.ndarray] = None

    # -- setters (reference :110-174) ---------------------------------- #
    def set_waveform(self, wave: str):
        self._wave = wave
        self._update_table()

    def get_waveform(self) -> str:
        return self._wave

    def set_frequency(self, freq: float):
        self._freq = float(freq)
        self._update_table()

    def get_frequency(self) -> float:
        return self._freq

    def set_sample_rate(self, rate: float):
        self._rate = float(rate)
        self._update_table()

    def get_sample_rate(self) -> float:
        return self._rate

    def set_resolution(self, res: float):
        self._res = float(res)
        self._update_table()

    def get_resolution(self) -> float:
        return self._res

    # -- table construction (reference :178-247) ------------------------ #
    def _update_table(self):
        if not self.is_active():
            return
        frac = (self._freq if self._res == 0.0 else self._res) / self._rate
        num_entries = DEFAULT_WAVE_TABLE_SIZE
        while True:
            delta = _llround(frac * num_entries)
            if frac == 0.0:
                break
            if abs(delta) >= MINIMUM_TABLE_STEP_SIZE:
                break
            if num_entries * 2 > MAX_WAVE_TABLE_SIZE:
                break
            num_entries *= 2

        self._mask = num_entries - 1
        self._step = _llround((self._freq / self._rate) * num_entries)
        if self._step == 0 and self._freq != 0.0:
            raise ValueError(
                "WaveformSource.update_table: step size not achievable"
            )

        n = num_entries
        i = np.arange(n)
        if self._wave == "CONST":
            vals = np.ones(n, np.complex128)
        elif self._wave == "SINE":
            vals = np.exp(2j * np.pi * i / n)
        elif self._wave == "RAMP":
            q = (i + (3 * n) // 4) % n
            vals = (2.0 * i / (n - 1) - 1.0) + 1j * (2.0 * q / (n - 1) - 1.0)
        elif self._wave == "SQUARE":
            q = (i + (3 * n) // 4) % n
            vals = np.where(i < n // 2, 0.0, 1.0) + 1j * np.where(
                q < n // 2, 0.0, 1.0
            )
        else:
            raise ValueError(f"unknown waveform setting {self._wave!r}")
        self._table = self._convert(vals)
        self._bump_fuse_epoch()

    # -- generation (reference :98-108, vectorized) ---------------------- #
    def work(self):
        if self._table is None:
            self._update_table()
        n = self._work_size()
        if n <= 0:
            return
        size = self._mask + 1
        idx = (self._index + np.arange(n) * self._step) % size
        self.output(0).post(self._table[idx])
        self._index = (self._index + n * self._step) % size
        self._source_quota = max(0, self._source_quota - n)

    # -- auto-fusion source protocol (core/fusion.py) -------------------- #
    def fuse_source_ready(self) -> bool:
        if not (self.dtype.is_float and self.dtype.bits == 32):
            return False
        if self._table is None and self.is_active():
            self._update_table()
        return self._table is not None

    def fuse_source_export(self, channels: int):
        """-> (carry, src_step, params). ``src_step(carry, t, table)``
        generates [1, t(, 2)] planar float32 where the table lies.

        The step+mask walk visits table[(index + j*step) mod N], periodic
        with period N/gcd(step, N). The carry is j mod period, the samples
        emitted since export (a Python int), so the walk's position stays
        exact for any number of quanta; the index tensor is int64."""
        if self._table is None:
            self._update_table()
        n = self._mask + 1
        step = self._step % n
        period = n // math.gcd(step, n) if step else 1
        index0 = self._index
        self._fuse_walk = (step, period, index0)

        def src_step(carry, t, table):
            j = torch.arange(carry, carry + t, device=table.device)
            idx = torch.bitwise_and(index0 + j * step, n - 1)
            return (carry + t) % period, table[idx][None]

        return 0, src_step, (_planar_table(self._table, self.dtype,
                                           self.device),)

    def fuse_source_import(self, carry) -> None:
        step, period, index0 = self._fuse_walk
        # samples emitted = carry (mod period), and period*step = 0 mod N
        self._index = (index0 + (int(carry) % period) * step) \
            % (self._mask + 1)


def noise_walk(table: torch.Tensor, carry: int, t: int):
    """The fused noise walk: ``t`` samples of the pool ``table`` ([P(, 2)])
    re-entered every P samples at an offset that advances by
    ``WEYL_STRIDE``, the first at ``carry``; one gather, where the table
    lies. Returns (next carry, [t(, 2)])."""
    p = table.shape[0]
    ar = torch.arange(t, device=table.device)
    idx = torch.remainder(ar + (ar // p) * WEYL_STRIDE + carry, p)
    k = -(-t // p)
    return (carry + k * WEYL_STRIDE) % p, table[idx]


def noise_walk_plain(table: np.ndarray, carry: int, t: int):
    """The plain version of :func:`noise_walk` on the host: tile by tile,
    each tile one contiguous slice of the doubled pool."""
    p = table.shape[0]
    doubled = np.concatenate([table, table])
    k = -(-t // p)
    tiles = [doubled[o:o + p] for o in
             ((np.arange(k) * WEYL_STRIDE + carry) % p)]
    out = np.concatenate(tiles)[:t] if tiles else table[:0]
    return (carry + k * WEYL_STRIDE) % p, out


@register_block("/comms/noise_source", "/blocks/noise_source")
class NoiseSource(_TableSource):
    """UNIFORM/NORMAL/LAPLACE/POISSON noise source
    (reference: waveform/NoiseSource.cpp).

    Fast mode pre-fills a 4096-entry pool and re-enters it at a random
    offset each work() (reference :105-117); slow mode draws fresh samples
    every element (:119-128). Seedable for reproducible tests.
    """

    DOC = {
        "category": "/Sources",
        "keywords": ["noise", "random", "source", "gaussian"],
        "params": {
            "waveform": {
                "label": "Wave Type",
                "options": [{"label": w.title(), "value": w} for w in
                            ("UNIFORM", "NORMAL", "LAPLACE", "POISSON")],
                "default": "NORMAL",
            },
            "mean": {"label": "Mean", "default": 0.0},
            "b": {"label": "B", "default": 1.0,
                  "desc": "Distribution spread parameter (stddev / "
                          "half-width / scale)."},
            "fast": {"label": "Fast Mode", "default": True,
                     "widget": "ToggleSwitch",
                     "desc": "Pre-filled pool re-entered at a random "
                             "offset per work call."},
        },
    }

    def __init__(self, dtype="complex_float32", seed: Optional[int] = None):
        super().__init__(dtype)
        self._wave = "NORMAL"
        self._mean = 0.0
        self._b = 1.0
        self._fast = True
        self._index = 0
        self._rng = np.random.default_rng(seed)
        self._table: Optional[np.ndarray] = None

    # -- setters (reference :132-185) ------------------------------------ #
    def set_waveform(self, wave: str):
        if wave not in ("UNIFORM", "NORMAL", "LAPLACE", "POISSON"):
            raise ValueError(f"unknown waveform setting {wave!r}")
        self._wave = wave
        self._update_table()

    def get_waveform(self) -> str:
        return self._wave

    def set_mean(self, mean: float):
        self._mean = float(mean)
        self._update_table()

    def get_mean(self) -> float:
        return self._mean

    def set_b(self, b: float):
        self._b = float(b)
        self._update_table()

    def get_b(self) -> float:
        return self._b

    def set_fast(self, fast: bool):
        self._fast = bool(fast)
        self._bump_fuse_epoch()

    # -- draws ----------------------------------------------------------- #
    def _draw(self, n: int) -> np.ndarray:
        """n complex draws with independent re/im components."""
        m, b = self._mean, self._b
        if self._wave == "UNIFORM":
            re, im = (self._rng.uniform(m - b, m + b, n) for _ in range(2))
        elif self._wave == "NORMAL":
            re, im = (self._rng.normal(m, b, n) for _ in range(2))
        elif self._wave == "LAPLACE":
            # reference quirk preserved: Laplace synthesized from a
            # uniform(mean-b, mean+b) draw (NoiseSource.cpp:243-249)
            def lap():
                u = self._rng.uniform(m - b, m + b, n)
                return np.where(u < 0, m + b * np.log1p(u),
                                m - b * np.log1p(-u))

            re, im = lap(), lap()
        elif self._wave == "POISSON":
            re, im = (
                self._rng.poisson(max(m, 0.0), n).astype(np.float64)
                for _ in range(2)
            )
        else:
            raise ValueError(f"unknown waveform setting {self._wave!r}")
        return re + 1j * im

    def _update_table(self):
        if not self.is_active():
            return
        self._table = self._convert(self._draw(DEFAULT_WAVE_TABLE_SIZE))
        self._bump_fuse_epoch()

    def work(self):
        if self._table is None:
            self._update_table()
        n = self._work_size()
        if n <= 0:
            return
        if self._fast:
            self._index += int(self._rng.integers(0, DEFAULT_WAVE_TABLE_SIZE))
            idx = (self._index + np.arange(n)) % DEFAULT_WAVE_TABLE_SIZE
            out = self._table[idx]
            self._index += n
        else:
            out = self._convert(self._draw(n))
        self.output(0).post(out)
        self._source_quota = max(0, self._source_quota - n)

    # -- auto-fusion source protocol (core/fusion.py) -------------------- #
    # Fast mode only: the fused walk re-enters the pre-filled pool at a
    # Weyl-sequence offset every 4096 samples (the streaming path
    # re-enters at a numpy-RNG offset per work call, NoiseSource.cpp:
    # 105-117 — fast mode has no deterministic sequence contract, so
    # parity with the streaming path is statistical, not bit-exact).
    def fuse_source_ready(self) -> bool:
        if not (self.dtype.is_float and self.dtype.bits == 32
                and self._fast):
            return False
        if self._table is None and self.is_active():
            self._update_table()
        return self._table is not None

    def fuse_source_export(self, channels: int):
        """-> (carry, src_step, params): the walk's first offset, drawn
        from the block's generator at export (as the JAX package draws
        it), and :func:`noise_walk` over the pool on the device."""
        if self._table is None:
            self._update_table()
        carry = int(self._rng.integers(0, DEFAULT_WAVE_TABLE_SIZE))

        def src_step(carry, t, table):
            c2, y = noise_walk(table, carry, t)
            return c2, y[None]

        return carry, src_step, (_planar_table(self._table, self.dtype,
                                               self.device),)

    def fuse_source_import(self, carry) -> None:
        # pool re-entry is randomized either way; nothing to restore
        pass
