"""F1 (csrc/fm_demod_dc.cu), the FM discriminator and DC-removal cascade
in one pass, on the CPU, where the kernel cannot run: its tile plan and
index algebra mirrored in numpy and held to the plain version, the two
fused cores' torch ops (``fm_demod_dc_plain``).

- The mirror takes each block's span as the source does (base =
  max(0, t0 - (casc - 1)(D - 1)) - (D - 1), each stage's outputs on
  [max(0, t0 - (casc - 1 - s)(D - 1)), e), its inputs below 0 from the
  stage's history, the rest of the span 0) and the window sums as
  differences of float64 prefix sums local to the span, rounded once to
  float32 and divided by D in float32. It writes every output and every
  history entry exactly once, reads no sample outside its span, and its
  outputs and carries agree with the plain
  version within 8 float32 ulps of the largest magnitude (window sums
  rounded from float64 sums in another order), the discriminator's carry
  and the first stage's history exactly.
- At a 2^20-sample block with a DC offset of 0.25 on the discriminator's
  output, the mirror's local prefix sums hold the float64 result to 1e-6,
  where float32 prefix sums (the JAX package's) lose more than 1e-4.
- The plan: tiles of a multiple of 32 outputs that, with their halo, fit
  the span of kThreads x kPer samples (read from the source), cover the
  row with no empty tile, and go as even as that allows.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pothoscomms_tpu_torch.kernels import fm_demod_dc as f1
from pothoscomms_tpu_torch.parallel.chain import freq_demod_planar

torch.set_num_threads(1)

_F = np.float32
_SOURCE = (Path(f1.__file__).resolve().parent.parent / "csrc"
           / "fm_demod_dc.cu").read_text()
ULPS = 8 * 2.0 ** -24   # the agreement bound, a share of max |y|


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE)[1])


def fm_input(rng, C, T, offset=0.0):
    phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, T)) + offset, axis=1)
    return np.stack([np.cos(phase), np.sin(phase)], -1).astype(_F)


def mirror(x, last, hists, D, casc):
    """The kernel's algebra in numpy: (y, new_last, new_hists)."""
    C, T = x.shape[:2]
    B, ntiles = f1.plan(T, D, casc)
    u, _ = freq_demod_planar(torch.from_numpy(x), torch.from_numpy(last))
    u = u.numpy()
    y = np.full((C, T), np.nan, _F)
    written = np.zeros((C, T), int)
    new_last = np.full_like(last, np.nan)
    new_hists = np.full_like(hists, np.nan)
    hist_written = np.zeros(hists.shape, int)
    dm1 = D - 1
    for c in range(C):
        for k in range(ntiles):
            t0, e = k * B, min(k * B + B, T)
            assert t0 < e

            def out_lo(s):
                return max(0, t0 - (casc - 1 - s) * dm1)

            base = out_lo(0) - dm1
            n = e - base
            assert n <= f1.SPAN
            i = np.arange(base, base + f1.SPAN)
            inside = i < e
            # stage 0's input: the history below 0, u from 0 on, else 0
            U = np.zeros(f1.SPAN, _F)
            neg = inside & (i < 0)
            U[neg] = hists[0, c, D + i[neg]]
            pos = inside & (i >= 0)
            U[pos] = u[c, i[pos]]
            if e == T:
                sel = (i >= T - D) & (i < T)
                new_hists[0, c, i[sel] - (T - D)] = U[sel]
                hist_written[0, c, i[sel] - (T - D)] += 1
                new_last[c, 0] = x[c, T - 1]
            v = U.copy()
            for s in range(casc):
                P = np.cumsum(v.astype(np.float64))
                lag = np.concatenate([np.zeros(D), P[:-D]])
                w = (P - lag).astype(_F)
                avg = w / _F(D)
                out = (i >= out_lo(s)) & (i < e)
                assert (i[out] - D + 1 >= out_lo(s) - dm1).all()
                if s == casc - 1:
                    m = np.nonzero(out)[0]
                    assert (m + 1 - D >= 0).all()
                    v = np.zeros(f1.SPAN, _F)
                    v[m] = U[m + 1 - D] - avg[m]
                else:
                    nxt = out_lo(s + 1) - dm1
                    hist = (i >= nxt) & (i < 0) & ~out
                    v = np.where(out, avg, _F(0))
                    v[hist] = hists[s + 1, c, D + i[hist]]
                    if e == T:
                        sel = out & (i >= T - D)
                        new_hists[s + 1, c, i[sel] - (T - D)] = avg[sel]
                        hist_written[s + 1, c, i[sel] - (T - D)] += 1
            keep = (i >= t0) & (i < e)
            y[c, i[keep]] = v[keep]
            written[c, i[keep]] += 1
    assert (written == 1).all()
    assert (hist_written == 1).all()
    return y, new_last, new_hists


def _agree(got, ref):
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(got - ref).max() <= ULPS * scale


@pytest.mark.parametrize("C,T,D,casc", [
    (1, 16, 16, 1), (3, 64, 64, 2), (3, 1000, 16, 3), (2, 5000, 64, 2),
    (1, 4001, 512, 3), (3, 16384, 64, 2), (1, 3 * 1920 + 5, 64, 2),
    (2, 7777, 769, 2), (1, 2048, 5, 1)])
def test_mirror_matches_plain_over_chained_steps(C, T, D, casc):
    rng = np.random.default_rng(C * 7 + T + D + casc)
    last = np.zeros((C, 1, 2), _F)
    hists = np.zeros((casc, C, D), _F)
    mlast, mhists = last, hists
    for step in range(3):
        x = fm_input(rng, C, T, offset=0.1 * step)
        y, last_p, hists_p = f1.fm_demod_dc_plain(
            torch.from_numpy(x), torch.from_numpy(last),
            torch.from_numpy(hists), D, casc)
        ym, mlast, mhists = mirror(x, mlast, mhists, D, casc)
        _agree(ym, y.numpy())
        np.testing.assert_array_equal(mlast, last_p.numpy())
        np.testing.assert_array_equal(mhists[0], hists_p[0].numpy())
        _agree(mhists, hists_p.numpy())
        last, hists = last_p.numpy(), hists_p.numpy()


def test_mirror_holds_float32_resolution_at_a_dc_offset():
    D, casc, T = 64, 2, 1 << 20
    rng = np.random.default_rng(31)
    x = fm_input(rng, 1, T, offset=0.25)
    last = np.zeros((1, 1, 2), _F)
    hists = np.zeros((casc, 1, D), _F)
    y, _, _ = mirror(x, last, hists, D, casc)
    u, _ = freq_demod_planar(torch.from_numpy(x), torch.from_numpy(last))
    u = u.numpy()[0]
    assert abs(float(u.mean()) - 0.25) < 0.01

    def cascade(cur, cumsum):
        delayed = np.concatenate([np.zeros(D, cur.dtype), cur])[1:1 + T]
        for _ in range(casc):
            cs = cumsum(np.concatenate([np.zeros(D, cur.dtype), cur]))
            cur = (cs[D:] - cs[:-D]) / cur.dtype.type(D)
        return delayed - cur

    ref = cascade(u.astype(np.float64), np.cumsum)
    f32 = cascade(u, lambda a: np.cumsum(a, dtype=_F))
    assert np.max(np.abs(f32 - ref)) > 1e-4
    assert np.max(np.abs(y[0] - ref)) < 1e-6


def test_plan_fits_the_span_and_covers_the_row():
    assert (f1.THREADS, f1.PER) == (_const("kThreads"), _const("kPer"))
    assert f1.SPAN == f1.THREADS * f1.PER
    for D in (1, 2, 16, 64, 100, 512, 769, 1025):
        for casc in (1, 2, 3, 4):
            if not f1.fits(D, casc):
                assert casc * (D - 1) > f1.MAX_HALO
                continue
            for T in (D, D + 1, 1919, 1920, 1921, 2048, 16384, 131072,
                      (1 << 24) + 17):
                B, ntiles = f1.plan(T, D, casc)
                assert B % 32 == 0 and B + casc * (D - 1) <= f1.SPAN
                assert (ntiles - 1) * B < T <= ntiles * B
                most = (f1.SPAN - casc * (D - 1)) // 32 * 32
                assert ntiles == -(-T // most)
    assert f1.plan(131072, 64, 2) == (1920, 69)
    assert f1.plan(16384, 64, 2) == (1824, 9)


@pytest.mark.parametrize("T,D,casc,fits", [
    (131072, 64, 2, True), (16384, 64, 2, True), (64, 64, 2, True),
    (63, 64, 2, False), (1 << 20, 769, 2, True), (1 << 20, 770, 2, False),
    (1 << 20, 513, 3, True), (1 << 20, 514, 3, False), (1, 1, 1, True),
    ((1 << 30) + 1, 64, 2, False),
    (10, 0, 1, False), (10, 4, 0, False)])
def test_fits_states_the_kernel_limits(T, D, casc, fits):
    assert f1.fits(D, casc, T) is fits
    assert f1.fits(D, casc) is (D >= 1 and casc >= 1
                                and casc * (D - 1) <= f1.MAX_HALO)


def test_wrapper_checks_its_operands():
    x = torch.zeros(2, 128, 2)
    last = torch.zeros(2, 1, 2)
    hists = torch.zeros(2, 2, 64)
    y, l2, h2 = f1.fm_demod_dc(x, last, hists, 64, 2)
    assert y.shape == (2, 128) and l2.shape == last.shape
    assert h2.shape == hists.shape
    with pytest.raises(ValueError):          # T < D
        f1.fm_demod_dc(x[:, :32], last, hists, 64, 2)
    with pytest.raises(ValueError):          # hists of another cascade
        f1.fm_demod_dc(x, last, hists[:1], 64, 2)
    with pytest.raises(ValueError):          # not [C, T, 2]
        f1.fm_demod_dc(x[..., 0], last, hists, 64, 2)
    with pytest.raises(TypeError):
        f1.fm_demod_dc(x.double(), last, hists, 64, 2)
    with pytest.raises(ValueError):          # a halo beyond the span
        f1.fm_demod_dc(torch.zeros(2, 4096, 2), last,
                       torch.zeros(3, 2, 514), 514, 3)
    with pytest.raises(ValueError):          # no kernel for the device
        f1.fm_demod_dc(x.to("meta"), last.to("meta"), hists.to("meta"),
                       64, 2)
