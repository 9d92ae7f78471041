"""Fused multichannel FIR -> FFT chain over ``[channels, time, 2]`` planar
float32 tensors with an explicit carry: the port of the FIR -> FFT part
of the JAX package's ``parallel/chain.py``.

:func:`fir_fft_form` is the one rule that picks a formulation by shape;
:class:`FirFftChain` runs its answer, and the block API's FIR -> FFT pair
(``core/fusion.py``), the channel-sharded chain (``parallel/mesh.py``)
and the dry run's entry (``parallel/dryrun.py``) run a
:class:`FirFftChain`. The five forms:

- ``one_pass`` (the main path; not in the JAX package's
  ``fir_fft_chain``): each window's FFT times H plus the transformed
  circular correction, in one launch of the K3 kernel
  (``kernels/fir_fft_fused.py``), where its contract holds;
- elsewhere the JAX package's three, with its conditions: ``combined``,
  the combined FIR*DFT operator, each window and the ``prev_pad``
  samples before it times the stacked ``[G1; G0]`` operator, in one
  complex product on the K1 kernel;
- ``toeplitz``, the block-Toeplitz matmul FIR (K1) followed by the FFT
  (K2);
- ``polyphase`` (not in the JAX package, which takes ``conv`` here):
  with decimation, the decimating FIR on the K4 kernel
  (``kernels/fir_decim.py``), computing only the outputs kept, followed
  by the FFT (K2);
- ``conv``, the ``conv1d`` FIR, with decimation, followed by the FFT
  (K2).

Beside them, not chosen by the rule (as in the JAX package): the
split-stream (radix-R) step of :func:`make_split_step`, R products of
width (W + pp) on K1 in place of one of width (nbins + prev_pad).

The carry is ``hist [C, K-1, 2]``: the last K-1 raw inputs.

Operator builders run the JAX package's float64 numpy code, so their
float32 output equals the JAX package's bit for bit.

Also here, as in the JAX module: the FM discriminator of the FM receive
chain, :func:`freq_demod_planar`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.kernels import fir_decim as k4
from pothoscomms_tpu_torch.kernels.cgemm import cgemm
from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
    ONE_PASS_PP, fused_chain_consts, one_pass_step)
from pothoscomms_tpu_torch.parallel import cplx
from pothoscomms_tpu_torch.parallel.fft import fft_planar
from pothoscomms_tpu_torch.parallel.profiling import annotate, build


def _planes(z: np.ndarray):
    """complex numpy -> (real, imag) float32 tensors."""
    return (torch.from_numpy(z.real.astype(np.float32)),
            torch.from_numpy(z.imag.astype(np.float32)))


def complex_fir_kernel(taps) -> torch.Tensor:
    """Complex FIR taps -> [out=2, in=2, K] real conv1d weight.

    (yr + j yi) = sum_k h[k] * x[n-k]:
      yr = hr*xr - hi*xi ; yi = hi*xr + hr*xi
    conv1d correlates, so the taps are time-reversed.
    """
    h = np.asarray(taps)
    hr = h.real.astype(np.float32)[::-1].copy()
    hi = h.imag.astype(np.float32)[::-1].copy() if np.iscomplexobj(h) \
        else np.zeros_like(hr)
    w = np.zeros((2, 2, len(h)), np.float32)
    w[0, 0], w[0, 1] = hr, -hi
    w[1, 0], w[1, 1] = hi, hr
    return torch.from_numpy(w)


def make_fir_kernel(taps) -> torch.Tensor:
    return complex_fir_kernel(np.asarray(taps))


@contextlib.contextmanager
def _exact_f32_conv(x: torch.Tensor):
    """Keep cuDNN off TF32 for one convolution (its default is on), as the
    JAX package pins Precision.HIGHEST on its conv."""
    if not x.is_cuda:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def fir_multichannel(x: torch.Tensor, history: torch.Tensor,
                     kernel: torch.Tensor, decim: int = 1):
    """Multichannel complex FIR over a time block.

    x: [C, T, 2]; history: [C, K-1, 2] carry from the previous block;
    kernel: [2, 2, K] from :func:`complex_fir_kernel`.
    Returns (y [C, ceil(T/decim), 2], new_history [C, K-1, 2]).

    The ``cat``, the convolution and the carry run inside the span
    ``pc.op.conv_fir``.
    """
    k = kernel.shape[-1]
    with annotate("pc.op.conv_fir"):
        xin = torch.cat([history, x], dim=1)           # [C, K-1+T, 2]
        with _exact_f32_conv(x):
            out = F.conv1d(xin.permute(0, 2, 1), kernel, stride=decim)
        y = out.permute(0, 2, 1)                       # [C, T', 2]
        new_hist = xin[:, xin.shape[1] - (k - 1):].contiguous()
    return y, new_hist


def fir_toeplitz_matrices(taps, block: int = 128):
    """Complex taps -> (T0, T1) block-Toeplitz matrices, each a planar
    [B, B, 2] tensor, for the matmul FIR formulation.

    With time grouped into length-B blocks, causal convolution with K<=B
    taps is y_b = x_b @ T0 + x_{b-1} @ T1 where
    T0[i, j] = h[j - i] (0 <= j-i < K) and T1[i, j] = h[j - i + B].
    """
    h = np.asarray(taps, np.complex128)
    k = len(h)
    if k > block:
        raise ValueError(f"{k} taps do not fit one block of {block}")
    t0 = np.zeros((block, block), np.complex128)
    t1 = np.zeros((block, block), np.complex128)
    for d in range(k):
        t0 += np.diag(np.full(block - d, h[d]), k=d)
        if d > 0:
            t1 += np.diag(np.full(d, h[d]), k=d - block)
    t0j = np.stack([t0.real, t0.imag], -1).astype(np.float32)
    t1j = np.stack([t1.real, t1.imag], -1).astype(np.float32)
    return torch.from_numpy(t0j), torch.from_numpy(t1j)


def fir_multichannel_mm(x: torch.Tensor, history: torch.Tensor,
                        t0: torch.Tensor, t1: torch.Tensor,
                        block: int = 128):
    """Matmul-form multichannel complex FIR (same output as
    :func:`fir_multichannel` with decim=1). x: [C, T, 2] with T a
    multiple of ``block``; history: [C, K-1, 2]."""
    c, t, _ = x.shape
    k1 = history.shape[1]
    xb = x.reshape(c, t // block, block, 2)
    # the block before each block, with the stream history before block 0
    prev_tail = torch.cat([x.new_zeros(c, block - k1, 2), history], dim=1)
    prev = torch.cat([prev_tail[:, None], xb[:, :-1]], dim=1)
    y = cplx.matmul(xb, t0[..., 0], t0[..., 1]) \
        + cplx.matmul(prev, t1[..., 0], t1[..., 1])
    return y.reshape(c, t, 2), x[:, t - k1:].contiguous()


def _frames_fft(y: torch.Tensor, nbins: int) -> torch.Tensor:
    c, t, _ = y.shape
    spec = fft_planar(y.reshape(c * (t // nbins), nbins, 2), nbins, False)
    return spec.reshape(c, t // nbins, nbins, 2)


def fir_fft_step(x: torch.Tensor, history: torch.Tensor,
                 kernel: torch.Tensor, nbins: int, decim: int = 1):
    """One step of the chain on the conv FIR: x [C, T, 2] -> (spectra
    [C, T//decim//nbins, nbins, 2], new_history). T//decim must be a
    multiple of nbins."""
    y, hist = fir_multichannel(x, history, kernel, decim)
    return _frames_fft(y, nbins), hist


def fir_fft_step_mm(x: torch.Tensor, history: torch.Tensor,
                    t0: torch.Tensor, t1: torch.Tensor, nbins: int):
    """Matmul-FIR variant of :func:`fir_fft_step` (decim=1, K <= 128)."""
    y, hist = fir_multichannel_mm(x, history, t0, t1)
    return _frames_fft(y, nbins), hist


def combined_fir_fft_operators(taps, nbins: int, prev_pad: int = 128):
    """((G0r, G0i) [nbins, nbins], (G1r, G1i) [prev_pad, nbins]) float32
    planes of the combined operator G = Toeplitz(h) . F; prev_pad >=
    len(taps)-1."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    if k - 1 > prev_pad:
        raise ValueError(f"{k} taps need prev_pad >= {k - 1}, got {prev_pad}")
    t0 = np.zeros((nbins, nbins), np.complex128)
    t1 = np.zeros((prev_pad, nbins), np.complex128)
    for d in range(k):
        for j in range(nbins):
            i = j - d
            if i >= 0:
                t0[i, j] = h[d]
            else:
                t1[prev_pad + i, j] = h[d]
    f = np.exp(-2j * np.pi * np.outer(np.arange(nbins),
                                      np.arange(nbins)) / nbins)
    return _planes(t0 @ f), _planes(t1 @ f)


def stack_combined_operators(g0, g1):
    """((G0r, G0i), (G1r, G1i)) -> the stacked [G1; G0] planes (Gr, Gi),
    each [prev_pad + nbins, nbins], that :func:`fir_fft_combined_step`
    multiplies :func:`combined_operand` by."""
    return torch.cat([g1[0], g0[0]]), torch.cat([g1[1], g0[1]])


def combined_operand(x: torch.Tensor, hist: torch.Tensor, nbins: int,
                     k: int, prev_pad: int) -> torch.Tensor:
    """The combined step's left operand [C * T//nbins, prev_pad + nbins,
    2]: each window behind the ``prev_pad`` samples before it (the carry,
    zero-padded, before window 0)."""
    c, t, _ = x.shape
    nw = t // nbins
    xw = x.reshape(c, nw, nbins, 2)
    with annotate("pc.op.combined_operand"):
        first = torch.cat([x.new_zeros(c, 1, prev_pad - (k - 1), 2),
                           hist[:, None]], dim=2)
        prev = torch.cat([first, xw[:, :-1, nbins - prev_pad:]], dim=1)
        return torch.cat([prev, xw], dim=2).reshape(c * nw,
                                                    prev_pad + nbins, 2)


def fir_fft_combined_step(x, hist, gr, gi, nbins: int, k: int,
                          prev_pad: int):
    """One combined FIR+FFT step: x [C, T, 2] -> (spectra
    [C, T//nbins, nbins, 2], new_hist [C, k-1, 2]).

    The window and its previous tail form one [.., prev_pad + nbins]
    operand against the stacked [G1; G0] operator (``gr``, ``gi`` from
    :func:`stack_combined_operators`): one complex product on the K1
    kernel. The JAX package takes three real products (Karatsuba) here;
    the port takes four, which K1 runs faster and without Karatsuba's
    cancellation."""
    c, t, _ = x.shape
    a = combined_operand(x, hist, nbins, k, prev_pad)
    spec = cgemm(a, gr, gi)
    return spec.reshape(c, t // nbins, nbins, 2), \
        x[:, t - (k - 1):].contiguous()


# ---------------------------------------------------------------------- #
# Split-stream (radix-R) combined operator. One level of radix-R
# decimation in frequency applied to the FIR output, with the stream
# combines moved to the FIR input (the weights W_R^{mr} are scalars, so
# they commute with the convolution):
#
#     spec[R k' + r] = DFT_W( W_N^{j r} . conv(h, v_r)[j] )[k'],
#     v_r[j] = sum_m W_R^{m r} x[m W + j],        W = nbins / R,
#
# so each stream runs the combined Toeplitz*DFT operator at width W with
# a pp >= K-1 previous tail: (W + pp) complex MACs a sample instead of
# (nbins + prev_pad). The stream histories decompose over raw samples,
#     hist_r[w] = q_tail[w-1, R-1] + sum_{m>=1} W_R^{m r} q_tail[w, m-1],
# with q_tail[w, m] the last K-1 samples of quarter m of window w, so the
# carry is the combined step's: the last K-1 raw inputs.
# ---------------------------------------------------------------------- #
def split_stream_fir_fft_operators(taps, nbins: int, R: int, pp: int):
    """Per-stream (G0 [W, W], G1 [pp, W]) float32 plane pairs,
    G_r = Toeplitz(h) . diag(W_N^{r j}) . F_W, and the W_R stream weights.
    Returns (ops, wr): ops a length-R list of ((g0r, g0i), (g1r, g1i)),
    wr the [R, R] complex128 numpy weights."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    W = nbins // R
    if not k - 1 <= pp <= W:
        raise ValueError(f"need K-1 <= pp <= W: K={k}, pp={pp}, W={W}")
    t0 = np.zeros((W, W), np.complex128)
    t1 = np.zeros((pp, W), np.complex128)
    for d in range(k):
        for j in range(W):
            i = j - d
            if i >= 0:
                t0[i, j] = h[d]
            else:
                t1[pp + i, j] = h[d]
    f = np.exp(-2j * np.pi * np.outer(np.arange(W), np.arange(W)) / W)
    ops = []
    for r in range(R):
        tw = np.exp(-2j * np.pi * r * np.arange(W) / nbins)
        df = tw[:, None] * f
        ops.append((_planes(t0 @ df), _planes(t1 @ df)))
    wr = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    return ops, wr


def split_operand(x: torch.Tensor, hist: torch.Tensor, wr: torch.Tensor,
                  nbins: int, k: int, pp: int) -> torch.Tensor:
    """The split step's R left operands [R, C * T//nbins, pp + W, 2]:
    stream r's [hist_r | v_r] for every window, hist_r behind pp - (K-1)
    zeros. All R streams come from one complex product of the [R, R]
    weights ``wr`` (complex64) with the windows' R quarters, each behind
    its history term (the zeros stay zero)."""
    c, t, _ = x.shape
    R = wr.shape[0]
    nw, W, k1 = t // nbins, nbins // R, k - 1
    xq = torch.view_as_complex(x.contiguous()).reshape(c, nw, R, W)
    qt = xq[..., W - k1:]                                 # [c, nw, R, k1]
    # q_tail[w-1, R-1], the stream carry before window 0, then
    # q_tail[w, m-1] for m >= 1: quarter m's history term
    prev_last = torch.cat([torch.view_as_complex(hist.contiguous())[:, None],
                           qt[:, :-1, R - 1]], dim=1)     # [c, nw, k1]
    a = torch.cat([xq.new_zeros(R, c, nw, pp - k1),
                   torch.cat([prev_last[None], qt[:, :, :R - 1]
                              .permute(2, 0, 1, 3)]),
                   xq.permute(2, 0, 1, 3)], dim=-1)       # [R, c, nw, pp+W]
    s = torch.matmul(wr, a.reshape(R, -1))
    return torch.view_as_real(s).reshape(R, c * nw, pp + W, 2)


def split_step(x: torch.Tensor, hist: torch.Tensor, wr: torch.Tensor,
               gr: torch.Tensor, gi: torch.Tensor, nbins: int, k: int,
               pp: int):
    """One split-stream FIR+FFT step: x [C, T, 2] -> (spectra
    [C, T//nbins, nbins, 2], new_hist [C, k-1, 2]). ``gr``, ``gi``
    [R, pp + W, W] hold each stream's stacked [G1; G0]; stream r is one
    complex product on the K1 kernel, its output bins r, R + r, ...."""
    c, t, _ = x.shape
    R = wr.shape[0]
    a = split_operand(x, hist, wr, nbins, k, pp)
    specs = a.new_empty(R, a.shape[1], nbins // R, 2)
    for r in range(R):
        cgemm(a[r], gr[r], gi[r], out=specs[r])
    # interleave, spec[R k' + r] = specs[r][k']: one transposing copy of
    # complex elements (torch.stack along an inner axis moved the 8-byte
    # pairs ~14x slower on an H100)
    spec = torch.view_as_complex(specs).permute(1, 2, 0).contiguous()
    return (torch.view_as_real(spec).reshape(c, t // nbins, nbins, 2),
            x[:, t - (k - 1):].contiguous())


class SplitFirFftChain(nn.Module):
    """The split-stream FIR -> windowed FFT step (:func:`split_step`) with
    its operators as buffers on ``device`` (the card unless the caller
    names another): ``wr`` [R, R] complex64, ``gr``, ``gi``
    [R, pp + W, W]. Called as ``run(x, carry) -> (spectra, carry)``, the
    carry being the last K-1 raw inputs, as :class:`FirFftChain`'s. The
    operators are built inside the build span ``pc.build.fir_fft.split``.
    """

    def __init__(self, taps, nbins: int, R: int, pp: int = 64, device=None):
        super().__init__()
        taps = np.asarray(taps)
        self.nbins, self.k, self.R, self.pp = nbins, len(taps), R, pp
        device = placement.resolve(device)
        with build("pc.build.fir_fft.split",
                   key=(self.k, nbins, R, pp, device)):
            ops, wr = split_stream_fir_fft_operators(taps, nbins, R, pp)
            stacked = [stack_combined_operators(g0, g1) for g0, g1 in ops]
            self.register_buffer("wr", torch.from_numpy(
                wr.astype(np.complex64)).to(device))
            self.register_buffer("gr", torch.stack([s[0] for s in stacked])
                                 .to(device))
            self.register_buffer("gi", torch.stack([s[1] for s in stacked])
                                 .to(device))

    def forward(self, x: torch.Tensor, carry: torch.Tensor):
        return split_step(x, carry, self.wr, self.gr, self.gi, self.nbins,
                          self.k, self.pp)


def make_split_step(taps, nbins: int, R: int, pp: int = 64, device=None):
    """The split-stream step and its initial carry, as the JAX package's
    ``make_split_step``: returns (run, hist0) with ``run(x [C, T, 2],
    hist [C, K-1, 2]) -> (spec [C, T//nbins, nbins, 2], new_hist)`` a
    :class:`SplitFirFftChain` and hist0 zeros [1, K-1, 2] (the caller
    sizes C), both on ``device`` (default: the card)."""
    device = placement.resolve(device)
    run = SplitFirFftChain(taps, nbins, R, pp, device)
    return run, torch.zeros((1, run.k - 1, 2), dtype=torch.float32,
                            device=device)


def circ_correction_operators(taps, nbins: int):
    """(H [nbins, 2] planar, (Gcr, Gci) [K-1, nbins]) for the circular-
    correction formulation: spec_w = FFT(x_w) . H + u_w @ Gc, with
    u_w[m-1] = prev_tail[-m] - x_w[-m]."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    H = np.fft.fft(h, nbins)
    f = np.exp(-2j * np.pi * np.outer(np.arange(nbins),
                                      np.arange(nbins)) / nbins)
    gc = np.zeros((k - 1, nbins), np.complex128)
    for m in range(1, k):
        for j in range(0, k - m):
            gc[m - 1] += h[j + m] * f[j]
    Hp = torch.from_numpy(np.stack([H.real, H.imag], -1).astype(np.float32))
    return Hp, _planes(gc)


def fir_fft_form(k: int, nbins: int, decim: int, block: int) -> str:
    """The formulation of a FIR -> FFT step of ``k`` taps, ``nbins``
    bins and decimation ``decim`` over blocks of ``block`` samples:

    - ``"one_pass"`` (K3) where its contract holds: decim == 1,
      nbins == 1024, 1 < K <= ONE_PASS_PP + 1 and ``block`` a multiple
      of ``nbins``;
    - else, as the JAX package's ``fir_fft_chain``, ``"combined"`` (K1)
      when decim == 1, 1 < K <= prev_pad + 1 (prev_pad = min(128,
      nbins)) and ``block`` is a multiple of ``nbins``;
    - else ``"toeplitz"`` when decim == 1, K <= 128 and ``block`` is a
      multiple of 128;
    - ``"polyphase"`` (K4) where decim > 1 and its contract holds:
      decim <= 64 and 1 <= K <= 256;
    - else ``"conv"``.
    """
    if decim == 1 and block % nbins == 0:
        if nbins == 1024 and 1 < k <= ONE_PASS_PP + 1:
            return "one_pass"
        if 1 < k <= min(128, nbins) + 1:
            return "combined"
    if decim == 1 and k <= 128 and block % 128 == 0:
        return "toeplitz"
    if k4.fits(k, decim):
        return "polyphase"
    return "conv"


class FirFftChain(nn.Module):
    """FIR -> windowed FFT over [C, T, 2] blocks with the K-1 sample carry.

    The formulation (``form``) is :func:`fir_fft_form`'s answer for the
    taps, ``nbins``, ``decim`` and ``block``; its operators are buffers on
    ``device`` (the card unless the caller names another), built inside
    the build span ``pc.build.fir_fft.<form>`` keyed by (form, K, nbins,
    block, decim, device): a chain of a shape built before in the
    process counts as a rebuild.

    With decim > 1 the block must be a multiple of decim * nbins, so that
    every block starts on the decimation's phase and ends on a window.
    """

    def __init__(self, taps, nbins: int, block: int, decim: int = 1,
                 device=None):
        super().__init__()
        if decim > 1 and block % (decim * nbins):
            raise ValueError(
                f"a block of {block} samples is not a multiple of decim * "
                f"nbins = {decim * nbins}: the next block would start off "
                f"the decimation's phase")
        taps = np.asarray(taps)
        self.nbins, self.k, self.decim = nbins, len(taps), decim
        self.prev_pad = min(128, nbins)
        self.form = fir_fft_form(self.k, nbins, decim, block)
        device = placement.resolve(device)
        self.span = "pc.fir_fft." + self.form
        with build("pc.build.fir_fft." + self.form,
                   key=(self.form, self.k, nbins, block, decim, device)):
            self._build(taps, device)

    def _build(self, taps, device) -> None:
        """The form's constants and operators, as buffers on ``device``."""
        nbins = self.nbins
        if self.form == "one_pass":
            H, gt = fused_chain_consts(taps, nbins, ONE_PASS_PP)
            ops = dict(H=H, gt=gt)
        elif self.form == "combined":
            gr, gi = stack_combined_operators(*combined_fir_fft_operators(
                taps, nbins, self.prev_pad))
            ops = dict(gr=gr, gi=gi)
        elif self.form == "toeplitz":
            t0, t1 = fir_toeplitz_matrices(taps)
            ops = dict(t0=t0, t1=t1)
        elif self.form == "polyphase":
            h = np.asarray(taps, np.complex128)
            ops = dict(taps=torch.from_numpy(
                np.stack([h.real, h.imag], -1).astype(np.float32)))
        else:
            ops = dict(kernel=complex_fir_kernel(taps))
        for name, op in ops.items():
            self.register_buffer(name, op.to(device))

    def forward(self, x: torch.Tensor, carry: torch.Tensor):
        """x [C, T, 2], carry [C, K-1, 2] -> (spectra
        [C, T//decim//nbins, nbins, 2], carry), inside the span
        ``pc.fir_fft.<form>``."""
        with annotate(self.span):
            if self.form == "one_pass":
                return one_pass_step(x, carry, self.H, self.gt, self.k)
            if self.form == "combined":
                return fir_fft_combined_step(x, carry, self.gr, self.gi,
                                             self.nbins, self.k,
                                             self.prev_pad)
            if self.form == "toeplitz":
                return fir_fft_step_mm(x, carry, self.t0, self.t1,
                                       self.nbins)
            if self.form == "polyphase":
                y, carry = k4.fir_decim(x, carry, self.taps, self.decim)
                return _frames_fft(y, self.nbins), carry
            return fir_fft_step(x, carry, self.kernel, self.nbins,
                                self.decim)


def fir_fft_chain(taps, nbins: int, channels: int, block: int,
                  decim: int = 1, device=None):
    """Build the chain and its initial carry: returns (run, hist0) with
    ``run(x, carry) -> (spectra, carry)`` a :class:`FirFftChain` and
    hist0 zeros [channels, K-1, 2] on ``device`` (default: the card)."""
    device = placement.resolve(device)
    run = FirFftChain(taps, nbins, block, decim, device)
    hist0 = torch.zeros((channels, run.k - 1, 2), dtype=torch.float32,
                        device=device)
    return run, hist0


# ---------------------------------------------------------------------- #
# FM receive chain (the 256-channel BASELINE config #4):
# freq_demod -> dc_removal -> envelope
# ---------------------------------------------------------------------- #
def freq_demod_planar(x: torch.Tensor, last: torch.Tensor):
    """FM discriminator on planar complex: out[i] = arg(x[i] * conj(x[i-1]))
    (reference: demod/FreqDemod.cpp:49-71). x: [C, T, 2]; last: [C, 1, 2].
    Returns (y [C, T] float32, new_last [C, 1, 2])."""
    prev = torch.cat([last, x[:, :-1, :]], dim=1)
    prod = cplx.mul(x, cplx.conj(prev))
    y = torch.atan2(prod[..., 1], prod[..., 0])
    # a copy, so the carry does not hold the whole block alive
    return y, x[:, -1:, :].clone()


def _f32_array(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"expected a float32 array, got {a.dtype}")
    return np.array(a, order="C")  # a writable copy the tensor may own


def operators_from_numpy(ops, device=None):
    """The JAX package's operator arrays (nested tuples of float32 arrays,
    as its operator builders return them after ``np.asarray``) -> the
    same nesting of tensors on ``device`` (default: the card)."""
    if isinstance(ops, (tuple, list)):
        return tuple(operators_from_numpy(o, device) for o in ops)
    return torch.from_numpy(_f32_array(ops)).to(placement.resolve(device))


def carry_from_numpy(hist, device=None) -> torch.Tensor:
    """A JAX-side carry hist [C, K-1, 2] (float32) -> tensor on ``device``
    (default: the card)."""
    return torch.from_numpy(_f32_array(hist)).to(placement.resolve(device))
