"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: max |kernel - plain| / max |plain| below 1e-5 for cgemm (both
variants; the tensor-core one also against float64) and
the one-pass FIR+FFT (float32 sums over at most a few hundred terms, in
another order) and 2e-5 for the FFT (as the JAX package's FFT test);
spectra of the chains below 1e-5 against the same chain on the CPU;
carries exact. The probes P1 and P2 equal their plain versions bit for
bit (x 2 and permutations are exact); E1 within rtol 1e-5 / atol 1e-6
(tests/test_filter.py's envelope bound); F1 (the discriminator and DC
cascade in one pass) within 8 float32 ulps of max |y| of its plain
version (window sums from float64 sums in another order), its
discriminator carry exact; the FM chain and FM topology on
the card within 1e-4 absolute of the CPU (cumulative sums of DC removal
taken in another order, on outputs of order 1). S1 (the frame-sync
search) and its plain version within the float64 oracle's bounds of
tests/test_torch_framing.py; the modem segment on the card bit-exact
with the CPU, labels included; the link on the card bit-exact on every
channel. The source-headed wave chain within 1e-4 of max |spectrum| of a
float64 oracle; the noise walk on the card equal to its plain version bit
for bit, and the FM segment it heads within 1e-4 of the CPU; each fusable
math block on the card within the bound of core/testing.FUSED_MATH_CASES
of its CPU streaming path (bit for bit where the case says so).
"""

import numpy as np
import pytest
import torch

from pothoscomms_tpu_torch.kernels.cgemm import (
    SIMT, TENSOR_CORES, cgemm, cgemm_plain, tf32_operator,
    tf32_operator_plain, variant)
from pothoscomms_tpu_torch.kernels.envelope import (envelope_rows,
                                                    envelope_rows_plain)
from pothoscomms_tpu_torch.kernels.fft import fft_c2c, fft_c2c_plain
from pothoscomms_tpu_torch.kernels.fir_decim import fir_decim
from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
    fir_fft_fused, fir_fft_fused_plain, make_fused_chain)
from pothoscomms_tpu_torch.kernels.fm_demod_dc import (fm_demod_dc,
                                                       fm_demod_dc_plain)
from pothoscomms_tpu_torch.kernels.iir_df2t import iir_df2t
from pothoscomms_tpu_torch.kernels.iir_df2t import plan as i1_plan
from pothoscomms_tpu_torch.kernels.layout_move import (MODES, layout_move,
                                                       layout_move_plain)
from pothoscomms_tpu_torch.kernels.stream_scale import (stream_scale,
                                                        stream_scale_plain)
from pothoscomms_tpu_torch.parallel.chain import (
    combined_fir_fft_operators, fir_fft_chain, fir_fft_form,
    stack_combined_operators)
from pothoscomms_tpu_torch.core.testing import (FUSED_MATH_CASES,
                                                fused_math_agree,
                                                fused_math_feeds,
                                                fused_math_run)
from pothoscomms_tpu_torch.parallel.fft import fft_planar

torch.set_num_threads(1)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs a CUDA card (the kernels have no CPU "
                              "mode)"),
]


@pytest.fixture
def dev():
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _normal(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (37, 100, 77), (64, 256, 128),
                                   (130, 17, 200), (5, 0, 9), (3, 2, 1),
                                   (8, 8, 1024), (200, 1024, 8)])
def test_cgemm_kernel_matches_plain(dev, b, n, m):
    rng = np.random.default_rng(b * 1000 + n)
    a = _normal(rng, b, n, 2).to(dev)
    gr, gi = _normal(rng, n, m).to(dev), _normal(rng, n, m).to(dev)
    before = cgemm.launches
    by_variant = dict(cgemm.launches_by_variant)
    got = cgemm(a, gr, gi)
    ref = cgemm_plain(a, gr, gi)
    torch.cuda.synchronize()
    assert cgemm.launches == before + 1
    by_variant[variant(n, m)] += 1
    assert cgemm.launches_by_variant == by_variant
    assert got.shape == (b, m, 2)
    if n == 0:
        assert not got.any()
    else:
        assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("b", [32768, 16384 + 37])
def test_cgemm_tensor_cores_at_main_path_shape(dev, b):
    """The main path's product, [B, 1152] x [1152, 1024] with the chain's
    stacked 64-tap combined operator, on the tensor-core variant (the
    ragged B leaves a partial last row tile), against the plain version
    and a float64 product."""
    rng = np.random.default_rng(b)
    taps = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
    gr, gi = (g.to(dev) for g in stack_combined_operators(
        *combined_fir_fft_operators(taps, 1024, 128)))
    a = _normal(rng, b, 1152, 2).to(dev)
    by_variant = dict(cgemm.launches_by_variant)
    operators = tf32_operator.launches
    got = cgemm(a, gr, gi)
    ref = cgemm_plain(a, gr, gi)
    torch.cuda.synchronize()
    assert cgemm.launches_by_variant[TENSOR_CORES] \
        == by_variant[TENSOR_CORES] + 1
    assert tf32_operator.launches == operators + 1
    assert cgemm.launches_by_variant[SIMT] == by_variant[SIMT]
    assert _rel(got, ref) < 1e-5
    g64 = torch.complex(gr.double(), gi.double())
    exp = torch.view_as_real(torch.view_as_complex(a).to(torch.complex128)
                             @ g64)
    assert _rel(got.double(), exp) < 1e-5


@pytest.mark.parametrize("n,m", [(1152, 1024), (100, 77), (33, 17)])
def test_tf32_operator_kernel_equals_plain(dev, n, m):
    """The operator kernel's embedding and TF32 split, bit for bit."""
    rng = np.random.default_rng(n + m)
    gr, gi = _normal(rng, n, m).to(dev), _normal(rng, n, m).to(dev)
    before = tf32_operator.launches
    hi, lo = tf32_operator(gr, gi)
    phi, plo = tf32_operator_plain(gr, gi)
    torch.cuda.synchronize()
    assert tf32_operator.launches == before + 1
    assert torch.equal(hi, phi) and torch.equal(lo, plo)


# chip_smoke.py phase 4's sizes: every power of two, 7-smooth sizes (the
# Stockham plan's mixed radices) and a prime (the direct DFT)
FFT_SIZES = [1] + [2 ** k for k in range(1, 13)] + [48, 100, 384, 1000,
                                                    1536, 2187, 2401, 3000,
                                                    4093]


@pytest.mark.parametrize("n", FFT_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_matches_plain_and_numpy(dev, n, inverse):
    """B = 37 leaves a ragged last block for every rows-per-block > 1."""
    rng = np.random.default_rng(n)
    x = _normal(rng, 37, n, 2)
    before = fft_c2c.launches
    got = fft_c2c(x.to(dev), inverse)
    ref = fft_c2c_plain(x.to(dev), inverse)
    torch.cuda.synchronize()
    assert fft_c2c.launches == before + 1
    assert _rel(got, ref) < 2e-5
    xc = x[..., 0].double().numpy() + 1j * x[..., 1].double().numpy()
    exp = np.fft.ifft(xc, axis=-1) * n if inverse else np.fft.fft(xc, axis=-1)
    g = got.cpu().numpy()
    g = g[..., 0] + 1j * g[..., 1]
    assert np.max(np.abs(g - exp)) / np.max(np.abs(exp)) < 2e-5


def test_wrappers_raise_instead_of_falling_back(dev):
    a = torch.zeros(4, 8, 2, device=dev)
    g = torch.zeros(8, 3, device=dev)
    with pytest.raises(ValueError):
        cgemm(a.transpose(0, 1), torch.zeros(4, 3, device=dev),
              torch.zeros(4, 3, device=dev))
    with pytest.raises(ValueError):
        cgemm(a, g.t().contiguous().t(), g)
    with pytest.raises(ValueError):
        fft_c2c(torch.zeros(2, 8192, 2, device=dev))
    with pytest.raises(ValueError):
        fft_c2c(a.transpose(0, 1))


@pytest.mark.parametrize("n", [8192, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_planar_long_rows_on_card(dev, n, inverse):
    """Rows above K2's 4096 take the two-factor split, both factors on
    K2; the JAX fft_planar takes any n, and so must the port."""
    rng = np.random.default_rng(n + inverse)
    x = _normal(rng, 6, n, 2)
    before = fft_c2c.launches
    got = fft_planar(x.to(dev), n, inverse)
    ref = fft_c2c_plain(x.to(dev), inverse)
    torch.cuda.synchronize()
    assert fft_c2c.launches == before + 2
    assert _rel(got, ref) < 2e-5
    xc = x[..., 0].double().numpy() + 1j * x[..., 1].double().numpy()
    exp = np.fft.ifft(xc, axis=-1) * n if inverse else np.fft.fft(xc, axis=-1)
    g = got.cpu().numpy()
    g = g[..., 0] + 1j * g[..., 1]
    assert np.max(np.abs(g - exp)) / np.max(np.abs(exp)) < 2e-5


@pytest.mark.parametrize("b,n,pp,s,corr", [
    (37, 1024, 64, 64, True), (37, 1024, 64, 64, False),
    (1, 1024, 64, 64, True), (4096, 1024, 64, 64, True),
    (10, 16, 8, 8, True), (6, 2, 256, 2, True),
    # every window length, ragged last blocks, supports at and above the
    # pruned first pass's n / 16, pp from 0 (no correction) to 256
    (37, 1024, 63, 63, True), (37, 1024, 1, 1, True),
    (37, 1024, 256, 256, True), (5, 1024, 256, 65, True),
    (37, 1024, 0, 1, True), (37, 512, 64, 32, True), (37, 512, 64, 33, True),
    (70, 256, 64, 16, True), (70, 256, 63, 63, True), (70, 128, 17, 8, True),
    (70, 128, 64, 128, True), (300, 64, 64, 4, True), (300, 64, 64, 64, True),
    (300, 32, 8, 2, True), (300, 32, 256, 32, True), (300, 16, 8, 16, True),
    (300, 8, 1, 8, True), (300, 8, 64, 3, False), (300, 4, 64, 4, True),
    (300, 2, 1, 1, True)])
def test_fir_fft_fused_kernel_matches_plain(dev, b, n, pp, s, corr):
    """K3 against its plain version, ragged B (not a multiple of the
    kernel's windows per block) and uw=None included; gt [pp, s]."""
    rng = np.random.default_rng(b * 7 + n + pp + s)
    x = _normal(rng, b, n, 2).to(dev)
    uw = _normal(rng, b, pp, 2).to(dev) if corr else None
    H = _normal(rng, n, 2).to(dev)
    gt = _normal(rng, pp, s, 2).to(dev)
    before = fir_fft_fused.launches
    got = fir_fft_fused(x, uw, H, gt)
    ref = fir_fft_fused_plain(x, uw, H, gt)
    torch.cuda.synchronize()
    assert fir_fft_fused.launches == before + 1
    assert got.shape == (b, n, 2)
    assert _rel(got, ref) < 1e-5


def test_fir_fft_fused_raises_instead_of_falling_back(dev):
    x = torch.zeros(8, 1024, 2, device=dev)
    uw = torch.zeros(8, 64, 2, device=dev)
    H = torch.zeros(1024, 2, device=dev)
    g = torch.zeros(64, 64, 2, device=dev)
    with pytest.raises(ValueError):          # non-contiguous x
        fir_fft_fused(x.transpose(0, 1).contiguous().transpose(0, 1), uw,
                      H, g)
    with pytest.raises(ValueError):          # non-contiguous operator
        fir_fft_fused(x, uw, H, g.transpose(0, 1).contiguous()
                      .transpose(0, 1))
    with pytest.raises(ValueError):          # n above the kernel's 1024
        x2 = torch.zeros(2, 2048, 2, device=dev)
        fir_fft_fused(x2, None, torch.zeros(2048, 2, device=dev), g)
    with pytest.raises(ValueError):          # n not a power of two
        x3 = torch.zeros(2, 100, 2, device=dev)
        fir_fft_fused(x3, None, torch.zeros(100, 2, device=dev), g)
    with pytest.raises(ValueError):          # pp above the kernel's 256
        fir_fft_fused(x, torch.zeros(8, 257, 2, device=dev), H,
                      torch.zeros(257, 64, 2, device=dev))
    with pytest.raises(ValueError):          # operand on another device
        fir_fft_fused(x, uw.cpu(), H, g)


def test_fused_chain_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    C, T, K = 4, 8192, 64
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    run_c = make_fused_chain(taps, 1024, device=dev)
    run_h = make_fused_chain(taps, 1024, device="cpu")
    carry_c = torch.zeros(C, K - 1, 2, device=dev)
    carry_h = torch.zeros(C, K - 1, 2)
    before = fir_fft_fused.launches
    for _ in range(3):
        x = _normal(rng, C, T, 2)
        spec_c, carry_c = run_c.run(x.to(dev), carry_c)
        spec_h, carry_h = run_h.run(x, carry_h)
        assert _rel(spec_c.cpu(), spec_h) < 1e-5
        assert torch.equal(carry_c.cpu(), carry_h)
    assert fir_fft_fused.launches == before + 3


@pytest.mark.parametrize("k,nb,decim,form", [
    (64, 1024, 1, "one_pass"), (100, 64, 1, "toeplitz"),
    (200, 1024, 1, "conv"), (64, 1024, 2, "polyphase"),
    (65, 1024, 1, "one_pass"), (66, 1024, 1, "combined"),
    (64, 512, 1, "combined")])
def test_chain_on_card_matches_cpu(dev, k, nb, decim, form):
    """Each step of the one-pass form is one K3 launch and no K1 launch;
    each of the polyphase form one K4 launch."""
    rng = np.random.default_rng(k + nb)
    C, T = 8, 4096
    taps = (rng.normal(size=k) + 1j * rng.normal(size=k)) / k
    run_c, carry_c = fir_fft_chain(taps, nb, C, T, decim, device=dev)
    run_h, carry_h = fir_fft_chain(taps, nb, C, T, decim,
                                     device="cpu")
    assert run_c.form == run_h.form == form
    for _ in range(3):
        x = _normal(rng, C, T, 2).to(dev)
        k3, k1, k4 = (fir_fft_fused.launches, cgemm.launches,
                      fir_decim.launches)
        spec_c, carry_c = run_c(x, carry_c)
        if form == "one_pass":
            assert (fir_fft_fused.launches - k3, cgemm.launches - k1) == (1, 0)
        if form == "polyphase":
            assert fir_decim.launches - k4 == 1
        spec_h, carry_h = run_h(x.cpu(), carry_h)
        assert _rel(spec_c.cpu(), spec_h) < 1e-5
        assert torch.equal(carry_c.cpu(), carry_h)


@pytest.mark.parametrize("fuse", [True, False])
def test_block_path_topology_on_card(dev, fuse):
    """feeder -> /comms/fir_filter -> /comms/fft -> collector on
    Topology(device="cuda:0"): fused, the pair core runs the form
    fir_fft_form picks for 33 taps at 256 bins (combined, on K1) and the
    drain streams the FFT on K2; unfused, the FIR streams on the card and
    every window goes through K2. Matches the same topology on the CPU."""
    from pothoscomms_tpu_torch import BlockRegistry, Topology
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource

    rng = np.random.default_rng(9)
    taps = (rng.normal(size=33) + 1j * rng.normal(size=33)) / 33
    feeds = [(rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64) for n in (3 * 4096 + 5, 2 * 4096 + 777)]

    def run(device):
        fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
        fir.set_taps(taps)
        fft = BlockRegistry.make("/comms/fft", "complex_float32", 256, False)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device=device)
        topo.auto_fuse = fuse
        topo.fuse_threshold = 4096
        for a, b in ((feed, fir), (fir, fft), (fft, sink)):
            topo.connect(a, 0, b, 0)
        for x in feeds:
            feed.feed_buffer(x)
        topo.commit()
        assert topo.wait_inactive()
        return sink.get_buffer(), topo

    before = (cgemm.launches, fft_c2c.launches)
    got, topo = run(dev)
    torch.cuda.synchronize()
    k1, k2 = cgemm.launches - before[0], fft_c2c.launches - before[1]
    ref, _ = run("cpu")
    if fuse:
        assert fir_fft_form(33, 256, 1, 256) == "combined"
        assert topo._segments[0].pair_engaged and k1 >= 1
    assert k2 >= 1
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("b,n,tb", [(512, 1024, 256), (37, 1024, 128),
                                    (5, 7, 2), (1000, 36, 512), (1, 4, 1)])
def test_stream_scale_kernel_equals_plain(dev, b, n, tb):
    rng = np.random.default_rng(b + n)
    xr, xi = _normal(rng, b, n).to(dev), _normal(rng, b, n).to(dev)
    before = stream_scale.launches
    yr, yi = stream_scale(xr, xi, tb)
    rr, ri = stream_scale_plain(xr, xi, tb)
    torch.cuda.synchronize()
    assert stream_scale.launches == before + 1
    assert torch.equal(yr, rr) and torch.equal(yi, ri)


@pytest.mark.parametrize("tb", [128, 256, 512])
def test_stream_scale_splits_tiles_across_the_card(dev, tb):
    """[8192, 1024]: 64, 32 or 16 of the probe's tiles, fewer than the
    card's SMs; the grid fills the card whatever tb is; still exact."""
    rng = np.random.default_rng(tb)
    xr, xi = _normal(rng, 8192, 1024).to(dev), _normal(rng, 8192, 1024).to(dev)
    before = stream_scale.launches
    yr, yi = stream_scale(xr, xi, tb)
    torch.cuda.synchronize()
    assert stream_scale.launches == before + 1
    assert torch.equal(yr, xr * 2) and torch.equal(yi, xi * 2)


def test_stream_scale_unaligned_view(dev):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar path and is still exact."""
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 64 * 33 + 1).to(dev)
    xr = x[0, 1:].view(33, 64)
    xi = x[1, 1:].view(33, 64)
    yr, yi = stream_scale(xr, xi, 8)
    torch.cuda.synchronize()
    assert torch.equal(yr, xr * 2) and torch.equal(yi, xi * 2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,n", [(256, 1024), (13, 1024), (3, 64),
                                 (9, 8192), (5, 192)])
def test_layout_move_kernel_equals_plain(dev, mode, b, n):
    rng = np.random.default_rng(b * n)
    x = _normal(rng, b, n).to(dev)
    before = layout_move.launches
    got = layout_move(x, mode)
    ref = layout_move_plain(x, mode)
    torch.cuda.synchronize()
    assert layout_move.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("P,T,L,Wr", [
    (4, 65536, 8192, 8192), (3, 4096, 4096, 0), (2, 1000, 1000, 0),
    (1, 32768, 1024, 2048), (7, 96, 32, 64), (5, 3, 1, 1),
    # P * nb below, at and above one warp; Wr off the tile of 32 steps
    # (aligned: 4 | Wr; scalar: odd Wr), above L, and longer than a
    # channel's first rows; odd L; a ragged last tile; T = L
    (256, 16384, 1024, 1024), (3, 8192, 1024, 1000), (33, 4096, 128, 36),
    (1, 4096, 128, 132), (9, 2079, 99, 198), (2, 4099, 4099, 0),
    (31, 1001, 143, 77), (1, 36, 36, 0), (40, 640, 20, 8)])
def test_envelope_kernel_matches_plain(dev, P, T, L, Wr):
    rng = np.random.default_rng(P * T + L)
    mag = torch.from_numpy(np.abs(rng.standard_normal((P, T),
                                                      dtype=np.float32)))
    env0 = torch.from_numpy(np.abs(rng.standard_normal(P, dtype=np.float32)))
    ga, gr = np.float32(np.exp(-1 / 10.0)), np.float32(np.exp(-1 / 40.0))
    before = envelope_rows.launches
    y, e = envelope_rows(mag.to(dev), env0.to(dev), ga, gr, L, Wr)
    torch.cuda.synchronize()
    assert envelope_rows.launches == before + 1
    yp, ep = envelope_rows_plain(mag, env0, ga, gr, L, Wr)
    np.testing.assert_allclose(y.cpu().numpy(), yp.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(e.cpu().numpy(), ep.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("L,Wr", [(1024, 1024), (4096, 0), (64, 200)])
def test_envelope_unaligned_view_equals_plain(dev, L, Wr):
    """Contiguous views of mag that start 4, 8 and 12 bytes off a 16-byte
    boundary take the kernel's scalar loads and stores; as every other
    shape they equal the plain version bit for bit."""
    rng = np.random.default_rng(L + Wr)
    P, T = 5, 4096
    ga, gr = np.float32(np.exp(-1 / 4.0)), np.float32(np.exp(-1 / 16.0))
    env0 = torch.from_numpy(np.abs(rng.standard_normal(P, dtype=np.float32)))
    for off in (1, 2, 3):
        flat = torch.from_numpy(np.abs(rng.standard_normal(
            P * T + off, dtype=np.float32))).to(dev)
        mag = flat[off:].view(P, T)
        assert mag.data_ptr() % 16 == 4 * off and mag.is_contiguous()
        y, e = envelope_rows(mag, env0.to(dev), ga, gr, L, Wr)
        yp, ep = envelope_rows_plain(mag, env0.to(dev), ga, gr, L, Wr)
        torch.cuda.synchronize()
        assert torch.equal(y, yp) and torch.equal(e, ep)


def test_layout_move_unaligned_view(dev):
    """A contiguous view that starts off a 16-byte boundary takes the
    scalar global accesses and is still exact, in every mode."""
    rng = np.random.default_rng(4)
    x = _normal(rng, 1, 1024 * 13 + 1).to(dev)[0, 1:].view(13, 1024)
    assert x.data_ptr() % 16 != 0
    for mode in MODES:
        got = layout_move(x, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, layout_move_plain(x, mode))


def test_probe_and_envelope_wrappers_raise(dev):
    x = torch.zeros(8, 1024, device=dev)
    with pytest.raises(ValueError):          # non-contiguous plane
        stream_scale(x.t(), x.t())
    with pytest.raises(ValueError):          # N above the tile
        layout_move(torch.zeros(2, 16384, device=dev), "A")
    with pytest.raises(ValueError):          # non-contiguous
        layout_move(torch.zeros(1024, 64, device=dev).t(), "B")
    with pytest.raises(ValueError):          # non-contiguous
        envelope_rows(x.t(), torch.zeros(1024, device=dev), 0.5, 0.5, 8, 0)
    with pytest.raises(ValueError):          # env0 on another device
        envelope_rows(x, torch.zeros(8), 0.5, 0.5, 1024, 0)


def _fm_blocks(d=16, casc=2, attack=10.0, release=40.0):
    from pothoscomms_tpu_torch import BlockRegistry

    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(d)
    dc.set_cascade_size(casc)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(attack)
    env.set_release(release)
    return [demod, dc, env]


@pytest.mark.parametrize("C,T", [(8, 2048), (2, 32768)])
def test_fm_compile_chain_on_card_matches_cpu(dev, C, T):
    """The FM chain through compile_chain on the card (F1 for the
    discriminator and DC removal; E1 unblocked at T=2048, blocked at
    T=32768) against the same chain on the CPU, over two chained steps."""
    from pothoscomms_tpu_torch.parallel.compiler import compile_chain

    rng = np.random.default_rng(C + T)
    step_c, carry_c = compile_chain(_fm_blocks(), C, device=dev)
    step_h, carry_h = compile_chain(_fm_blocks(), C, device="cpu")
    before = envelope_rows.launches
    f1_before = fm_demod_dc.launches
    for _ in range(2):
        phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, T)), axis=1)
        x = torch.from_numpy(np.stack([np.cos(phase), np.sin(phase)],
                                      -1).astype(np.float32))
        y_c, carry_c = step_c(x.to(dev), carry_c)
        y_h, carry_h = step_h(x, carry_h)
        np.testing.assert_allclose(y_c.cpu().numpy(), y_h.numpy(),
                                   rtol=0, atol=1e-4)
        for a, b in zip(carry_c, carry_h):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-4)
    torch.cuda.synchronize()
    assert envelope_rows.launches == before + 2
    assert fm_demod_dc.launches == f1_before + 2


def _fm_planar(rng, C, T, offset=0.0):
    phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, T)) + offset, axis=1)
    return torch.from_numpy(np.stack([np.cos(phase), np.sin(phase)],
                                     -1).astype(np.float32))


F1_ULPS = 8 * 2.0 ** -24   # F1 against its plain version, a share of max|y|


@pytest.mark.parametrize("casc", [1, 2, 3])
@pytest.mark.parametrize("D", [16, 64, 512])
@pytest.mark.parametrize("T", ["D", 3 * 1920 + 5, 16384, 131072])
@pytest.mark.parametrize("C", [1, 3, 256])
def test_fm_demod_dc_kernel_matches_plain(dev, C, T, D, casc):
    """F1 against the two cores' ops on the card over 3 chained steps,
    each side on its own carries: outputs and histories within 8 float32
    ulps of their largest magnitude (window sums from float64 sums in
    another order), the discriminator's carry exact."""
    T = D if T == "D" else T
    rng = np.random.default_rng(C * 131 + T + D * 7 + casc)
    last_k = torch.zeros(C, 1, 2, device=dev)
    hists_k = torch.zeros(casc, C, D, device=dev)
    last_p, hists_p = last_k.clone(), hists_k.clone()
    for step in range(3):
        x = _fm_planar(rng, C, T, 0.1 * step).to(dev)
        before = fm_demod_dc.launches
        y_k, last_k, hists_k = fm_demod_dc(x, last_k, hists_k, D, casc)
        torch.cuda.synchronize()
        assert fm_demod_dc.launches == before + 1
        y_p, last_p, hists_p = fm_demod_dc_plain(x, last_p, hists_p, D,
                                                 casc)
        assert y_k.shape == (C, T) and y_k.dtype == torch.float32
        assert (y_k - y_p).abs().max().item() <= \
            F1_ULPS * y_p.abs().max().item()
        assert torch.equal(last_k, last_p)
        assert (hists_k - hists_p).abs().max().item() <= \
            F1_ULPS * hists_p.abs().max().item()


def test_fm_demod_dc_holds_float32_resolution_at_a_dc_offset(dev):
    """The DC-offset case through F1: one 2^24-sample block whose
    discriminator output has a mean of 0.25. F1 holds the float64 cascade
    of that output to 1e-6; float32 prefix sums (the JAX package's) lose
    more than 1e-4."""
    from pothoscomms_tpu_torch.parallel.chain import freq_demod_planar

    D, casc, T = 64, 2, 1 << 24
    x = _fm_planar(np.random.default_rng(32), 1, T, 0.25).to(dev)
    last = torch.zeros(1, 1, 2, device=dev)
    y, _, _ = fm_demod_dc(x, last, torch.zeros(casc, 1, D, device=dev), D,
                          casc)
    u = freq_demod_planar(x, last)[0][0].cpu().numpy()
    assert abs(float(u.mean()) - 0.25) < 0.01

    def cascade(cur, cumsum):
        delayed = np.concatenate([np.zeros(D, cur.dtype), cur])[1:1 + T]
        for _ in range(casc):
            cs = cumsum(np.concatenate([np.zeros(D, cur.dtype), cur]))
            cur = (cs[D:] - cs[:-D]) / cur.dtype.type(D)
        return delayed - cur

    ref = cascade(u.astype(np.float64), np.cumsum)
    f32 = cascade(u, lambda a: np.cumsum(a, dtype=np.float32))
    assert np.max(np.abs(f32 - ref)) > 1e-4
    assert np.max(np.abs(y[0].cpu().numpy() - ref)) < 1e-6


def test_fm_demod_dc_wrapper_raises_on_card(dev):
    x = torch.zeros(4, 256, 2, device=dev)
    last = torch.zeros(4, 1, 2, device=dev)
    hists = torch.zeros(2, 4, 64, device=dev)
    with pytest.raises(ValueError):          # non-contiguous
        fm_demod_dc(x.transpose(0, 1).contiguous().transpose(0, 1), last,
                    hists, 64, 2)
    with pytest.raises(ValueError):          # 4-byte aligned
        fm_demod_dc(torch.zeros(4 * 256 * 2 + 1, device=dev)[1:].view(
            4, 256, 2), last, hists, 64, 2)
    with pytest.raises(ValueError):          # hists on the CPU
        fm_demod_dc(x, last, hists.cpu(), 64, 2)
    with pytest.raises(ValueError):          # T < D
        fm_demod_dc(x[:, :32].contiguous(), last, hists, 64, 2)


def test_fm_topology_on_card_matches_cpu(dev):
    """feeder -> freq_demod -> dc_removal -> envelope -> collector on
    Topology(device="cuda:0"), fused (two blocked pulls of 2^16 on E1,
    then a streamed drain), against the same topology on the CPU."""
    from pothoscomms_tpu_torch import Topology
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource

    rng = np.random.default_rng(12)
    phase = np.cumsum(rng.normal(size=(1 << 17) + 5) * 0.2)
    x = np.exp(1j * phase).astype(np.complex64)

    def run(device):
        blocks = _fm_blocks(32, 2, 4.0, 16.0)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("float32")
        topo = Topology(device=device)
        topo.fuse_threshold = 4096
        chain = [feed] + blocks + [sink]
        for a, b in zip(chain[:-1], chain[1:]):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(x)
        topo.commit()
        assert topo.wait_inactive(timeout=60.0)
        return sink.get_buffer(), topo

    before = envelope_rows.launches
    got, topo = run(dev)
    torch.cuda.synchronize()
    launched = envelope_rows.launches - before
    ref, _ = run("cpu")
    assert topo._segments[0].engage_count >= 1 and launched >= 2
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,n,m", [(4096, 320, 256), (4096, 192, 128),
                                   (4096, 128, 64), (4096, 288, 384),
                                   (333, 192, 128)])
def test_cgemm_at_split_and_resampler_shapes(dev, b, n, m):
    """K1 at the split step's per-stream shapes (pp + W, W for R = 4, 8,
    16 at 1024 bins, pp = 64) and the 3:2 resampler's (32 + 256, 384),
    on the tensor cores, against its plain version."""
    rng = np.random.default_rng(b + n + m)
    a = _normal(rng, b, n, 2).to(dev)
    gr, gi = _normal(rng, n, m).to(dev), _normal(rng, n, m).to(dev)
    assert variant(n, m) == TENSOR_CORES
    before = cgemm.launches_by_variant[TENSOR_CORES]
    got = cgemm(a, gr, gi)
    buf = torch.full((3, b, m, 2), 7.0, device=dev)
    into = cgemm(a, gr, gi, out=buf[1])       # a slot of one buffer
    torch.cuda.synchronize()
    assert cgemm.launches_by_variant[TENSOR_CORES] == before + 2
    assert _rel(got, cgemm_plain(a, gr, gi)) < 1e-5
    assert into.data_ptr() == buf[1].data_ptr() and torch.equal(into, got)
    assert bool((buf[0] == 7.0).all() and (buf[2] == 7.0).all())


@pytest.mark.parametrize("R", [4, 8, 16])
def test_split_step_on_card_matches_cpu(dev, R):
    """make_split_step on the card (R K1 launches a step) against the
    same step on the CPU, two chained steps, carry exact."""
    from pothoscomms_tpu_torch.parallel.chain import make_split_step

    rng = np.random.default_rng(R)
    taps = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
    C, T, NB = 8, 8192, 1024
    run_c, _ = make_split_step(taps, NB, R, 64, device=dev)
    run_h, _ = make_split_step(taps, NB, R, 64, device="cpu")
    h_c = torch.zeros(C, 63, 2, device=dev)
    h_h = torch.zeros(C, 63, 2)
    before = cgemm.launches
    for _ in range(2):
        x = _normal(rng, C, T, 2)
        s_c, h_c = run_c(x.to(dev), h_c)
        s_h, h_h = run_h(x, h_h)
        assert _rel(s_c.cpu(), s_h) < 1e-5
        assert torch.equal(h_c.cpu(), h_h)
    torch.cuda.synchronize()
    assert cgemm.launches == before + 2 * R


def _config3_blocks(taps):
    from pothoscomms_tpu_torch import BlockRegistry

    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                             "COMPLEX")
    fir.set_taps(taps)
    fir.set_decimation(2)
    fir.set_interpolation(3)
    return [fir, BlockRegistry.make("/comms/iir_filter", "complex_float32")]


@pytest.mark.parametrize("T", [1 << 15, 768])
def test_resampler_chain_on_card_matches_cpu(dev, T):
    """compile_chain([FIR 3:2, IIR]) on the card (one K1 launch and one
    I1 call a step, of two launches where I1's plan cuts the rows into
    segments: T = 2^15) against the CPU (the IIR's blocked form at
    L = 256 for T = 2^15, 128 for 768)."""
    from pothoscomms_tpu_torch.parallel.compiler import compile_chain

    rng = np.random.default_rng(T)
    taps = (rng.normal(size=60) + 1j * rng.normal(size=60)) / 60
    step_c, carry_c = compile_chain(_config3_blocks(taps), 4, device=dev)
    step_h, carry_h = compile_chain(_config3_blocks(taps), 4, device="cpu")
    before = (cgemm.launches, iir_df2t.launches)
    for _ in range(2):
        x = _normal(rng, 4, T, 2)
        y_c, carry_c = step_c(x.to(dev), carry_c)
        y_h, carry_h = step_h(x, carry_h)
        assert _rel(y_c.cpu(), y_h) < 1e-5
        for a, b in zip(carry_c, carry_h):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)
    torch.cuda.synchronize()
    assert cgemm.launches == before[0] + 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    segs = i1_plan(2, T * 3 // 2, 2, 4, sms).segs
    assert iir_df2t.launches == before[1] + 2 * (2 if segs > 1 else 1)


def test_config3_designer_topology_on_card(dev):
    """FIRDesigner -> FIR(3:2) -> IIR <- IIRDesigner on
    Topology(device="cuda:0"), fused, against the same topology on the
    CPU."""
    from pothoscomms_tpu_torch import BlockRegistry, Topology
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource

    rng = np.random.default_rng(19)
    n = (1 << 17) + 11
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)

    def run(device):
        fird = BlockRegistry.make("/comms/fir_designer")
        fird.set_band_type("LOW_PASS")
        fird.set_filter_type("SINC")
        fird.set_frequency_lower(0.2)
        fird.set_num_taps(60)
        iird = BlockRegistry.make("/comms/iir_designer")
        iird.set_frequency_lower(0.25)
        fir, iir = _config3_blocks([1.0])
        fir.set_wait_taps(True)
        iir.set_wait_taps(True)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device=device)
        topo.fuse_threshold = 4096
        topo.connect(fird, "tapsChanged", fir, "setTaps")
        topo.connect(iird, "tapsChanged", iir, "setTaps")
        for a, b in ((feed, fir), (fir, iir), (iir, sink)):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(x)
        topo.commit()
        assert topo.wait_inactive(timeout=60.0)
        return sink.get_buffer(), topo

    before = cgemm.launches
    got, topo = run(dev)
    torch.cuda.synchronize()
    launched = cgemm.launches - before
    ref, _ = run("cpu")
    assert topo._segments[0].engage_count >= 1 and launched >= 1
    assert got.shape == ref.shape and len(got) > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------- #
# S1, the modem segment and the link (the digital and framing layers)
# ---------------------------------------------------------------------- #
def _link_batch(rng, C, L, noise=0.01):
    """[C, L, 2] float32: zero gaps, then BPSK frames of 20 x 4 samples a
    preamble symbol, scaled, rotated and with noise ``noise``."""
    from pothoscomms_tpu_torch.parallel.link import (apply_channel,
                                                     tx_waveform)

    x = np.zeros((C, L, 2), np.float32)
    wave = tx_waveform(rng.integers(0, 2, 64).astype(np.uint8),
                       device="cpu")
    for c in range(C):
        wv = apply_channel(wave, gap_pre=100 + 37 * c, gap_post=0,
                           attenuation=0.3 + 0.1 * (c % 5), phase=0.2 * c,
                           freq_offset=1e-4 * ((c % 5) - 2), noise=noise,
                           rng=np.random.default_rng(c))
        m = min(len(wv), L)
        x[c, :m, 0], x[c, :m, 1] = wv[:m].real, wv[:m].imag
    return x


@pytest.mark.parametrize("C,L,pre_n,w,noise", [
    (1, 1024, 1, 80, 0.01), (7, 5000, 2, 40, 0.01), (64, 32768, 1, 80, 0.01),
    # FrameSync's long bucket, a four-symbol preamble, a noiseless batch
    # (channel 2 at zero frequency offset: K on the negative real axis)
    (1, 65536, 1, 80, 0.01), (5, 8192, 4, 20, 0.01), (8, 32768, 1, 80, 0.0)])
def test_sync_search_kernel_matches_plain_and_oracle(dev, C, L, pre_n, w,
                                                     noise):
    """S1 against its plain version and the float64 oracle, within the
    bounds of tests/test_torch_framing.py (scale 1e-5 relative, delta_fc
    1e-5, phase 2e-3 rad where |L| >= 1, peaks exact off near-integers;
    ill-conditioned and borderline offsets left out)."""
    from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                    sync_search_f64)
    from pothoscomms_tpu_torch.kernels.sync_search import (
        sync_search, sync_search_plain)

    rng = np.random.default_rng(C)
    x = _link_batch(rng, C, L, noise)
    pre = np.exp(1j * np.arange(pre_n) * 0.7)
    pre_p = np.stack([pre.real, pre.imag], -1).astype(np.float32)
    sw, dw = w * pre_n, 4
    n = L - sw - 58 * dw + 1
    xd, pd = torch.from_numpy(x).to(dev), torch.from_numpy(pre_p).to(dev)
    before = sync_search.launches
    got = [a.cpu().numpy() for a in sync_search(xd, pd, 0.01, sw, w, dw,
                                                pre_n, n)]
    torch.cuda.synchronize()
    assert sync_search.launches == before + 1
    plain = [a.cpu().numpy() for a in sync_search_plain(
        xd, pd, 0.01, sw, w, dw, pre_n, n)]
    ref = sync_search_f64(x, pre, 0.01, sw, w, dw, pre_n, n)
    for arrays in (got, plain):
        agree = search_agreement(arrays, ref)
        assert agree["scale_zero_mismatch"] == 0, agree
        assert agree["peak_mismatch"] == 0, agree
        assert agree["scale_rel"] <= 1e-5 and agree["delta_fc_abs"] <= 1e-5
        assert agree["phase_abs"] <= 2e-3, agree


def _s1_inputs(dev, C, L, noise, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_link_batch(rng, C, L, noise)).to(dev)
    return x, torch.tensor([[1.0, 0.0]], device=dev), \
        (0.01, 80, 80, 4, 1, L - 312 + 1)


@pytest.mark.parametrize("noise", [0.01, 0.0])
def test_sync_search_zero_scale_outputs_are_zero(dev, noise):
    """Where the plain version's scale is 0 (borderline offsets of the
    oracle left out), S1's scale, delta_fc and corr_peak are exactly 0, and
    wherever S1's own scale is 0 so are its delta_fc and corr_peak: no
    offset is skipped, and the zero-scale outputs are the function's."""
    from pothoscomms_tpu_torch.core.testing import sync_search_f64
    from pothoscomms_tpu_torch.kernels.sync_search import (
        sync_search, sync_search_plain)

    x, pre, args = _s1_inputs(dev, 8, 32768, noise)
    got = [a.cpu().numpy() for a in sync_search(x, pre, *args)]
    plain = [a.cpu().numpy() for a in sync_search_plain(x, pre, *args)]
    ref = sync_search_f64(x.cpu().numpy(), [1.0], *args)
    zero = (plain[0] == 0) & ~ref["borderline"]
    assert zero.sum() > 1000 and (~zero).sum() > 1000
    for k in (0, 1, 3):
        assert np.all(got[k][zero] == 0), k
    own = got[0] == 0
    assert np.all(got[1][own] == 0) and np.all(got[3][own] == 0)


# (C, L, w, plan): shapes whose launch takes each plan (k, threads) of the
# compiled kernel, and one whose symbol width's half 2 does not divide
S1_PLAN_SHAPES = [(16, 32768, 80, (2, 128)), (1, 65536, 80, (1, 128)),
                  (1, 32768, 80, (1, 64)), (16, 32768, 6, (1, 128))]


@pytest.mark.parametrize("C,L,w,plan", S1_PLAN_SHAPES)
def test_sync_search_counts_one_launch_at_every_plan(dev, C, L, w, plan):
    """The compiled kernel takes the plan named for the shape, a call adds
    one launch, and the outputs equal, bit for bit, those of a launch of
    the same channels in a batch of another size, at another plan (each
    offset's arithmetic does not depend on it)."""
    from pothoscomms_tpu_torch.kernels.sync_search import (card_plan,
                                                           sync_search)

    x = torch.from_numpy(_link_batch(np.random.default_rng(C), C, L)).to(dev)
    pre = torch.tensor([[1.0, 0.0]], device=dev)
    sw, dw = w, 4 if w > 8 else 1
    n = L - sw - 58 * dw + 1
    args = (0.01, sw, w, dw, 1, n)
    assert card_plan(C, n, w) == plan
    before = sync_search.launches
    got = sync_search(x, pre, *args)
    torch.cuda.synchronize()
    assert sync_search.launches == before + 1
    # channel 0 alone, or twice over
    other = x[:1].contiguous() if C > 1 else torch.cat([x, x]).contiguous()
    assert card_plan(other.shape[0], n, w) != plan
    again = sync_search(other, pre, *args)
    assert sync_search.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a[0], b[0])


def test_sync_search_plan_fills_the_card():
    """sync_search_plan: k = 2 consecutive offsets a thread at 128 threads
    where the grid has 264 blocks; else k, then the threads, halved; k = 1
    where 2 does not divide w / 2."""
    from pothoscomms_tpu_torch.kernels.sync_search import card_plan

    assert card_plan(256, 32457, 80) == (2, 128)
    assert card_plan(1, 32457, 80) == (1, 64)
    assert card_plan(1, 65225, 80) == (1, 128)
    assert card_plan(256, 32457, 20) == (2, 128)
    assert card_plan(256, 32457, 6) == (1, 128)
    assert card_plan(1, 1, 80) == (1, 64)


def test_sync_search_raises_instead_of_falling_back(dev):
    from pothoscomms_tpu_torch.kernels.sync_search import sync_search

    x = torch.zeros((2, 2048, 2), device=dev)
    pre = torch.tensor([[1.0, 0.0]], device=dev)
    with pytest.raises(ValueError):
        sync_search(x[:, ::2], pre, 0.01, 80, 80, 4, 1, 100)  # strided
    with pytest.raises(ValueError):
        sync_search(x, pre.cpu(), 0.01, 80, 80, 4, 1, 100)


def test_modem_segment_on_card_matches_cpu(dev):
    """The six-block modem segment fused on the card, both scrambler
    modes and labels on the feed: bits and labels equal to the same run
    on the CPU, and to the input."""
    from pothoscomms_tpu_torch import BlockRegistry, Label, Topology
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource

    table = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)
    bits = np.random.default_rng(20).integers(0, 2, 1 << 18).astype(np.uint8)

    def run(device, mode):
        blocks = [BlockRegistry.make("/comms/scrambler"),
                  BlockRegistry.make("/comms/bits_to_symbols", 2, "MSBit"),
                  BlockRegistry.make("/comms/symbol_mapper",
                                     "complex_float32"),
                  BlockRegistry.make("/comms/symbol_slicer",
                                     "complex_float32"),
                  BlockRegistry.make("/comms/symbols_to_bits", 2, "MSBit"),
                  BlockRegistry.make("/comms/descrambler")]
        for b in (blocks[0], blocks[-1]):
            b.set_mode(mode)
            b.set_poly(0x8E)
        blocks[2].set_map(table)
        blocks[3].set_map(table)
        feed, sink = FeederSource("uint8"), CollectorSink("uint8")
        topo = Topology(device=device)
        chain = [feed] + blocks + [sink]
        for a, b in zip(chain[:-1], chain[1:]):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(bits, [Label("f", i, 65536 * i + 3)
                                for i in range(4)])
        topo.commit()
        assert topo.wait_inactive(timeout=60.0)
        labels = [(lb.id, lb.data, lb.index) for lb in sink.get_labels()]
        return sink.get_buffer(), labels, topo._segments

    for mode in ("additive", "multiplicative"):
        got, labels, segs = run(dev, mode)
        ref, ref_labels, _ = run("cpu", mode)
        assert len(segs) == 1 and segs[0].fused_elements == 1 << 18
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, bits)
        assert labels == ref_labels and len(labels) == 4


def test_link_on_card_16_channels(dev):
    from pothoscomms_tpu_torch.kernels.sync_search import sync_search
    from pothoscomms_tpu_torch.parallel.link import run_link

    before = sync_search.launches
    res = run_link(16, n_bits=64, seed=7, device=dev)
    assert sync_search.launches == before + 1
    assert res["all_exact"], res["bit_exact"]


def test_link_receiver_on_card_against_reference(dev):
    """The receive entry at the benchmark's size, [256, 32768], on a window
    batch the benchmark's plain reference transmits: one S1 and one D1
    launch, every channel's payload bit-exact, and 8 channels within the
    configuration's limits of the float64 receiver; traced, the pc.link.*
    spans and pc.kernel.frame_decode are host ranges with no device row,
    and no channel is decoded on the host."""
    import importlib.util
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pothoscomms_tpu_torch.kernels.frame_decode import frame_decode
    from pothoscomms_tpu_torch.kernels.sync_search import sync_search
    from pothoscomms_tpu_torch.parallel import link
    from pothoscomms_tpu_torch.parallel.link import make_link_receiver

    bench = Path(__file__).resolve().parents[1] / "benchmark"
    name = "digital_link_bpsk_4000b"
    spec = importlib.util.spec_from_file_location(
        "_link_reference", bench / "reference" / f"{name}.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    cfg = json.loads((bench / "configs" / f"{name}.json").read_text())
    traffic = json.loads((bench / "traffic" / "link_ch256_b4000_pool4.json")
                         .read_text())
    batch = ref.pool(cfg, {**traffic, "pool": 1}, 3000000019, dev)[0]
    x = batch["x"]
    assert x.shape == (256, 32768, 2) and x.is_cuda
    receive = make_link_receiver(256, 32768, 4000, device=dev)
    lengths = np.full(256, 32768)
    before = (sync_search.launches, frame_decode.launches,
              link.host_decode_channels)
    got = receive(x, lengths)
    assert (sync_search.launches, frame_decode.launches,
            link.host_decode_channels) == (before[0] + 1, before[1] + 1,
                                           before[2])
    assert got.found.all()
    np.testing.assert_array_equal(got.bits, batch["bits"])
    chans = [0, 1, 37, 96, 128, 200, 254, 255]
    sub = SimpleNamespace(**{k: getattr(got, k)[chans] for k in (
        "found", "bits", "offset", "scale", "dfc", "phase")})
    checks = ref.check_step(cfg, x[chans], sub, batch["bits"][chans])
    for k, v in checks.items():
        assert v <= cfg["limits"][k], (k, v)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        receive(x, lengths)
        torch.cuda.synchronize()
    spans = {"pc.link.receive", "pc.link.search", "pc.kernel.frame_decode"}
    host = {e.name for e in prof.events()
            if e.device_type != DeviceType.CUDA}
    device = {e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA}
    assert spans <= host, spans - host
    assert not any(n.startswith("pc.") for n in device)
    assert not host & {"pc.link.decode", "pc.link.slice",
                       "pc.link.descramble"}
    assert any("sync_search_kernel" in n for n in device)
    assert any("frame_decode_kernel" in n for n in device)


# ------------------------------------------------------------------ #
# the sources and the math catalog on the card
# ------------------------------------------------------------------ #
def _wave_chain(taps, nb):
    from pothoscomms_tpu_torch import BlockRegistry

    src = BlockRegistry.make("/comms/waveform_source", "complex_float32")
    src.set_waveform("SINE")
    src.set_frequency(1.217e6)
    src.set_sample_rate(30.72e6)
    sc = BlockRegistry.make("/comms/scale", "complex_float32")
    sc.set_factor(0.5)
    rot = BlockRegistry.make("/comms/rotate", "complex_float32")
    rot.set_phase(0.3)
    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                             "COMPLEX")
    fir.set_taps(taps)
    return [src, sc, rot, fir,
            BlockRegistry.make("/comms/fft", "complex_float32", nb, False)]


def test_wave_chain_on_card_matches_float64_oracle(dev):
    """waveform -> scale -> rotate -> FIR(64) -> FFT(1024) on Topology()
    at 2^20 samples: one source-headed segment engaged cold (the FIR
    single on K1, every K1 launch on the tensor cores), cycling to the
    pair in the form fir_fft_form picks (one_pass, on K3), every window
    within 1e-4 of max |spectrum| of a float64 oracle of the same table
    walk."""
    from pothoscomms_tpu_torch import Topology
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink

    rng = np.random.default_rng(3)
    k, nb, n = 64, 1024, 1 << 20
    taps = (rng.normal(size=k) + 1j * rng.normal(size=k)) / k
    blocks = _wave_chain(taps, nb)
    sink = CollectorSink("complex_float32")
    topo = Topology(device=dev)
    for a, b in zip(blocks, blocks[1:] + [sink]):
        topo.connect(a, 0, b, 0)
    by_variant = dict(cgemm.launches_by_variant)
    k3 = fir_fft_fused.launches
    topo.run_source_elements(n)
    torch.cuda.synchronize()
    seg = topo._segments[0]
    assert seg.blocks == blocks and seg.cold_engages == 1
    assert seg.pair_engaged and seg.engage_count == 2
    assert fir_fft_form(k, nb, 1, nb) == "one_pass"
    assert fir_fft_fused.launches - k3 >= 1
    took = {v: cgemm.launches_by_variant[v] - by_variant[v]
            for v in by_variant}
    # the cold quantum's FIR single: its two block-Toeplitz products
    assert took[TENSOR_CORES] >= 2 and took[SIMT] == 0
    got = sink.get_buffer()
    nw = (n - (k - 1)) // nb
    assert got.shape == (nw * nb,)
    src = blocks[0]
    seq = src._table.astype(np.complex128)[
        (np.arange(n) * src._step) & src._mask] * 0.5 * np.exp(0.3j)
    y = np.convolve(seq, taps, "valid")[: nw * nb]
    exp = np.fft.fft(y.reshape(nw, nb), axis=-1)
    err = np.abs(got.reshape(nw, nb) - exp).max(1) / np.abs(exp).max(1)
    assert err.max() < 1e-4


def _noise_fm(seed=11):
    from pothoscomms_tpu_torch import BlockRegistry

    src = BlockRegistry.make("/comms/noise_source", "complex_float32", seed)
    src.set_waveform("NORMAL")
    src.set_fast(True)
    return [src] + _fm_blocks(32, 2, 4.0, 16.0)


def test_noise_fm_segment_on_card_matches_plain_walk(dev):
    """noise_source -> freq_demod -> dc_removal -> envelope as one
    source-headed segment on the card: every generated quantum equals the
    walk's plain version (blocks/sources.noise_walk_plain) bit for bit,
    and the outputs equal the same topology on the CPU (the same seed
    draws the same walk) within 1e-4."""
    from pothoscomms_tpu_torch import Topology
    from pothoscomms_tpu_torch.blocks.sources import noise_walk_plain
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink

    n = (1 << 18) + 5

    def run(device, walks):
        blocks = _noise_fm()
        src = blocks[0]
        export = src.fuse_source_export

        def noting(channels):
            carry, step, params = export(channels)

            def noted(c, t, table):
                c2, y = step(c, t, table)
                walks.append((c, t, y[0].cpu().numpy(),
                              table.cpu().numpy()))
                return c2, y

            return carry, noted, params

        src.fuse_source_export = noting
        sink = CollectorSink("float32")
        topo = Topology(device=device)
        topo.fuse_threshold = 4096
        for a, b in zip(blocks, blocks[1:] + [sink]):
            topo.connect(a, 0, b, 0)
        before = envelope_rows.launches
        topo.run_source_elements(n)
        torch.cuda.synchronize()
        return sink.get_buffer(), topo, envelope_rows.launches - before

    walks = []
    got, topo, launched = run(dev, walks)
    seg = topo._segments[0]
    assert len(seg.blocks) == 4 and seg.source is topo.blocks[0]
    assert launched >= 1 and walks
    for c, t, y, table in walks:
        np.testing.assert_array_equal(y, noise_walk_plain(table, c, t)[1])
    ref, _, _ = run("cpu", [])
    assert got.shape == ref.shape == (n,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(FUSED_MATH_CASES))
def test_fusable_math_block_on_card_matches_cpu(dev, name):
    """Each fusable math block with an exact hop, engaged on the card,
    against the same topology streaming on the CPU: bit for bit where the
    case says so, else within its bound (core/testing.py)."""
    feeds = fused_math_feeds(name, (1 << 16) + 17, 7)
    got, topo = fused_math_run(name, feeds, device=dev, threshold=4096)
    ref, _ = fused_math_run(name, feeds, device="cpu", fuse=False)
    assert topo._segments[0].fused_elements >= 1 << 16
    fused_math_agree(name, got, ref)


def test_source_quota_never_overshot_on_card(dev):
    """A cold engage at a quota of one fuse floor (4096, K = 17, 256
    bins): the source generates exactly its quota and the spectra equal
    the streaming path on the CPU."""
    from pothoscomms_tpu_torch import BlockRegistry, Topology
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink

    rng = np.random.default_rng(3)
    taps = (rng.normal(size=17) + 1j * rng.normal(size=17)) / 17

    def run(device, fuse):
        src = BlockRegistry.make("/comms/waveform_source", "complex_float32")
        src.set_waveform("SINE")
        src.set_frequency(1000.0)
        src.set_sample_rate(48000.0)
        fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
        fir.set_taps(taps)
        fft = BlockRegistry.make("/comms/fft", "complex_float32", 256, False)
        sink = CollectorSink("complex_float32")
        topo = Topology(device=device)
        topo.auto_fuse = fuse
        topo.fuse_threshold = 4096
        for a, b in ((src, fir), (fir, fft), (fft, sink)):
            topo.connect(a, 0, b, 0)
        topo.run_source_elements(4096)
        return sink.get_buffer(), topo, src

    got, topo, src = run(dev, True)
    seg = topo._segments[0]
    assert seg.cold_engages == 1
    assert seg.fused_elements + src.output(0).total_produced == 4096
    ref, _, _ = run("cpu", False)
    assert got.shape == ref.shape == (15 * 256,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_signal_probe_device_path_matches_host(dev):
    """SignalProbe over device chunks on the card (a float64 reduction
    there, the scalar alone to the host) against its host path on the
    same 2^20 samples, in each mode, real and complex: rel 1e-12."""
    from pothoscomms_tpu_torch import BlockRegistry, Topology
    from pothoscomms_tpu_torch.core.fusion import DeviceChunk

    rng = np.random.default_rng(26)
    n = 1 << 20
    for dtype in ("float32", "complex_float32"):
        planar = rng.standard_normal((n, 2) if dtype != "float32" else (n,),
                                     dtype=np.float32) + np.float32(0.3)
        for mode in ("VALUE", "RMS", "MEAN"):
            values = []
            for on_card in (True, False):
                probe = BlockRegistry.make("/comms/signal_probe", dtype)
                Topology(device=dev)._register(probe)
                probe.set_mode(mode)
                probe.set_window(n)
                calls = []
                device_path = probe._probe_device
                probe._probe_device = lambda tail: calls.append(
                    {p.planar.device.type for p in tail}) or device_path(tail)
                for part in np.array_split(planar, 3):
                    if on_card:
                        probe.input(0).push_buffer(DeviceChunk(
                            torch.from_numpy(part).to(dev), dtype))
                    else:
                        probe.input(0).push_buffer(
                            part.view(np.complex64)[:, 0]
                            if dtype != "float32" else part)
                probe.work()
                assert calls == ([{"cuda"}] if on_card else [])
                values.append(probe.value())
            assert values[0] == pytest.approx(values[1], rel=1e-12), (
                dtype, mode)


def test_threshold_core_on_card_past_2_24(dev):
    """The Threshold core's int64 last-crossing index on a pull longer
    than 2^24: an activation at 2^24 and a deactivation at 2^24 + 1 (one
    index in float32, where activation would win the tie) leave the
    state off, and the reverse order on; both equal the host walk."""
    from pothoscomms_tpu_torch import BlockRegistry, Topology

    t = (1 << 24) + 4099
    for act, deact, state in (((1 << 24), (1 << 24) + 1, False),
                              ((1 << 24) + 1, (1 << 24), True)):
        x = torch.zeros((2, t), device=dev)
        x[:, 5] = 1.0  # on early, so the late crossings decide
        x[:, act] = 1.0
        x[:, deact] = -1.0
        th = BlockRegistry.make("/comms/threshold", "float32")
        Topology(device=dev)._register(th)
        th.set_activation_level(0.5)
        th.set_deactivation_level(-0.5)
        carry, step = th.fuse_export(2)
        new, y = step(carry, x)
        assert y is x
        host = x[0].cpu().numpy()
        walk = False
        for i in np.nonzero(np.abs(host) > 0.5)[0]:
            if not walk and host[i] > 0.5:
                walk = True
            elif walk and host[i] < -0.5:
                walk = False
        assert walk == state
        assert new.tolist() == [[float(state)], [float(state)]]
        th.fuse_import(new)
        assert th._active_state == state


def test_checkpoint_of_engaged_fir_fft_segment_on_card(dev, tmp_path):
    """save_state / load_state of an engaged FIR -> FFT segment on the
    card: the checkpoint holds no tensor, and a fresh topology on the card
    resumed from it continues the spectra within 2e-4 of an
    uninterrupted run on the card."""
    import pickle

    from pothoscomms_tpu_torch import BlockRegistry, Topology
    from pothoscomms_tpu_torch.core.fixtures import (CollectorSink,
                                                     FeederSource)

    rng = np.random.default_rng(27)
    taps = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
    n = 63 + (1 << 18)  # the FIR's history, then whole pulls
    x = (rng.normal(size=2 * n) + 1j * rng.normal(size=2 * n)).astype(
        np.complex64)

    def build():
        fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
        fir.set_taps(taps)
        fft = BlockRegistry.make("/comms/fft", "complex_float32", 1024,
                                 False)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device=dev)
        for a, b in ((feed, fir), (fir, fft), (fft, sink)):
            topo.connect(a, 0, b, 0)
        return topo, feed, sink

    topo, feed, sink = build()
    feed.feed_buffer(x[:n])
    topo.commit()
    assert topo.wait_inactive(timeout=120.0)
    seg = topo._segments[0]
    assert seg.engaged and seg.pair_engaged
    path = tmp_path / "card.pkl"
    topo.save_state(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)

    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            return 1
        if isinstance(obj, dict):
            return sum(tensors(v) for v in obj.values())
        if isinstance(obj, (list, tuple, set)):
            return sum(tensors(v) for v in obj)
        return 0

    assert tensors(blob) == 0
    first = sink.get_buffer()
    topo2, feed2, sink2 = build()
    topo2.commit()
    topo2.load_state(str(path))
    sink2.clear()
    feed2.feed_buffer(x[n:])
    assert topo2.wait_inactive(timeout=120.0)
    resumed = np.concatenate([first, sink2.get_buffer()])
    topo3, feed3, sink3 = build()
    feed3.feed_buffer(x)
    topo3.commit()
    assert topo3.wait_inactive(timeout=120.0)
    full = sink3.get_buffer()
    assert resumed.shape == full.shape
    np.testing.assert_allclose(resumed, full, rtol=0, atol=2e-4)


# ------------------------------------------------------------------ #
# the scale-out layer at world size 1 under NCCL
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """A one-rank NCCL process group on the card (a file:// store), for
    the module; the mesh functions then run their collectives through
    NCCL."""
    import torch.distributed as dist

    from pothoscomms_tpu_torch.parallel import distributed

    store = tmp_path_factory.mktemp("nccl") / "store"
    dev = distributed.initialize(f"file://{store}", world_size=1, rank=0)
    yield dev
    dist.destroy_process_group()


def test_nccl_mesh_defaults_to_the_card(nccl):
    import torch.distributed as dist

    from pothoscomms_tpu_torch.parallel.mesh import make_mesh

    assert dist.get_backend() == "nccl" and nccl.type == "cuda"
    mesh = make_mesh()
    assert mesh.device == nccl and mesh.shape == {"ch": 1}
    with pytest.raises(ValueError, match="gloo"):
        make_mesh(device="cpu")


def test_nccl_channel_sharded_fir_fft_equals_unsharded(nccl):
    """The sharded step on one rank takes fir_fft_chain's form (one_pass
    at K=64 and 1024 bins) and equals fir_fft_chain's step bit for bit
    (same K3 launch, same operand), over two steps; the carry is the last
    K-1 inputs."""
    from pothoscomms_tpu_torch.parallel.mesh import (channel_sharded_fir_fft,
                                                     make_mesh)

    rng = np.random.default_rng(12)
    C, T, K, NB = 8, 8192, 64, 1024
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    mesh = make_mesh(1)
    run, init = channel_sharded_fir_fft(mesh, taps, NB)
    run_ref, h_ref = fir_fft_chain(taps, NB, C, T, device=nccl)
    assert run.form == run_ref.form == "one_pass"
    h = init(C)
    for _ in range(2):
        x = _normal(rng, C, T, 2).to(nccl)
        k3, k1 = fir_fft_fused.launches, cgemm.launches
        spec, h = run(x, h)
        assert (fir_fft_fused.launches - k3, cgemm.launches - k1) == (1, 0)
        ref, h_ref = run_ref(x, h_ref)
        assert torch.equal(spec, ref)
        assert torch.equal(h, x[:, T - (K - 1):])
    assert (mesh.p2p_ops, mesh.collectives) == (0, 0)


def test_nccl_time_and_grid_sharded_fir_equal_one_device(nccl):
    """time_sharded_fir and grid_sharded_fir on one rank: the conv FIR of
    one device within 1e-4; no send, one NCCL broadcast of the carry a
    step."""
    from pothoscomms_tpu_torch.parallel.chain import (complex_fir_kernel,
                                                      fir_multichannel)
    from pothoscomms_tpu_torch.parallel.distributed import make_2d_mesh
    from pothoscomms_tpu_torch.parallel.mesh import (grid_sharded_fir,
                                                     make_mesh,
                                                     time_sharded_fir)

    rng = np.random.default_rng(13)
    C, T, K = 4, 4096, 64
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    kern = complex_fir_kernel(taps).to(nccl)
    x = _normal(rng, C, T, 2).to(nccl)
    carry = _normal(rng, C, K - 1, 2).to(nccl)
    ref, tail = fir_multichannel(x, carry, kern)
    for mesh, fn in ((make_mesh(1, "t"), time_sharded_fir),
                     (make_2d_mesh(1, 1), grid_sharded_fir)):
        y, c2 = fn(mesh, taps)(x, carry)
        assert (y - ref).abs().max().item() <= 1e-4
        assert torch.equal(c2, tail)
        assert (mesh.p2p_ops, mesh.collectives) == (0, 1)


def test_nccl_time_sharded_resampler_equals_one_device(nccl):
    from pothoscomms_tpu_torch.ops.filter import (_polyphase_matrix,
                                                  polyphase_fir)
    from pothoscomms_tpu_torch.parallel.mesh import (make_mesh,
                                                     time_sharded_resampler)

    rng = np.random.default_rng(14)
    M, L, C, T = 2, 3, 4, 6000
    taps = (rng.normal(size=60) + 1j * rng.normal(size=60)) / 60
    phases, K = _polyphase_matrix(taps, L)
    tq = torch.from_numpy(np.stack([phases.real, phases.imag], -1).astype(
        np.float32)).to(nccl)
    x = _normal(rng, C, T, 2).to(nccl)
    carry = _normal(rng, C, K - 1, 2).to(nccl)
    y, c2 = time_sharded_resampler(make_mesh(1, "t"), taps, M, L)(x, carry)
    xh = torch.cat([carry, x], dim=1)
    ref = torch.stack([polyphase_fir(s, tq, M, L, K, "planar", 0)
                       for s in xh])
    assert y.shape == (C, T * L // M, 2)
    assert (y - ref).abs().max().item() <= 1e-4
    assert torch.equal(c2, x[:, T - (K - 1):])


def test_nccl_compile_chain_sharded_fm_equals_compile_chain(nccl):
    """The FM chain channel-sharded on one rank equals compile_chain bit
    for bit over two steps (E1 launched)."""
    from pothoscomms_tpu_torch import BlockRegistry
    from pothoscomms_tpu_torch.parallel.compiler import (
        compile_chain, compile_chain_sharded)
    from pothoscomms_tpu_torch.parallel.mesh import make_mesh

    def blocks():
        demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
        dc = BlockRegistry.make("/comms/dc_removal", "float32")
        dc.set_average_size(64)
        dc.set_cascade_size(2)
        env = BlockRegistry.make("/comms/envelope_detector", "float32")
        env.set_attack(10.0)
        env.set_release(40.0)
        return [demod, dc, env]

    rng = np.random.default_rng(15)
    C, T = 16, 16384
    step_s, carry_s = compile_chain_sharded(blocks(), C, make_mesh(1))
    step_1, carry_1 = compile_chain(blocks(), C, device=nccl)
    for _ in range(2):
        ph = np.cumsum(rng.uniform(-0.5, 0.5, (C, T)), axis=1)
        x = torch.from_numpy(np.stack([np.cos(ph), np.sin(ph)], -1).astype(
            np.float32)).to(nccl)
        before = envelope_rows.launches
        y_s, carry_s = step_s(x, carry_s)
        assert envelope_rows.launches > before
        y_1, carry_1 = step_1(x, carry_1)
        assert torch.equal(y_s, y_1)


def test_nccl_run_sharded_link_16_channels(nccl):
    """run_sharded_link on one rank: one S1 launch for the 16 channels,
    every channel exact, the arrays equal run_link's bit for bit."""
    from pothoscomms_tpu_torch.kernels.sync_search import sync_search
    from pothoscomms_tpu_torch.parallel.link import run_link, run_sharded_link
    from pothoscomms_tpu_torch.parallel.mesh import make_mesh

    before = sync_search.launches
    res = run_sharded_link(make_mesh(1), 16, n_bits=64, seed=7)
    assert sync_search.launches == before + 1
    assert res["all_exact"] and res["devices"] == 1, res["bit_exact"]
    ref = run_link(16, n_bits=64, seed=7, device=nccl)
    for a, b in zip(res["arrays"], ref["arrays"]):
        np.testing.assert_array_equal(a, b)


def test_nccl_dryrun_multichip_on_one_card(nccl):
    from pothoscomms_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    out = dryrun_multichip(1)
    assert out["channel_fir_fft"][1] < 1e-4 and out["time_fir"][1] <= 1e-4
    fn, args = entry()
    spec, _ = fn(*args)
    assert spec.is_cuda and spec.shape == (8, 8, 256, 2)


# ------------------------------------------------------------------ #
# the BASELINE bench suite (benches_torch/bench_suite.py), small
# ------------------------------------------------------------------ #
def _bench_suite():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benches_torch" \
        / "bench_suite.py"
    spec = importlib.util.spec_from_file_location("bench_suite_card", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,sizes,kernel", [
    ("fir_1ch", dict(n=1 << 17, reps=2), "cgemm"),
    ("fft_64ch_1024", dict(channels=2, frames=4, iters=2), "fft_c2c"),
    ("resampler_3_2", dict(channels=2, n=1024, iters=2), "cgemm"),
    ("fm_chain_256ch", dict(channels=4, t=2048, pool=2, iters=2),
     "envelope_rows"),
    ("digital_link", dict(n_frames=4), None),
    ("digital_modem_bulk", dict(n_bits=1 << 17), None),
    ("digital_link_sharded", dict(), "sync_search")])
def test_bench_suite_workload_on_card_passes_its_gates(dev, name, sizes,
                                                       kernel):
    """Each workload of the suite, small, on the card: its line passes its
    gates (parity, bit_exact, quiesced, all_exact, every frame of the
    link) and it launched the hand kernel on its path."""
    from pothoscomms_tpu_torch.kernels.sync_search import sync_search

    wrappers = {"cgemm": cgemm, "fft_c2c": fft_c2c,
                "envelope_rows": envelope_rows, "sync_search": sync_search}
    suite = _bench_suite()
    before = wrappers[kernel].launches if kernel else 0
    line = suite.ALL[name](device=dev, **sizes)
    assert suite.passed(line), line
    if kernel:
        assert wrappers[kernel].launches > before, line


BUILD_PROBE = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from pothoscomms_tpu_torch.parallel import profiling
from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain
rng = np.random.default_rng(7)
taps = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
run, carry = fir_fft_chain(taps, 1024, 256, 16384, device="cuda")
x = torch.randn(256, 16384, 2, device="cuda")
snap = profiling.build_record()
run(x, carry)
torch.cuda.synchronize()
step = profiling.build_record(since=snap)
snap = profiling.build_record()
run(x, carry)
torch.cuda.synchronize()
print(json.dumps({"record": profiling.build_record(), "step": step,
                  "warm": profiling.build_record(since=snap)}))
"""


def test_first_step_records_k3s_library_and_first_launch(dev):
    """In a fresh process, one step of ``fir_fft_chain(64 taps, 1024,
    256, 16384)`` (the one-pass form) records K3's library load and its
    first launch, once each; the second step adds nothing; and a second
    process, the build cache now warm, compiles nothing."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", BUILD_PROBE, root], capture_output=True,
        text=True, check=True, timeout=600).stdout.splitlines()[-1])
        for _ in range(2)]
    for got in runs:
        step = got["step"]["builds"]
        for name in ("pc.build.library.fir_fft_fused",
                     "pc.build.first_launch.fir_fft_fused"):
            assert step[name]["first_n"] == 1, (name, step)
            assert step[name]["again_n"] == 0
            assert got["record"]["builds"][name]["first_n"] == 1
        assert got["record"]["builds"]["pc.build.fir_fft.one_pass"][
            "first_n"] == 1
        assert got["warm"] == {"builds": {}, "compiled": {}}
    assert runs[1]["record"]["compiled"] == {}
