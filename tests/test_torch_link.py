"""The port's channel-batched digital link (BASELINE.json config #5) against
the JAX package's channel-sharded one (the cases of tests/test_link.py).

scrambler -> symbol_mapper -> frame_insert -> upsample -> channel ->
batched sync search (S1's plain version on the CPU) -> frame automaton +
header decode -> symbol_slicer -> descrambler.

Inputs come from numpy seeds inside the link (bits, channel noise).
Tolerances: the TX waveform equal to the JAX one sample for sample; every
channel's payload bit-exact; the search arrays against JAX's sharded
search held as tests/test_torch_framing.py holds JAX (its float32 prefix
sums): at the automaton's candidate offsets (|L| >= 0.7 sw) phase within
2e-3 rad, elsewhere scale within 1e-3 relative and delta_fc within 1e-2,
and both sets of arrays decode every channel exactly; the port's against
the float64 oracle with its own bounds.
"""

import numpy as np
import pytest
import torch

from pothoscomms_tpu.parallel import link as jlink
from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                sync_search_f64)
from pothoscomms_tpu_torch.parallel import link
from tests.test_torch_framing import TOL_JAX, assert_tolerances

torch.set_num_threads(1)


def test_tx_waveform_equals_jax():
    bits = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.uint8)
    wave = link.tx_waveform(bits, symbol_width=20, data_width=4,
                            device="cpu")
    np.testing.assert_array_equal(wave, jlink.tx_waveform(
        bits, symbol_width=20, data_width=4))
    assert wave.dtype == np.complex64
    # preamble (20*4) + header (58*4) + payload ((8+16)*4) samples of
    # rectangular BPSK pulses
    assert len(wave) == 20 * 4 + 58 * 4 + (8 + 16) * 4
    w4 = wave.reshape(-1, 4)
    assert np.allclose(w4, w4[:, :1]) and np.allclose(np.abs(wave), 1.0)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    np.testing.assert_array_equal(
        link.tx_waveform(bits, poly=0x8E, seed=5, device="cpu"),
        jlink.tx_waveform(bits, poly=0x8E, seed=5))


def test_single_channel_roundtrip():
    res = link.run_link(1, n_bits=48, seed=3, device="cpu")
    assert res["all_exact"], res["bit_exact"]


@pytest.mark.parametrize("C,n_bits,seed,noise", [(16, 64, 7, 0.0),
                                                 (8, 64, 11, 0.02)])
def test_link_bit_exact(C, n_bits, seed, noise):
    """16 channels of 64-bit frames (the sharded JAX test's size), and 8
    with noise 0.02, every channel exact; the one search launch covers
    the whole batch."""
    res = link.run_link(C, n_bits=n_bits, seed=seed, noise=noise,
                        device="cpu")
    assert res["all_exact"], res["bit_exact"]
    assert res["arrays"][0].shape == (C, res["n_pad"])


def test_channel_search_equals_jax_sharded_search():
    """make_channel_search against JAX's make_sharded_search on a
    one-device CPU mesh, on the same [C, lp, 2] batch, and both against
    the float64 oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 32).astype(np.uint8)
    wave = link.apply_channel(link.tx_waveform(bits, device="cpu"),
                              attenuation=0.6, phase=0.4, freq_offset=5e-5)
    C = 8
    search, lp, n_pad = link.make_channel_search([1.0], 20, 4, 0.01,
                                                 len(wave), device="cpu")
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("ch",))
    jsearch, jlp, jn = jlink.make_sharded_search(mesh, [1.0], 20, 4, 0.01,
                                                 len(wave))
    assert (lp, n_pad) == (jlp, jn)
    x = np.zeros((C, lp, 2), np.float32)
    for c in range(C):
        wv = wave * np.float32(0.8 + 0.05 * c)
        x[c, :len(wave), 0], x[c, :len(wave), 1] = wv.real, wv.imag
    got = [a.numpy() for a in search(torch.from_numpy(x))]
    jgot = [np.asarray(a) for a in jsearch(jnp.asarray(x))]
    ref = sync_search_f64(x, [1.0], 0.01, 80, 80, 4, 1, n_pad)
    assert_tolerances(search_agreement(got, ref))
    assert_tolerances(search_agreement(jgot, ref, peak_floor=56),
                      TOL_JAX, peaks=False)
    # either set of arrays decodes every channel's frame exactly
    n_off = len(wave) - (lp - n_pad)
    for c in range(C):
        wv = x[c, :len(wave), 0] + 1j * x[c, :len(wave), 1]
        for arrays in (got, jgot):
            rec = link.rx_decode(wv, tuple(a[c][:n_off] for a in arrays),
                                 len(bits), device="cpu")
            np.testing.assert_array_equal(rec, bits)
