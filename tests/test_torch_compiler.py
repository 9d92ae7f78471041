"""The FM receive chain (BASELINE config #4: freq_demod -> dc_removal ->
envelope_detector) through the port's ``compile_chain`` against the JAX
package's ``compile_chain`` and the float64 numpy oracle of
tests/test_tpu_lane.py:201-243.

Inputs are explicit float32 planar arrays made with
numpy.random.default_rng(seed). Tolerances: the numpy oracle within
2e-3 absolute (the JAX test's bound); the port against JAX within 1e-4
absolute on outputs of order 1 (the DC stages' cumulative sums are taken
in another order; the follower is contractive, so the difference does
not grow); carries within the same bound, the discriminator's exactly.
The pairing rule (FreqDemod -> DCRemoval as one F1 core, its plain
version on the CPU) gives the single cores' outputs and carries bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu.parallel import compiler as jcompiler
from pothoscomms_tpu_torch.kernels.envelope import envelope_rows
from pothoscomms_tpu_torch.kernels.fm_demod_dc import fm_demod_dc
from pothoscomms_tpu_torch.parallel import compiler

torch.set_num_threads(1)

TOL = 1e-4


def fm_blocks(p, d=16, casc=2, attack=10.0, release=40.0):
    demod = p.BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = p.BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(d)
    dc.set_cascade_size(casc)
    env = p.BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(attack)
    env.set_release(release)
    return [demod, dc, env]


def fm_input(rng, C, T, offset=0.0):
    phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, T)) + offset, axis=1)
    return np.stack([np.cos(phase), np.sin(phase)], -1).astype(np.float32)


def fm_oracle(x, d, casc, attack, release):
    """tests/test_tpu_lane.py:222-243, float64, from a zero state."""
    C, T = x.shape[:2]
    xc = x[..., 0] + 1j * x[..., 1]
    prev = np.concatenate([np.zeros((C, 1), np.complex64), xc[:, :-1]], 1)
    dm = np.angle(xc * np.conj(prev)).astype(np.float32)
    cur = dm
    for s in range(casc):
        ext = np.concatenate([np.zeros((C, d), np.float32), cur], axis=1)
        cs = np.cumsum(ext, axis=1)
        avg = (cs[:, d:] - cs[:, :-d]) / d
        if s == 0:
            delayed = ext[:, 1: 1 + T]
        cur = avg.astype(np.float32)
    dced = delayed - cur
    ga, gr = np.exp(-1.0 / attack), np.exp(-1.0 / release)
    envs = np.zeros(C, np.float64)
    out = np.empty((C, T), np.float64)
    mag = np.abs(dced)
    for t in range(T):
        g = np.where(mag[:, t] > envs, ga, gr)
        envs = g * envs + (1.0 - g) * mag[:, t]
        out[:, t] = envs
    return out.astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def _close_carry(port, jax_carry):
    assert len(port) == len(jax_carry) == 3
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(jax_carry[0]))
    for a, b in zip(port[1:], jax_carry[1:]):
        assert a.shape == np.asarray(b).shape
        _close(a.numpy(), b)


@pytest.mark.parametrize("C,T,blocked", [(8, 2048, False),
                                         (2, 32768, True)])
def test_fm_chain_matches_jax_and_oracle(C, T, blocked):
    rng = np.random.default_rng(20)
    x = fm_input(rng, C, T)
    step, carry0 = compiler.compile_chain(fm_blocks(pkg), C, device="cpu")
    jstep, jcarry0 = jcompiler.compile_chain(fm_blocks(jpkg), C)
    assert [tuple(c.shape) for c in carry0] == \
        [tuple(np.asarray(c).shape) for c in jcarry0]
    y, carry = step(torch.from_numpy(x), carry0)
    yj, jcarry = jstep(jnp.asarray(x), jcarry0)
    assert y.shape == (C, T) and y.dtype == torch.float32
    _close(y.numpy(), yj)
    _close_carry(carry, jcarry)
    _close(y.numpy(), fm_oracle(x, 16, 2, 10.0, 40.0), 2e-3)
    # the blocked follower runs iff t % 8192 == 0, t >= 4*8192, W <= 16384
    assert (T % 8192 == 0 and T >= 4 * 8192) == blocked


def test_fm_chain_carry_across_calls():
    """Two chained calls equal one call on the joined block, and equal the
    JAX chain's two calls, carry included."""
    rng = np.random.default_rng(21)
    C, T = 4, 1024
    x = fm_input(rng, C, 2 * T, offset=0.3)
    step, carry0 = compiler.compile_chain(fm_blocks(pkg, 8, 3, 4.0, 16.0), C,
                                          device="cpu")
    jstep, jcarry = jcompiler.compile_chain(
        fm_blocks(jpkg, 8, 3, 4.0, 16.0), C)
    whole, _ = step(torch.from_numpy(x), carry0)
    carry = carry0
    for h in range(2):
        xh = x[:, h * T:(h + 1) * T]
        y, carry = step(torch.from_numpy(np.ascontiguousarray(xh)), carry)
        yj, jcarry = jstep(jnp.asarray(xh), jcarry)
        _close(y.numpy(), yj)
        _close(y.numpy(), whole[:, h * T:(h + 1) * T].numpy())
    _close_carry(carry, jcarry)


def test_chain_carry_from_numpy_resumes_a_jax_stream():
    """A mid-stream JAX carry, brought over with chain_carry_from_numpy,
    lets the port continue the stream the JAX chain started."""
    rng = np.random.default_rng(22)
    C, T = 3, 2048
    jstep, jcarry = jcompiler.compile_chain(fm_blocks(jpkg), C)
    _, jcarry = jstep(jnp.asarray(fm_input(rng, C, T)), jcarry)
    carry = compiler.chain_carry_from_numpy(
        tuple(np.asarray(c) for c in jcarry), device="cpu")
    assert all(isinstance(c, torch.Tensor) and c.dtype == torch.float32
               for c in carry)
    step, _ = compiler.compile_chain(fm_blocks(pkg), C, device="cpu")
    x2 = fm_input(rng, C, T)
    y, carry = step(torch.from_numpy(x2), carry)
    yj, jcarry = jstep(jnp.asarray(x2), jcarry)
    _close(y.numpy(), yj)
    _close_carry(carry, jcarry)
    assert compiler.chain_carry_from_numpy(((), np.zeros(2, np.float32)),
                                           device="cpu")[0] == ()


def test_run_chain_numpy_complex_input():
    rng = np.random.default_rng(23)
    C, T = 2, 512
    phase = np.cumsum(rng.normal(size=(C, T)) * 0.2, axis=1)
    xc = np.exp(1j * phase).astype(np.complex64)
    step, carry = compiler.compile_chain(fm_blocks(pkg), C, device="cpu")
    jstep, jcarry = jcompiler.compile_chain(fm_blocks(jpkg), C)
    y, carry = compiler.run_chain_numpy(step, carry, xc)
    yj, _ = jcompiler.run_chain_numpy(jstep, jcarry, xc)
    assert isinstance(y, np.ndarray) and y.shape == (C, T)
    _close(y, yj)


def test_compile_chain_on_cpu_launches_nothing_and_rejects_plain_blocks():
    from pothoscomms_tpu_torch.core.fixtures import CollectorSink

    before = envelope_rows.launches
    f1_before = fm_demod_dc.launches
    step, carry = compiler.compile_chain(fm_blocks(pkg), 2, device="cpu")
    step(torch.zeros(2, 64, 2), carry)
    assert envelope_rows.launches == before  # CPU tensors: the twin
    assert fm_demod_dc.launches == f1_before
    with pytest.raises(TypeError):
        compiler.compile_chain([CollectorSink("float32")], 2)
    env = fm_blocks(pkg)[2]
    env.set_lookahead(3)
    with pytest.raises(TypeError):
        compiler.compile_chain([env], 2)


# ---------------------------------------------------------------------- #
# the pairing rule: FreqDemod -> DCRemoval as one core (F1)
# ---------------------------------------------------------------------- #
def single_cores_step(blocks, C):
    """The chain's cores composed one by one, as before the pairing rule:
    (step, carry0)."""
    made = [b.device_core(C, device="cpu") for b in blocks]

    def step(x, carry):
        out = []
        for (_, core), c in zip(made, carry):
            c2, x = core(c, x)
            out.append(c2)
        return x, tuple(out)

    return step, tuple(c for c, _ in made)


@pytest.mark.parametrize("T", [131072, 16384])
def test_pairing_rule_takes_the_pair_at_the_cells_shapes(T):
    """The FM bank's settings (D 64, cascade 2) at both cells' T."""
    blocks = fm_blocks(pkg, 64, 2)
    assert compiler.fm_pair(blocks[0], blocks[1]) == (64, 2)
    assert compiler.paired(blocks, T) == [0]


def _complex_dc_chain():
    blocks = fm_blocks(pkg, 64, 2)
    blocks[1] = pkg.BlockRegistry.make("/comms/dc_removal",
                                       "complex_float32")
    return blocks


@pytest.mark.parametrize("make,T", [
    (_complex_dc_chain, 4096),
    (lambda: fm_blocks(pkg, 770, 2), 1 << 16),       # D beyond the halo
    (lambda: fm_blocks(pkg, 64, 25), 4096),          # cascade beyond it
    (lambda: fm_blocks(pkg, 64, 2), 63),             # T < D
    (lambda: [fm_blocks(pkg)[i] for i in (0, 2, 1, 2)], 4096),  # between
    (lambda: fm_blocks(pkg)[1:], 4096),              # no discriminator
])
def test_pairing_rule_keeps_the_singles(make, T):
    assert compiler.paired(make(), T) == []


@pytest.mark.parametrize("C,T,d,casc", [(4, 2048, 16, 2), (3, 4096, 64, 2),
                                        (2, 1000, 7, 3), (2, 700, 512, 1)])
def test_paired_chain_equals_single_cores_bit_for_bit(C, T, d, casc):
    rng = np.random.default_rng(24 + T)
    step, carry = compiler.compile_chain(fm_blocks(pkg, d, casc), C,
                                         device="cpu")
    sstep, scarry = single_cores_step(fm_blocks(pkg, d, casc), C)
    assert compiler.paired(fm_blocks(pkg, d, casc), T) == [0]
    for k in range(3):
        x = torch.from_numpy(fm_input(rng, C, T, offset=0.2 * k))
        y, carry = step(x, carry)
        ys, scarry = sstep(x, scarry)
        assert torch.equal(y, ys)
        assert len(carry) == len(scarry) == 3
        for a, b in zip(carry, scarry):
            assert torch.equal(a, b)


def test_a_step_below_d_runs_the_singles_and_the_carry_goes_on():
    """T < D in one step keeps the singles; the carries pass between the
    pair's steps and the singles' as one block's carry each."""
    rng = np.random.default_rng(25)
    C, d = 2, 64
    step, carry = compiler.compile_chain(fm_blocks(pkg, d, 2), C,
                                         device="cpu")
    sstep, scarry = single_cores_step(fm_blocks(pkg, d, 2), C)
    for T in (300, 40, 200):
        x = torch.from_numpy(fm_input(rng, C, T))
        y, carry = step(x, carry)
        ys, scarry = sstep(x, scarry)
        assert torch.equal(y, ys)
        for a, b in zip(carry, scarry):
            assert torch.equal(a, b)


def test_paired_carry_resumes_in_the_jax_chain():
    """The paired chain's carry, brought to numpy, lets the JAX chain go
    on with the stream, and a JAX carry brought back with
    chain_carry_from_numpy lets the port go on: at the FM bank's D 64,
    cascade 2."""
    rng = np.random.default_rng(26)
    C, T = 3, 4096
    step, carry = compiler.compile_chain(fm_blocks(pkg, 64, 2), C,
                                         device="cpu")
    jstep, _ = jcompiler.compile_chain(fm_blocks(jpkg, 64, 2), C)
    assert compiler.paired(fm_blocks(pkg, 64, 2), T) == [0]
    x1, x2, x3 = (fm_input(rng, C, T, offset=0.3) for _ in range(3))
    _, carry = step(torch.from_numpy(x1), carry)
    jcarry = tuple(jnp.asarray(c.numpy()) for c in carry)
    y2, carry = step(torch.from_numpy(x2), carry)
    yj2, jcarry = jstep(jnp.asarray(x2), jcarry)
    _close(y2.numpy(), yj2)
    _close_carry(carry, jcarry)
    back = compiler.chain_carry_from_numpy(
        tuple(np.asarray(c) for c in jcarry), device="cpu")
    y3, carry3 = step(torch.from_numpy(x3), back)
    yj3, jcarry3 = jstep(jnp.asarray(x3), jcarry)
    _close(y3.numpy(), yj3)
    _close_carry(carry3, jcarry3)
