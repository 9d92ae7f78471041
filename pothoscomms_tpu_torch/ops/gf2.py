"""GF(2) affine state-space operators for LFSR scrambling (the port of the
JAX package's ``ops/gf2.py``).

The reference's scrambler, descrambler and keystream loops are bit-serial
recursions over a Galois LFSR (reference: digital/lfsr.h:64-100,
digital/Scrambler.cpp, digital/Descrambler.cpp). Every mode of that loop
— additive keystream, multiplicative scrambler (output feedback),
multiplicative descrambler (input-driven, self-synchronising) — is an
AFFINE map over GF(2):

    s[i+1] = (A s[i] + b x[i]) mod 2        state: 64 bits
    o[i]   = (w . s[i] + x[i]) mod 2        output bit

so an Lb-sample block telescopes into exact linear algebra:

    o_blk   = (V s_k + L x_blk) mod 2       V: [Lb, 64], L: [Lb, Lb]
    s_{k+1} = (A^Lb s_k + G x_blk) mod 2    G: [64, Lb]

The operators are PROBED from the streaming implementation (the port's
``blocks/digital.GaloisLFSR``): the scalar step run on each basis state and
on the unit input gives the columns, so the blocked system is bit-exact
with the streaming path by construction. They stay numpy, on the host.

:func:`lfsr_blocked_step` runs on tensors. Every value is 0 or 1 and every
sum at most Lb + 65, so float32 products are exact in any order (TF32
would round nothing either: 0 and 1 are exact there too), and a final
``v - 2 floor(v / 2)`` reduces mod 2. These are plain matrix products
outside any kernel of the JAX package, so they go to ``torch.matmul``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NBITS = 64
# Ab^(2^j) for j < DOUBLING_ROUNDS: enough for 2^26 - 1 blocks a step
DOUBLING_ROUNDS = 26


def _state_bits(v: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(NBITS)], np.uint8)


def _bits_state(bits) -> int:
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def _one_step(poly: int, mode: str, state: int, x: int):
    """One scalar step of the streaming implementation (the contract)."""
    from pothoscomms_tpu_torch.blocks.digital import GaloisLFSR

    l = GaloisLFSR(poly, state)
    if mode == "additive":
        k = l.next()
        out = (x ^ k) & 1
        return l.data, out
    if mode == "scramble":
        out = int(l.scramble_mult(np.array([x], np.uint8))[0])
        return l.data, out
    if mode == "descramble":
        out = int(l.descramble_mult(np.array([x], np.uint8))[0])
        return l.data, out
    raise ValueError(mode)


@functools.lru_cache(maxsize=32)
def lfsr_affine_maps(poly: int, mode: str):
    """Probe the scalar LFSR step into (A [64,64], b [64], w [64]) over
    GF(2) with s' = A s + b x, o = w s + x (the affine constant is zero:
    the zero state with zero input maps to zero for every mode)."""
    s0, o0 = _one_step(poly, mode, 0, 0)
    assert s0 == 0 and o0 == 0, "LFSR step has a nonzero affine constant"
    A = np.zeros((NBITS, NBITS), np.uint8)
    w = np.zeros(NBITS, np.uint8)
    for i in range(NBITS):
        s_next, out = _one_step(poly, mode, 1 << i, 0)
        A[:, i] = _state_bits(s_next)
        w[i] = out
    s_next, out = _one_step(poly, mode, 0, 1)
    b = _state_bits(s_next)
    assert out == 1, "output must carry the input bit directly"
    # verify affinity on a few random (state, input) pairs
    rng = np.random.default_rng(0xC0)
    for _ in range(8):
        s = int(rng.integers(0, 1 << 63))
        x = int(rng.integers(0, 2))
        s_ref, o_ref = _one_step(poly, mode, s, x)
        sb = _state_bits(s)
        s_lin = (A @ sb + b * x) % 2
        o_lin = (int(w @ sb) + x) % 2
        assert _bits_state(s_lin) == s_ref and o_lin == o_ref, \
            "LFSR step is not affine over GF(2) (mode contract broken)"
    return A, b, w


@functools.lru_cache(maxsize=32)
def lfsr_blocked_operators(poly: int, mode: str, block: int):
    """Host-side (exact uint8 mod-2) block operators for an Lb = ``block``
    sample step. Returns (V, Lst, G, Ab, autonomous):

    - V   [Lb, 64]  o contribution of the block-start state: w A^l
    - Lst [Lb, Lb]  strictly-lower Toeplitz input convolution
                    Lst[i, j] = w A^(i-1-j) b  (i > j)
    - G   [64, Lb]  state drive: s' += A^(Lb-1-j) b x_j
    - Ab  [64, 64]  A^Lb
    - autonomous    True when b == 0 (additive keystream: Lst = G = 0)
    """
    A, b, w = lfsr_affine_maps(poly, mode)
    Lb = int(block)
    V = np.zeros((Lb, NBITS), np.uint8)
    h = np.zeros(Lb, np.uint8)  # h[d] = w A^(d-1) b for d >= 1
    G = np.zeros((NBITS, Lb), np.uint8)
    row = w.copy()          # w A^l
    col = b.copy()          # A^d b
    V[0] = row
    for l in range(1, Lb):
        row = (row @ A) % 2
        V[l] = row
        h[l] = int(w @ col) % 2
        col = (A @ col) % 2
    colj = b.copy()
    for j in range(Lb - 1, -1, -1):
        G[:, j] = colj
        if j:
            colj = (A @ colj) % 2
    Ab = np.eye(NBITS, dtype=np.uint8)
    Apow = A.copy()
    e = Lb
    while e:
        if e & 1:
            Ab = (Ab @ Apow) % 2
        Apow = (Apow @ Apow) % 2
        e >>= 1
    autonomous = not b.any()
    if autonomous:
        Lst = np.zeros((Lb, Lb), np.uint8)
        G = np.zeros((NBITS, Lb), np.uint8)
    else:
        i, j = np.indices((Lb, Lb))
        d = i - j
        Lst = np.where(d > 0, h[np.clip(d, 0, Lb - 1)], 0).astype(np.uint8)
    return V, Lst, G, Ab, autonomous


def doubling_powers(Ab: np.ndarray, rounds: int = DOUBLING_ROUNDS):
    """[rounds, 64, 64] uint8: Ab^(2^j) mod 2 for j < rounds."""
    out = np.empty((rounds, NBITS, NBITS), np.uint8)
    p = np.asarray(Ab, np.int64) % 2
    for j in range(rounds):
        out[j] = p
        p = (p @ p) % 2
    return out


def step_operators(poly: int, mode: str, block: int, device):
    """The operators :func:`lfsr_blocked_step` takes, as float32 tensors
    on ``device``: (V, Lst, G, Ab^(2^j) for j < DOUBLING_ROUNDS), and the
    autonomous flag."""
    V, Lst, G, Ab, auto = lfsr_blocked_operators(poly, mode, block)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return (dev(V), dev(Lst), dev(G), dev(doubling_powers(Ab))), auto


def export_state(value: int) -> np.ndarray:
    """LFSR integer state -> [64] float32 bit plane (the device carry)."""
    return _state_bits(value).astype(np.float32)


def import_state(bits) -> int:
    b = np.rint(np.asarray(bits)).astype(np.int64) & 1
    return _bits_state(b)


def _mod2(v: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * torch.floor(v * 0.5)


def lfsr_blocked_step(s, x, V, Lst, G, Ab_pows, autonomous: bool):
    """One fused quantum: x [C, T] 0/1 float32 (T % Lb == 0), s [C, 64]
    float32 bit planes -> (s', o [C, T]).

    The block recurrence s_{k+1} = Ab s_k + q_k (mod 2), q_k = G x_k, is
    solved by a log-depth doubling scan (the JAX package runs
    ``lax.associative_scan`` over the affine pairs; torch has none, and
    the pairs' matrix is the constant Ab): the sequence [s_0, q_0, ...,
    q_{B-1}] after the rounds j = 0, 1, ... that add Ab^(2^j) v[:-2^j]
    to v[2^j:] (mod 2) holds s_0 .. s_B. ``Ab_pows`` holds Ab^(2^j)
    (:func:`doubling_powers`)."""
    C, T = x.shape
    Lb = V.shape[0]
    B = T // Lb
    if B >= 1 << Ab_pows.shape[0]:
        raise ValueError(f"lfsr_blocked_step: {B} blocks need more than "
                         f"{Ab_pows.shape[0]} doubling rounds")
    xb = x.reshape(C, B, Lb)
    v = torch.empty((C, B + 1, NBITS), dtype=torch.float32, device=x.device)
    v[:, 0] = s
    if autonomous:
        v[:, 1:] = 0.0
    else:
        v[:, 1:] = _mod2(torch.matmul(xb, G.T))
    shift, j = 1, 0
    while shift <= B:
        moved = torch.matmul(v[:, :-shift], Ab_pows[j].T)
        v = torch.cat([v[:, :shift], _mod2(v[:, shift:] + moved)], dim=1)
        shift, j = shift * 2, j + 1
    o = torch.matmul(v[:, :B], V.T) + xb
    if not autonomous:
        o = o + torch.matmul(xb, Lst.T)
    return v[:, B].contiguous(), _mod2(o).reshape(C, T)
