"""Hand-written CUDA kernels for Hopper and their Python wrappers.

- :mod:`.cgemm`: K1, the split-complex GEMM.
- :mod:`.fft`: K2, the batched complex FFT.
- :mod:`.fir_fft_fused`: K3, the one-pass FIR+FFT step, and the
  one-pass chain built on it.
- :mod:`.fir_decim`: K4, the decimating FIR with its carry, which
  ``parallel/chain.FirFftChain``'s ``"polyphase"`` form runs before K2
  (the JAX package's strided ``lax.conv``; not a Pallas port).
- :mod:`.envelope`: E1, the attack/release envelope follower (the JAX
  package's envelope scans; not a Pallas port).
- :mod:`.fm_demod_dc`: F1, the FM discriminator and the DC-removal
  cascade in one pass (the JAX package's XLA ops for the two cores; not
  a Pallas port); ``parallel/compiler.compile_chain`` takes it for a
  FreqDemod followed by a float32 DCRemoval.
- :mod:`.iir_df2t`: I1, the DF-II-T IIR recurrence over rows with its
  state (the JAX package's XLA ``iir_blocked_step``; not a Pallas port);
  ``blocks/filter.IIRFilter``'s fused core takes it on a card.
- :mod:`.sync_search`: S1, the frame-sync search over every offset of
  every channel (the JAX package's XLA search program; not a Pallas
  port).
- :mod:`.stream_scale` and :mod:`.layout_move`: P1 and P2, the probes of
  the card's streaming roof and of in-row layout moves.
- :mod:`.build`: nvcc build of ``csrc/*.cu`` and ctypes loading.

Each wrapper launches its kernel for a CUDA tensor, uses its plain
PyTorch version for a CPU tensor, and counts its launches in
``<wrapper>.launches``. A launch's host enqueue runs inside the span
``pc.kernel.<wrapper>`` (``parallel/profiling.annotate``). A wrapper's
first call on a card, where ``launches`` reads 0, runs inside the build
span ``pc.build.first_launch.<wrapper>`` (``parallel/profiling.
first_launch``), and a library's load inside ``pc.build.library.<name>``
(:mod:`.build`).
"""
