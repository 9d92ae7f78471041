"""Hand-written CUDA kernels for Hopper and their Python wrappers.

- :mod:`.cgemm`: K1, the split-complex GEMM.
- :mod:`.fft`: K2, the batched complex FFT.
- :mod:`.fir_fft_fused`: K3, the one-pass FIR+FFT step, and the
  one-pass chain built on it.
- :mod:`.build`: nvcc build of ``csrc/*.cu`` and ctypes loading.

Each wrapper launches its kernel for a CUDA tensor, uses its plain
PyTorch version for a CPU tensor, and counts its launches in
``<wrapper>.launches``.
"""
