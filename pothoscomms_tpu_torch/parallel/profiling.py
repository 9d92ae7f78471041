"""Profiling helpers: a ``torch.profiler`` trace, the program's spans, and
the analytic FLOP/byte model of the FIR -> FFT chain.

- :func:`trace`: context manager writing a trace directory readable by
  TensorBoard's profiler plugin (and a Chrome-trace JSON per run).
- :func:`annotate`: the program's span, recorded only while a profiler
  runs.
- :func:`chain_flops`: FLOP/byte model of the combined-operator step.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

# the context manager every span returns while no profiler runs
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Capture a host (and, when a card is present, device) trace:

        with profiling.trace("traces/run1"):
            spec, carry = run(x, carry)
            torch.cuda.synchronize()
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)) as prof:
        yield prof


def annotate(name: str):
    """The program's span: ``with annotate("pc.segment.pull"): ...``.

    While a ``torch.profiler`` session runs (:func:`trace`, or any other
    caller's), the span is a range named ``name`` on the profiler's host
    timeline, on the clock of the card's rows; otherwise it is one shared
    no-op, and a span costs a flag test. The profiler is the only switch.

    The range is recorded at function scope, as an operator's is, so it
    has no row on the device timeline: a user-scope range
    (``record_function``) is mirrored there under its own name, and a
    reader of device time would count it as work. The program's span
    names start with ``pc.``; a name that depends on a class is built
    where the chain or topology is built, never here.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


def chain_flops(channels: int, time: int, taps: int, nbins: int,
                prev_pad: int) -> dict:
    """FLOP/byte model of one FIR -> FFT step (planar complex f32).

    - ``necessary``: a K-tap time-domain complex FIR (8 flops per complex
      MAC) plus a two-factor FFT (N1+N2 complex MACs per sample, plus the
      twiddle).
    - ``executed``: the combined-operator step
      (``chain.fir_fft_combined_step``): (nbins + prev_pad) complex MACs
      per sample in the 4-product form (8 real flops per MAC; the JAX
      package's Karatsuba form counts 6).
    """
    samples = channels * time
    n1 = max(nbins // 128, 1)
    n2 = nbins // n1
    fft = (n1 + n2) * 8 + 6
    necessary = samples * (taps * 8 + fft)
    executed = samples * (nbins + prev_pad) * 8
    bytes_moved = samples * 2 * 4 * 2  # planar in + spectra out
    return {
        "necessary_gflop": round(necessary / 1e9, 2),
        "executed_gflop": round(executed / 1e9, 2),
        "hbm_mbytes": round(bytes_moved / 1e6, 1),
    }
