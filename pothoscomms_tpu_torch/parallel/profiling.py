"""Profiling helpers: a ``torch.profiler`` trace, the program's spans, the
build record of its set-up, and the analytic FLOP/byte model of the
FIR -> FFT chain.

- :func:`trace`: context manager writing a trace directory readable by
  TensorBoard's profiler plugin (and a Chrome-trace JSON per run).
- :func:`annotate`: the program's span, recorded only while a profiler
  runs.
- :func:`build`: the span of work that makes state kept for later steps
  (a library load, a kernel's first launch, a core, an operator, a
  table), whose host seconds go to the process's build record,
  :func:`build_record`, whatever the profiler does.
- :func:`chain_flops`: FLOP/byte model of the combined-operator step.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from typing import Iterator, Optional

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


# ---------------------------------------------------------------------- #
# the build record
# ---------------------------------------------------------------------- #
_lock = threading.Lock()
_builds: dict = {}     # name -> [first_n, first_s, again_n, again_s]
_seen: set = set()     # the (name, key) pairs built so far
_compiled: dict = {}   # library -> the compiler's seconds
_open = threading.local()  # the thread's open build spans' inner seconds
_ids = weakref.WeakKeyDictionary()
_next_id = itertools.count(1)
# kernel wrappers whose first call on a card runs now (:func:`first_launch`)
launching: set = set()


@contextlib.contextmanager
def build(name: str, key=None):
    """The span of a build: ``with build("pc.build.core.IIRFilter", key):``
    around work that makes state kept for later steps. Per-call work is
    never a build.

    It is the :func:`annotate` span of the same ``name``, so a profiled
    set-up shows it on the host timeline. Whatever the profiler does, its
    host seconds (``time.perf_counter``) go to the process's record under
    ``name``: as a first build where ``(name, key)`` is new in this
    process, else as a rebuild. A build's seconds are its own: a build
    span opened inside it (a library loaded by a first launch) keeps its
    seconds, so the record's seconds add up to the time inside any build
    span. ``key`` is any hashable; the program's names start with
    ``pc.build.``.
    """
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    stack.append(0.0)
    t0 = time.perf_counter()
    try:
        with annotate(name):
            yield
    finally:
        total = time.perf_counter() - t0
        own = total - stack.pop()
        if stack:
            stack[-1] += total
        with _lock:
            row = _builds.setdefault(name, [0, 0.0, 0, 0.0])
            again = 2 if (name, key) in _seen else 0
            _seen.add((name, key))
            row[again] += 1
            row[again + 1] += own


def first_launch(wrapper, *args, **kwargs):
    """``wrapper(*args, **kwargs)``, the first call of a kernel wrapper on
    a card, inside the build span ``pc.build.first_launch.<wrapper>``: its
    library's load, its constants and the card's load of the kernel's
    module. A wrapper calls it where its ``launches`` counter reads 0 and
    it is not in :data:`launching`; the call made here is, so it launches.
    A launch after the first pays only that one test of the counter."""
    launching.add(wrapper)
    try:
        with build("pc.build.first_launch." + wrapper.__name__):
            return wrapper(*args, **kwargs)
    finally:
        launching.discard(wrapper)


def compiled(library: str, seconds: float) -> None:
    """Note that ``library`` was compiled in this process, in ``seconds``
    of the compiler's time (``kernels/build.load``'s nvcc, the native
    library's g++)."""
    with _lock:
        _compiled[library] = _compiled.get(library, 0.0) + seconds


def identity(obj) -> int:
    """A number for ``obj`` that no other object of this process gets
    while or after it lives (``id`` is reused once an object is freed):
    the key of a build that belongs to one block or segment."""
    with _lock:
        if obj not in _ids:
            _ids[obj] = next(_next_id)
        return _ids[obj]


def build_record(since: Optional[dict] = None) -> dict:
    """The process's build record: ``{"builds": {name: {"first_n",
    "first_s", "again_n", "again_s"}}, "compiled": {library: seconds}}``,
    a copy. With ``since``, an earlier record, the difference: what was
    built and compiled after it (names and libraries that did not change
    are left out)."""
    with _lock:
        now = {"builds": {n: dict(zip(("first_n", "first_s", "again_n",
                                       "again_s"), row))
                          for n, row in _builds.items()},
               "compiled": dict(_compiled)}
    if since is None:
        return now
    builds = {}
    for name, row in now["builds"].items():
        before = since["builds"].get(name, {})
        diff = {k: v - before.get(k, 0) for k, v in row.items()}
        if diff["first_n"] or diff["again_n"]:
            builds[name] = diff
    comp = {lib: s - since["compiled"].get(lib, 0.0)
            for lib, s in now["compiled"].items()
            if s != since["compiled"].get(lib, 0.0)}
    return {"builds": builds, "compiled": comp}


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
