"""Streaming ceiling of one CUDA card: P1, a x2 kernel over two f32 planes
[32768, 1024] at row tiles tb in {128, 256, 512} (the counterpart of
benches/probe_pallas_ceiling.py).

    python3 benches_torch/probe_stream_ceiling.py   # from the repo root

Prints one JSON line: per tile ``tb{N}_ms`` and ``tb{N}_GBs`` (2*2*B*N*4
bytes per call, two planes in and out, as the JAX probe counts), the
plain version's (``x * 2`` on each plane, two calls), one library call's
(``torch._foreach_mul`` of both planes by 2: ``library_ms``) and
``Tensor.copy_``'s numbers beside them, the card's name and its power
limit. Times are CUDA events over 10 calls that cycle through 4 input
pairs made on the card (1 GiB, far above the 50 MB L2), each writing a
fresh output, after two warm-up rounds. Needs a CUDA card; exits non-zero
without one.

The timing helpers here (:func:`event_ms`, :func:`device_ms`,
:func:`median_ms`) also serve the other probes and ``chip_smoke.py``.
"""

import json
import statistics
import subprocess
import sys
import time
from collections import Counter, deque
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pothoscomms_tpu_torch.kernels.stream_scale import (  # noqa: E402
    stream_scale, stream_scale_plain)

B, N = 32768, 1024
TILES = (128, 256, 512)
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, published


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bytes_bound_ms(nbytes: float) -> float:
    """The least time in ms to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def median_ms(fn, reps: int = 5, warmup_s: float = 0.25) -> float:
    """Median CUDA-event ms of ``reps`` single calls of ``fn()``, after a
    quarter second of warm-up (so the clocks have left idle)."""
    fn()
    t_end = time.perf_counter() + warmup_s
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def event_ms(fn, pool, calls: int = 10) -> float:
    """Mean ms per call of ``fn(*args)`` over ``calls`` calls cycling
    through ``pool``, by CUDA events, after two warm-up rounds. The last
    ``len(pool)`` results are kept alive, so each call writes a buffer
    other than the one the call before wrote (the caching allocator would
    hand it the same one, which may still sit in L2); the warm-up leaves
    every buffer of that rotation allocated, so no timed call allocates."""
    hold = deque(maxlen=len(pool))
    for args in pool * 2:
        hold.append(fn(*args))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        hold.append(fn(*pool[i % len(pool)]))
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def reading_holds(events: int, calls: int, per_call: int, ms: float,
                  floor_ms: float) -> bool:
    """Whether a profiler reading of ``calls`` calls counts: it kept every
    device event (``calls * per_call`` of them, ``per_call`` >= 1) and its
    mean per call is not below ``floor_ms``, the least time the work can
    take. The profiler now and then drops events, and a reading short of
    either is then too low."""
    return per_call >= 1 and events == calls * per_call and ms >= floor_ms


def device_ms(fn, pool, calls: int = 20, per_call: int | None = None,
              floor_ms: float = 0.0, tries: int = 3):
    """Mean device time per call of ``fn(*args)``: the summed duration of
    the device events (kernels, copies) that ``torch.profiler`` records
    over ``calls`` calls cycling through ``pool``, after two warm-up
    rounds, each call writing a fresh buffer as in :func:`event_ms`. Unlike
    :func:`event_ms` it leaves out the gaps in which the card waits for
    the host to enqueue the next call, which dominate calls of ~20 us.

    ``per_call`` is the number of device events one call makes; when it
    is None a profiled single call counts them. A reading is kept only
    where :func:`reading_holds`; each one refused is reported on stderr
    with its event count and the names of its commonest events, and after
    ``tries`` refused readings the result is None (not measured).

    The profiler tends to lose the first device event of a session (on an
    H100 with torch 2.11, in a long process, 19 of 20 calls), so the calls
    are framed by two short spin kernels on each side
    (``torch.cuda._sleep``), which are left out of the count and the sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hold = deque(maxlen=len(pool))

    def trace(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                torch.cuda._sleep(1000)
            for i in range(n):
                hold.append(fn(*pool[i % len(pool)]))
            for _ in range(2):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name]
        return evs, sum(e.device_time_total for e in evs) / 1e3

    for args in pool * 2:
        hold.append(fn(*args))
    for _ in range(tries):
        k = per_call if per_call is not None else len(trace(1)[0])
        evs, ms = trace(calls)
        if reading_holds(len(evs), calls, k, ms / calls, floor_ms):
            return ms / calls
        names = Counter(e.name[:60] for e in evs).most_common(4)
        print(f"device_ms: refused a reading of {len(evs)} device events "
              f"({calls} calls x {k} expected), {ms / calls:.5f} ms a call "
              f"(floor {floor_ms:.5f}); commonest: {names}",
              file=sys.stderr)
    return None


def random_pool(shape, count: int, dev, seed: int = 0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g) for _ in range(count)]


def run(b: int = B, n: int = N, tiles=TILES) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_stream_ceiling: no CUDA card")
    dev = torch.device("cuda:0")
    planes = random_pool((b, n), 8, dev)
    pool = list(zip(planes[0::2], planes[1::2]))
    nbytes = 2 * 2 * b * n * 4
    res = {"shape": [b, n], "bound_ms": bytes_bound_ms(nbytes)}
    for tb in tiles:
        ms = event_ms(lambda xr, xi, tb=tb: stream_scale(xr, xi, tb), pool)
        res[f"tb{tb}_ms"] = ms
        res[f"tb{tb}_GBs"] = nbytes / ms / 1e6
    ms = event_ms(stream_scale_plain, pool)
    res["plain_ms"], res["plain_GBs"] = ms, nbytes / ms / 1e6
    # one PyTorch call computing P1's function: both planes times 2
    ms = event_ms(lambda xr, xi: torch._foreach_mul((xr, xi), 2.0), pool)
    res["library_ms"], res["library_GBs"] = ms, nbytes / ms / 1e6
    outs = [(torch.empty_like(xr), torch.empty_like(xi)) for xr, xi in pool]

    def copy(i):
        outs[i][0].copy_(pool[i][0])
        outs[i][1].copy_(pool[i][1])

    ms = event_ms(copy, [(i,) for i in range(len(pool))])
    res["copy_ms"], res["copy_GBs"] = ms, nbytes / ms / 1e6
    res["device"] = torch.cuda.get_device_name(0)
    res["card"] = card()
    return res


if __name__ == "__main__":
    print(json.dumps(run()))
    sys.exit(0)
