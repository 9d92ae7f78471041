"""The link's receiver bank in a closed loop over a pool of window batches
already on the card, one step in flight: the step returns its frames on
the host, so the next step starts after it.

Traffic keys: ``channels``, ``samples_per_step`` (the window), ``pool``
(window batches played in a cycle), ``gap_min`` and ``gap_max`` (each
frame's leading gap, drawn uniformly), ``warmup_s`` and ``warmup_steps``,
``profile_steps`` (the traced sub-window) and ``check_steps`` (steps of
the window the check compares with the reference in full, drawn from the
seed; the window's last step is compared too).

The reference (``reference/<config>.py``) makes the pool from the seed
(``pool``: the transmitted bits, the gaps and the windows), so the traffic
comes from code other than the program's. The configuration module gives
``weights(cfg, seed)`` and ``step_entry(cfg, weights, channels, window,
device) -> receive`` with ``receive(x, lengths) -> frames`` (``found``,
``bits``, ``offset``, ``scale``, ``dfc``, ``phase``, numpy on the host).

A step's latency runs from the host's call to its frames on the host. A
step counts channels x window samples. ``attempted`` counts the frames
of the window's steps and ``failed`` those not found or not bit-exact:
each step's payloads are compared with the transmitted bits as the step
returns, after its latency is taken (one ``memcmp`` where every payload
is right; the check's time, summed over the window, goes to standard
error), and only the frames of the steps the check compares in full are
kept. The receiver's counters (``parallel/link``: seconds, bytes, frames)
are read before and after the window where the program has them.
"""

from __future__ import annotations

import ctypes
import sys
import time

import numpy as np

from benchmark import harness

_memcmp = ctypes.CDLL(None).memcmp
_memcmp.restype = ctypes.c_int
_memcmp.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)

COUNTERS = ("search_s", "decode_s", "d2h_bytes", "frames", "frames_found",
            "header_rejects")


def read_counters() -> dict:
    """The receive path's counters where the program has them, else {}."""
    from pothoscomms_tpu_torch.parallel import link

    got = {k: getattr(link, k) for k in COUNTERS if hasattr(link, k)}
    shifts = getattr(link, "align_shift", None)
    if shifts is not None:
        got["align_shift"] = dict(shifts)
    return got


def _gained(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = {s: n - before.get(k, {}).get(s, 0) for s, n in v.items()}
        else:
            out[k] = v - before.get(k, 0)
    return out


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.dev = ctx.device
        self.channels = int(t["channels"])
        self.window = int(t["samples_per_step"])
        self.marks = [("start", time.perf_counter())]
        self.pool = ctx.reference.pool(ctx.cfg, t, ctx.seed, self.dev)
        harness.sync(self.dev)
        self.marks.append(("inputs", time.perf_counter()))
        self.weights = ctx.config_module.weights(ctx.cfg, ctx.seed)
        self.receive = ctx.config_module.step_entry(
            ctx.cfg, self.weights, self.channels, self.window, self.dev)
        self.lengths = np.full(self.channels, self.window, np.int64)
        self.marks.append(("build", time.perf_counter()))
        self.i = 0
        self.sample = None      # a Reservoir while the window runs
        self.kept = {}          # step -> its frames, for the check
        self.last = None        # (step, frames) of the last step
        self.payload = {"bit_errors": 0, "frames_lost": 0, "failed": 0}
        self.judge_s = 0.0      # the window's time in judge()

    def run(self, seconds: float, min_steps: int = 0) -> dict:
        """Steps for ``seconds`` and at least ``min_steps``."""
        lat = []
        t0 = time.perf_counter()
        stop = t0 + seconds
        n = 0
        while n < min_steps or time.perf_counter() < stop:
            x = self.pool[self.i % len(self.pool)]["x"]
            t_call = time.perf_counter()
            with harness.span("step call"):
                got = self.receive(x, self.lengths)
            lat.append(time.perf_counter() - t_call)
            if self.sample is not None:
                t_judge = time.perf_counter()
                self.judge(got)
                self.judge_s += time.perf_counter() - t_judge
            self.i += 1
            n += 1
        harness.sync(self.dev)
        return {"window_s": time.perf_counter() - t0, "steps": n,
                "latencies_s": lat}

    def judge(self, got) -> None:
        """Step ``self.i``'s payloads against the transmitted bits; its
        frames are kept if the reservoir takes the step, and as the last
        step's until the next step returns."""
        lost, errors, bad = payload_errors(
            got, self.pool[self.i % len(self.pool)]["bits"])
        self.payload["frames_lost"] += lost
        self.payload["bit_errors"] += errors
        self.payload["failed"] += bad
        taken, old = self.sample.offer(self.i)
        if taken:
            self.kept.pop(old, None)
            self.kept[self.i] = got
        self.last = (self.i, got)


def setup(ctx) -> State:
    st = State(ctx)
    t = ctx.traffic
    st.run(0.0, min_steps=1)    # the first call builds the kernel
    st.marks.append(("first step", time.perf_counter()))
    st.run(float(t["warmup_s"]), min_steps=int(t["warmup_steps"]))
    st.marks.append(("warm-up", time.perf_counter()))
    harness.print_marks(ctx, st.marks)
    return st


def measure(st: State, seconds: float, trace: bool) -> dict:
    rng = np.random.default_rng([st.ctx.seed, 1])
    st.sample = harness.Reservoir(int(st.ctx.traffic["check_steps"]), rng)
    before = read_counters()
    win = st.run(seconds)
    counters = _gained(read_counters(), before)
    counters["window_s"] = win["window_s"]
    st.sample = None
    st.attempted = win["steps"] * st.channels
    print(f"benchmark: payload check {st.judge_s!r} s of the window's "
          f"{win['window_s']!r} s, {1e3 * st.judge_s / win['steps']!r} ms "
          f"a step of {1e3 * win['window_s'] / win['steps']!r} ms",
          file=sys.stderr)
    i_last, got = st.last
    st.kept[i_last] = got
    out = {"window_s": win["window_s"], "steps": win["steps"],
           "samples": win["steps"] * st.channels * st.window,
           "latencies_s": win["latencies_s"], "counters": counters,
           "step_shape": {"channels": st.channels, "samples": st.window}}
    if trace:
        k = int(st.ctx.traffic["profile_steps"])
        out["trace"] = harness.profiled(
            lambda: st.run(0.0, min_steps=k)["steps"], st.dev)
    return out


def payload_errors(frames, bits: np.ndarray):
    """(frames lost, bit errors of the found ones, frames not found or not
    bit-exact). Where the payloads lie as ``bits`` do, one ``memcmp`` of
    their bytes finds the usual case, every payload right."""
    found = np.asarray(frames.found, bool)
    lost = int(found.size - np.count_nonzero(found))
    got = np.asarray(frames.bits)
    if (got.dtype == bits.dtype and got.shape == bits.shape
            and got.flags.c_contiguous and bits.flags.c_contiguous
            and _memcmp(got.ctypes.data, bits.ctypes.data, got.nbytes) == 0):
        return lost, 0, lost
    per_frame = np.count_nonzero(got != bits, axis=1)[found]
    return lost, int(per_frame.sum()), lost + int(np.count_nonzero(per_frame))


def check(st: State):
    """(checks, attempted, failed): every step's payloads against the
    transmitted bits (``bit_errors`` and ``frames_lost`` summed over the
    window as the steps returned), and the kept steps against the
    reference's receiver on the same window (the largest ``offset_err``,
    ``scale_rel``, ``dfc_abs`` and ``phase_abs``)."""
    harness.sync(st.dev)
    ref, cfg, limits = st.ctx.reference, st.ctx.cfg, st.ctx.limits
    kept, payload = st.kept, st.payload
    st.receive = st.last = None
    st.kept = {}
    values = {"bit_errors": float(payload["bit_errors"]),
              "frames_lost": float(payload["frames_lost"])}
    for i in sorted(kept):
        batch = st.pool[i % len(st.pool)]
        got = ref.check_step(cfg, batch["x"], kept.pop(i), batch["bits"])
        for k in ("offset_err", "scale_rel", "dfc_abs", "phase_abs"):
            values[k] = max(values.get(k, got[k]), got[k])
    return {k: (v, limits[k]) for k, v in values.items()}, \
        st.attempted, payload["failed"]


def control(ctx, steps: int) -> list:
    """The control's readings: the reference's receiver with its search in
    the lower precision (``control_output``) in the program's place for
    steps 1..``steps`` of the cell's own pool, each judged as a step of
    the program is."""
    t = ctx.traffic
    pool = ctx.reference.pool(ctx.cfg, t, ctx.seed, ctx.device)
    out = []
    for i in range(1, steps + 1):
        batch = pool[i % len(pool)]
        got = ctx.reference.control_output(ctx.cfg, batch["x"])
        vals = ctx.reference.check_step(ctx.cfg, batch["x"], got,
                                        batch["bits"])
        out.append(vals)
    return out
