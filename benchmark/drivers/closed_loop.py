"""Closed loop over a pool of inputs already on the card, the carry chained
from step to step, at most ``in_flight`` steps queued (a double-buffered
receiver at 2).

Traffic keys: ``channels``, ``samples_per_step``, ``pool`` (inputs played
in a cycle), ``in_flight``, ``warmup_s`` and ``warmup_steps`` (set-up runs
steps for at least both), ``profile_s`` (the traced sub-window's length),
``check_steps`` (how many steps of the window the check compares, drawn
from the seed; the window's last step is compared too) and ``signal``
(``generate.py``).

The configuration module gives ``weights(cfg, seed)`` and
``step_entry(cfg, weights, channels, samples, device) -> (step, carry0)``
with ``step(x, carry) -> (y, carry)``.

A step's latency runs from the host's call of the step to the host seeing
the step's completion event; step ``i``'s input is ``pool[i % pool]``,
counting from the first step of set-up.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from benchmark import generate, harness


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.dev = ctx.device
        self.channels = int(t["channels"])
        self.samples = int(t["samples_per_step"])
        self.in_flight = int(t["in_flight"])
        self.marks = [("start", time.perf_counter())]
        self.pool = generate.pool(t["signal"], int(t["pool"]), self.channels,
                                  self.samples, ctx.seed, self.dev)
        harness.sync(self.dev)
        self.marks.append(("inputs", time.perf_counter()))
        self.weights = ctx.config_module.weights(ctx.cfg, ctx.seed)
        self.step, self.carry = ctx.config_module.step_entry(
            ctx.cfg, self.weights, self.channels, self.samples, self.dev)
        self.marks.append(("build", time.perf_counter()))
        self.i = 0
        self.sample = None      # a Reservoir while the window runs
        self.kept = {}          # step -> its output, for the check
        self.last = None        # (step, output, carry) of the last step

    def run(self, seconds: float, min_steps: int = 0) -> dict:
        """Steps for ``seconds`` and at least ``min_steps``, then a drain;
        the window ends when every step it issued has completed."""
        inflight = collections.deque()
        lat, enq = [], []
        t0 = time.perf_counter()
        stop = t0 + seconds
        n = 0

        def retire():
            t_call, done = inflight.popleft()
            with harness.span("sync wait"):
                done.wait()
            lat.append(time.perf_counter() - t_call)

        while n < min_steps or time.perf_counter() < stop:
            if len(inflight) >= self.in_flight:
                retire()
            x = self.pool[self.i % len(self.pool)]
            t_call = time.perf_counter()
            with harness.span("step call"):
                y, self.carry = self.step(x, self.carry)
            enq.append(time.perf_counter() - t_call)
            inflight.append((t_call, harness.Completion(self.dev)))
            if self.sample is not None:
                taken, old = self.sample.offer(self.i)
                if taken:
                    self.kept.pop(old, None)
                    self.kept[self.i] = y
            self.last = (self.i, y, self.carry)
            self.i += 1
            n += 1
        while inflight:
            retire()
        harness.sync(self.dev)
        return {"window_s": time.perf_counter() - t0, "steps": n,
                "latencies_s": lat, "enqueue_s": enq}


def setup(ctx) -> State:
    st = State(ctx)
    t = ctx.traffic
    st.run(0.0, min_steps=1)    # the first call builds the kernels
    st.marks.append(("first step", time.perf_counter()))
    st.run(float(t["warmup_s"]), min_steps=int(t["warmup_steps"]))
    st.marks.append(("warm-up", time.perf_counter()))
    harness.print_marks(ctx, st.marks)
    return st


def measure(st: State, seconds: float, trace: bool) -> dict:
    rng = np.random.default_rng([st.ctx.seed, 1])
    st.sample = harness.Reservoir(int(st.ctx.traffic["check_steps"]), rng)
    first = st.i
    win = st.run(seconds)
    out = {"window_s": win["window_s"], "steps": win["steps"],
           "samples": win["steps"] * st.channels * st.samples,
           "latencies_s": win["latencies_s"],
           "enqueue_s": win["enqueue_s"],
           "step_shape": {"channels": st.channels, "samples": st.samples}}
    if trace:
        prof_s = float(st.ctx.traffic["profile_s"])
        out["trace"] = harness.profiled(lambda: st.run(prof_s)["steps"],
                                        st.dev)
    st.sample = None
    st.attempted = st.i - first
    return out


def check(st: State):
    """(checks, attempted, failed): each compared number, the largest over
    the sampled steps and the last, beside its limit."""
    harness.sync(st.dev)
    ref = st.ctx.reference
    cfg, w, pool = st.ctx.cfg, st.weights, st.pool
    i_last, y_last, carry_last = st.last
    kept = dict(st.kept)
    kept[i_last] = y_last
    attempted = st.attempted
    # the program's state goes before the reference runs
    st.step = st.carry = st.last = None
    st.kept = {}
    limits = st.ctx.limits
    values, failed = {}, 0
    for i in sorted(kept):
        x_prev = pool[(i - 1) % len(pool)] if i > 0 else None
        got = ref.check_step(cfg, w, x_prev, pool[i % len(pool)],
                             kept.pop(i))
        if i == i_last:
            got.update(ref.check_carry(cfg, w, pool[i % len(pool)],
                                       carry_last))
        failed += any(not v <= limits[k] for k, v in got.items())
        for k, v in got.items():
            values[k] = max(values.get(k, v), v)
    return {k: (v, limits[k]) for k, v in values.items()}, attempted, failed


def control(ctx, steps: int) -> list:
    """The control's readings: the reference's control output (lower
    precision, ``reference/<config>.py``) in the program's place for
    steps 1..``steps`` of the cell's own inputs, each judged as a step
    of the program is."""
    t = ctx.traffic
    c, n, p = int(t["channels"]), int(t["samples_per_step"]), int(t["pool"])
    pool = generate.pool(t["signal"], p, c, n, ctx.seed, ctx.device)
    w = ctx.config_module.weights(ctx.cfg, ctx.seed)
    ref = ctx.reference
    out = []
    for i in range(1, steps + 1):
        x_prev, x = pool[(i - 1) % p], pool[i % p]
        y = ref.control_output(ctx.cfg, w, x_prev, x)
        out.append(ref.check_step(ctx.cfg, w, x_prev, x, y))
        del y
    return out
