"""One wideband stream through the block API: host numpy buffers fed in a
cycle to a committed ``Topology``, each step one ``feed_buffer`` and one
``wait_inactive()``, into a sink of the benchmark's that keeps no copy.

Traffic keys: ``buffer_samples``, ``buffers`` (host buffers played in a
cycle, one stream; page-locked beside the card), ``warmup_s`` and
``warmup_steps``, ``profile_steps`` (the traced sub-window),
``check_steps`` (steps of the window whose whole output the check
compares, drawn from the seed), ``head_samples`` (the
first output samples of every step of the window, copied as they pass and
compared too: they are where a step's carry shows), ``head_context`` (the
input samples before a head that its reference is given) and ``signal``.

The configuration module gives ``weights(cfg, seed)``,
``topology_entry(cfg, weights, device, sink) -> (topology, feeder)`` and
``stream_delay(cfg)``: output sample j has input j + delay as its newest.
Step i's output range is [i N, (i + 1) N) for N samples a buffer; its last
samples need the next buffer, so the window's last step is not due.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generate, harness
from pothoscomms_tpu_torch import Block, DType
from pothoscomms_tpu_torch.core.fusion import DeviceChunk


def _planar(part) -> torch.Tensor:
    """A part that reached the sink as planar float32 [n, 2]."""
    if isinstance(part, DeviceChunk):
        return part.planar.float().reshape(-1, 2)
    a = np.ascontiguousarray(part, np.complex64)
    return torch.from_numpy(a.view(np.float32).reshape(-1, 2))


class KeptSink(Block):
    """Takes every part that reaches it; keeps, without a copy, the parts
    of the output ranges of the steps in ``wanted``, and a copy of the
    first ``head`` samples of every step's range; drops the rest."""

    def __init__(self, dtype, span: int, head: int):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.span = span
        self.head = head
        self.pos = 0
        self.wanted = set()
        self.kept = {}   # step -> [(first output index, part)]
        self.heads = {}  # step -> [(first output index, planar copy)]

    def want(self, step: int) -> None:
        self.wanted.add(step)

    def drop(self, step: int) -> None:
        self.wanted.discard(step)
        self.kept.pop(step, None)

    def work(self):
        port = self.input(0)
        n = port.elements()
        if not n:
            return
        for part in port.take(n):
            a = self.pos
            b = a + len(part)
            for s in range(a // self.span, (b - 1) // self.span + 1):
                if s in self.wanted:
                    lo = max(a, s * self.span)
                    hi = min(b, (s + 1) * self.span)
                    self.kept.setdefault(s, []).append(
                        (lo, part[lo - a:hi - a]))
                lo = max(a, s * self.span)
                hi = min(b, s * self.span + self.head)
                if lo < hi:
                    self.heads.setdefault(s, []).append(
                        (lo, _planar(part[lo - a:hi - a]).clone()))
            self.pos = b

    @staticmethod
    def _whole(parts, n: int):
        parts = sorted(parts, key=lambda p: p[0])
        planes = [q if isinstance(q, torch.Tensor) else _planar(q)
                  for _, q in parts]
        if sum(len(q) for q in planes) != n:
            return None
        dev = next((q.device for q in planes if q.is_cuda), planes[0].device)
        return torch.cat([q.to(dev) for q in planes])

    def head_of(self, step: int):
        """The first ``head`` output samples of the step as planar [head,
        2], or None when part of them never came."""
        return self._whole(self.heads.get(step, []), self.head)

    def output_of(self, step: int):
        """The step's whole output range as planar float32 [N, 2], or None
        when part of it never came."""
        return self._whole(self.kept.get(step, []), self.span)


class State:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.dev = ctx.device
        self.n = int(t["buffer_samples"])
        self.marks = [("start", time.perf_counter())]
        self.bufs = generate.host_buffers(t["signal"], int(t["buffers"]),
                                          self.n, ctx.seed, self.dev)
        self.marks.append(("inputs", time.perf_counter()))
        self.weights = ctx.config_module.weights(ctx.cfg, ctx.seed)
        self.delay = ctx.config_module.stream_delay(ctx.cfg)
        self.head = int(t["head_samples"])
        self.sink = KeptSink("complex_float32", self.n, self.head)
        self.topo, self.feeder = ctx.config_module.topology_entry(
            ctx.cfg, self.weights, self.dev, self.sink)
        self.marks.append(("build", time.perf_counter()))
        self.i = 0
        self.failed = 0
        self.sample = None

    def counters(self) -> dict:
        segs = getattr(self.topo, "_segments", [])
        stats = self.topo.query_stats()
        return {"fused_elements": sum(s.fused_elements for s in segs),
                "engages": sum(s.engage_count for s in segs),
                "work_time_s": sum(b["work_time_s"] for b in stats.values()),
                "fed_samples": self.i * self.n}

    def run(self, seconds: float, min_steps: int = 0) -> dict:
        """Steps for ``seconds`` and at least ``min_steps``; the window
        ends when the card has finished them."""
        t0 = time.perf_counter()
        stop = t0 + seconds
        n = 0
        while n < min_steps or time.perf_counter() < stop:
            if self.sample is not None:
                taken, old = self.sample.offer(self.i)
                if taken:
                    self.sink.drop(old)
                    self.sink.want(self.i)
            with harness.span("feed"):
                self.feeder.feed_buffer(self.bufs[self.i % len(self.bufs)])
            with harness.span("wait_inactive"):
                ok = self.topo.wait_inactive(timeout=120.0)
            self.failed += not ok
            self.i += 1
            n += 1
        harness.sync(self.dev)
        return {"window_s": time.perf_counter() - t0, "steps": n}

    def stream(self, a: int, b: int) -> torch.Tensor:
        return stream(self.bufs, a, b, self.dev)


def stream(bufs, a: int, b: int, device) -> torch.Tensor:
    """Samples [a, b) of the stream that plays ``bufs`` in a cycle, as
    planar [1, b - a, 2] on ``device``."""
    n = len(bufs[0])
    out = np.empty(b - a, np.complex64)
    pos = a
    while pos < b:
        k, off = divmod(pos, n)
        m = min(b - pos, n - off)
        out[pos - a:pos - a + m] = bufs[k % len(bufs)][off:off + m]
        pos += m
    return torch.from_numpy(out.view(np.float32).reshape(1, -1, 2)).to(device)


def setup(ctx) -> State:
    st = State(ctx)
    t = ctx.traffic
    st.run(0.0, min_steps=1)    # engages the segment, builds the kernels
    st.marks.append(("first step", time.perf_counter()))
    st.run(float(t["warmup_s"]), min_steps=int(t["warmup_steps"]))
    st.marks.append(("warm-up", time.perf_counter()))
    harness.print_marks(ctx, st.marks)
    return st


def measure(st: State, seconds: float, trace: bool) -> dict:
    rng = np.random.default_rng([st.ctx.seed, 1])
    st.sample = harness.Reservoir(int(st.ctx.traffic["check_steps"]), rng)
    first, before = st.i, st.counters()
    st.first = first
    win = st.run(seconds)
    after = st.counters()
    counters = {k: after[k] - before[k] for k in after}
    counters["window_s"] = win["window_s"]
    out = {"window_s": win["window_s"], "steps": win["steps"],
           "samples": win["steps"] * st.n, "counters": counters,
           "step_shape": {"channels": 1, "samples": st.n}}
    if trace:
        k = int(st.ctx.traffic["profile_steps"])
        out["trace"] = harness.profiled(
            lambda: st.run(0.0, min_steps=k)["steps"], st.dev)
    st.sample = None
    st.attempted = st.i - first
    st.last = st.i - 1
    return out


def check(st: State):
    """(checks, attempted, failed): each sampled step's whole output, and
    the head of every step of the window, against the reference; a range
    that never came whole fails, and so does a step with a bad head."""
    harness.sync(st.dev)
    ref, cfg, w = st.ctx.reference, st.ctx.cfg, st.weights
    limits = st.ctx.limits
    steps = sorted(s for s in st.sink.wanted if s != st.last)
    outs = {s: st.sink.output_of(s) for s in steps}
    heads = {s: st.sink.head_of(s) for s in range(st.first, st.last + 1)}
    # the program's state goes before the reference runs
    st.sink.kept.clear()
    st.sink.heads.clear()
    st.topo = st.feeder = None
    values, bad = {}, set()
    context = int(st.ctx.traffic["head_context"])
    work = [(s, st.n, st.n, outs.pop(s)) for s in steps] + \
        [(s, context, st.head, y) for s, y in heads.items()]
    for s, before, n, y in work:
        if y is None:
            bad.add(s)
            continue
        a = s * st.n + st.delay
        got = ref.check_step(cfg, w, st.stream(a - before, a),
                             st.stream(a, a + n), y)
        del y
        if any(not v <= limits[k] for k, v in got.items()):
            bad.add(s)
        for k, v in got.items():
            values[k] = max(values.get(k, v), v)
    failed = st.failed + len(bad)
    if not values:  # nothing came to be checked
        failed += 1
        values = dict.fromkeys(limits)
    return ({k: (v, limits[k]) for k, v in values.items()},
            st.attempted, failed)


def control(ctx, steps: int) -> list:
    """The control's readings: the reference's control output in the
    program's place for the output ranges of steps 1..``steps`` of the
    cell's own stream, each judged as a step of the program is."""
    t = ctx.traffic
    n, nb = int(t["buffer_samples"]), int(t["buffers"])
    bufs = generate.host_buffers(t["signal"], nb, n, ctx.seed, ctx.device)
    w = ctx.config_module.weights(ctx.cfg, ctx.seed)
    delay = ctx.config_module.stream_delay(ctx.cfg)
    ref = ctx.reference
    out = []
    for i in range(1, steps + 1):
        a = i * n + delay
        x_prev = stream(bufs, a - n, a, ctx.device)
        x = stream(bufs, a, a + n, ctx.device)
        y = ref.control_output(ctx.cfg, w, x_prev, x)
        out.append(ref.check_step(ctx.cfg, w, x_prev, x, y))
        del y
    return out
