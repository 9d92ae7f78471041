"""The benchmark's general part: finding a cell's files by name, the device
check, the closed measurement window's bookkeeping, the traced
sub-window, the metric readers and the result line.

A run (``main``) goes through five stages:

1. set-up: the driver (``drivers/<driver>.py``, named by the traffic
   file) builds the program through its public entry points, makes the
   inputs from the seed and warms up every shape the cell uses;
2. the measured window (``--seconds``), with no profiler; with
   ``--trace 1`` a short profiled sub-window follows it;
3. the peak of device memory is read and the program's state freed;
4. the check: the outputs the timed path produced (a sample of whole
   steps drawn from the seed, kept without a copy) against the plain
   reference (``reference/<config>.py``), each number beside its limit
   (``limits`` in ``configs/<config>.json``);
5. the readers (``metrics/<metric>.py``) turn what the window recorded
   into the cell's metrics, and one JSON line is printed.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pothoscomms_tpu")
SPANS = ("step call", "sync wait", "feed", "wait_inactive")
SEED_MOD = 1 << 63
NAME_CHARS = 120  # a device operation's name in the breakdown, cut to this
PROGRAM = "pc."  # the program's span names start so
HOST_OTHER = "host other"  # idle outside every host span


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than the cell asks for."""


# ---------------------------------------------------------------------- #
# files by name
# ---------------------------------------------------------------------- #
def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a Python file of the benchmark by its path. A file whose
    name holds dots (``metrics/runtime.fused_pct.py``) imports as well;
    the module is cached in ``sys.modules`` under a name made from the
    path, so one path gives one module object."""
    path = Path(path).resolve()
    name = "_bench_" + hashlib.sha1(str(path).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration, traffic, driver,
    reference, work count and metric entries, all found by name under
    ``root/benchmark``."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        entry = cells[name]
        bench = Path(root) / "benchmark"
        self.name = name
        self.chips = int(entry["chips"])
        self.config_name = entry["config"]
        self.traffic_name = entry["traffic"]
        self.cfg = load_json(bench / "configs" / f"{self.config_name}.json")
        self.traffic = load_json(
            bench / "traffic" / f"{self.traffic_name}.json")
        self.config_module = load_module(
            bench / "configs" / f"{self.config_name}.py")
        self.reference = load_module(
            bench / "reference" / f"{self.config_name}.py")
        self.counts = load_module(bench / "counts" / f"{self.config_name}.py")
        self.driver = load_module(
            bench / "drivers" / f"{self.traffic['driver']}.py")
        self.peaks = load_json(bench / "peaks.json")
        self.bench = bench
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: str):
        return load_module(reader_path(self.bench, metric))


def reader_path(bench: Path, metric: str) -> Path:
    """The reader of ``metric``: ``metrics/<metric>.py``, else the reader
    of the name without its last dotted part, and so on. A quantity split
    by the end-to-end metric it moves (``device_idle_pct.host_paced``
    beside ``device_idle_pct``) so has one reader; a split name may still
    bring a reader of its own."""
    name = metric
    while not (bench / "metrics" / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    path = bench / "metrics" / f"{name}.py"
    return path if path.is_file() else bench / "metrics" / f"{metric}.py"


# ---------------------------------------------------------------------- #
# the run's context
# ---------------------------------------------------------------------- #
class Context:
    """What a driver gets: the cell, the device, the seed (reduced to a
    non-negative 63-bit integer, so numpy and torch take it) and the
    time origin of set-up."""

    def __init__(self, cell: Cell, seed: int, device, t_start: float):
        self.cell = cell
        self.cfg = cell.cfg
        self.traffic = cell.traffic
        self.seed = int(seed) % SEED_MOD
        self.device = device
        self.t_start = t_start
        self.config_module = cell.config_module
        self.reference = cell.reference
        self.limits = cell.cfg["limits"]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Algorithm R), its choices drawn from ``rng``: which steps of the
    window the check compares."""

    def __init__(self, k: int, rng):
        self.k = k
        self.rng = rng
        self.seen = 0
        self.items: Dict[int, Any] = {}

    def offer(self, key: int):
        """Offer ``key``; returns (taken, the key it displaced or None)."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items[key] = None
            return True, None
        j = int(self.rng.integers(0, self.seen))
        if j >= self.k:
            return False, None
        old = sorted(self.items)[j]
        del self.items[old]
        self.items[key] = None
        return True, old


def print_marks(ctx, marks) -> None:
    """Set-up's pieces on standard error: the seconds before the driver
    started (imports, the card), then between consecutive marks."""
    parts = [f"before {marks[0][1] - ctx.t_start:.3f}"]
    parts += [f"{name} {t - t0:.3f}"
              for (_, t0), (name, t) in zip(marks, marks[1:])]
    print("benchmark: set-up s: " + ", ".join(parts), file=sys.stderr)


def sync(device) -> None:
    """Wait for the device's queued work (the CPU has none)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Completion:
    """A step's completion as the host sees it: a CUDA event on the card;
    on the CPU a step is complete when its call returns."""

    def __init__(self, device):
        import torch

        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


@contextmanager
def span(name: str):
    """A host span the traced sub-window names its idle gaps by."""
    from torch.profiler import record_function

    with record_function(name):
        yield


# ---------------------------------------------------------------------- #
# the traced sub-window
# ---------------------------------------------------------------------- #
def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(open_spans) -> str:
    """The innermost of the open spans, ``(duration, name)`` each: the
    shortest, as nesting makes it (ties by name)."""
    return min(open_spans)[1] if open_spans else HOST_OTHER


def _root(open_spans) -> str:
    """The outermost open program span, else the innermost open span."""
    program = [v for v in open_spans if v[1].startswith(PROGRAM)]
    return max(program)[1] if program else _innermost(open_spans)


def _sweep(hosts, idle, probes):
    """One sweep over the window. ``hosts`` are host spans ``(name,
    start, end)``, ``idle`` the window's idle intervals and ``probes``
    instants. Returns (idle_by_span, idle_by_root, the spans open at each
    probe as ``(duration, name)``): every idle instant is charged once to
    the innermost span open then, and once to :func:`_root`'s span, each
    in microseconds. A span that starts or ends at a probe covers it."""
    ev = [(a, 0, j) for j, (_, a, _) in enumerate(hosts)]
    ev += [(b, 2, j) for j, (_, _, b) in enumerate(hosts)]
    ev += [(a, 0, -1) for a, _ in idle] + [(b, 2, -1) for _, b in idle]
    ev += [(t, 1, j) for j, t in enumerate(probes)]
    ev.sort()
    by_span: Dict[str, float] = {}
    by_root: Dict[str, float] = {}
    at: List[list] = [[] for _ in probes]
    active: Dict[int, tuple] = {}
    idling, prev = 0, None
    for t, kind, j in ev:
        if idling and t > prev:
            inner, root = _innermost(active.values()), _root(active.values())
            by_span[inner] = by_span.get(inner, 0.0) + (t - prev)
            by_root[root] = by_root.get(root, 0.0) + (t - prev)
        prev = t
        if kind == 1:
            at[j] = list(active.values())
        elif j < 0:
            idling += 1 if kind == 0 else -1
        elif kind == 0:
            n, a, b = hosts[j]
            active[j] = (b - a, n)
        else:
            active.pop(j, None)
    return by_span, by_root, at


def summarize_trace(events, steps: int) -> dict:
    """Reduce a profiled sub-window to numbers. ``events`` are
    ``(kind, name, start_us, end_us)`` with kind "device" (a kernel, copy
    or set on the card) or "host" (a span of :data:`SPANS`, a program span,
    named ``pc.*``, or "window", the span around the whole sub-window). A
    device event may have a fifth element, the names of the program spans
    open at its launch (:func:`trace_events`).

    Returns busy_s (the union of device intervals inside the window),
    window_s, kernel_s (the summed duration of the device events inside
    the window), device_ops (the ten names of most device time), idle_gaps
    (the ten longest gaps between device work, each named by the innermost
    host span at its midpoint), and, in seconds:

    - idle_by_span: every idle instant charged to the innermost host span
      open then (else "host other");
    - idle_by_root: the same idle charged to the outermost program span
      open then, else to the innermost benchmark span, else "host other";
    - device_by_span: for each program span, the device time of the
      events launched inside an instance of it (a launch inside nested
      spans counts toward each);
    - device_unclaimed_s: the device time of events no program span
      launched;

    and program_spans, the number of instances of each program span in
    the window."""
    windows = [(e[2], e[3]) for e in events
               if e[0] == "host" and e[1] == "window"]
    if not windows:
        return {}
    w0, w1 = windows[0]
    dev = [(e[1], max(e[2], w0), min(e[3], w1), e[4] if len(e) > 4 else ())
           for e in events if e[0] == "device" and e[3] > w0 and e[2] < w1]
    busy = _union([(a, b) for _, a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    by_span: Dict[str, float] = {}
    unclaimed = 0.0
    for n, a, b, spans in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        for s in spans:
            by_span[s] = by_span.get(s, 0.0) + (b - a)
        if not spans:
            unclaimed += b - a
    hosts = [(e[1], e[2], e[3]) for e in events
             if e[0] == "host" and e[1] != "window"]
    idle = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    idle_span, idle_root, mids = _sweep(
        hosts, idle, [0.5 * (a + b) for a, b in idle])
    gaps = [(_innermost(o), (b - a) * 1e-6) for o, (a, b) in zip(mids, idle)]
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = [(n[:NAME_CHARS], us) for n, us in ops]
    program: Dict[str, int] = {}
    for n, a, b in hosts:
        if n.startswith(PROGRAM) and b > w0 and a < w1:
            program[n] = program.get(n, 0) + 1
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernel_s": sum(b - a for _, a, b, _ in dev) * 1e-6,
        "steps": steps,
        "device_ops": [[n, us * 1e-6] for n, us in ops],
        "idle_gaps": [[n, s] for n, s in gaps[:10]],
        "idle_by_span": _seconds(idle_span),
        "idle_by_root": _seconds(idle_root),
        "device_by_span": _seconds(by_span),
        "device_unclaimed_s": unclaimed * 1e-6,
        "program_spans": program,
    }


def _seconds(us: Dict[str, float]) -> Dict[str, float]:
    """Microseconds by name as seconds, the most first."""
    return {n: v * 1e-6 for n, v in sorted(us.items(), key=lambda kv: -kv[1])}


def trace_events(fevents, device_type) -> tuple:
    """The profiler's events (``prof.events()``) as :func:`summarize_trace`
    takes them. A device event's program spans are those open at the start
    of its launch's runtime call: the host event with the device event's
    own id, linked to an op or named ``cu*``. The spans' own device rows
    and the spin framing are left out. Returns (events, the number of
    device events no program span claims)."""
    keep = set(SPANS) | {"window"}
    events, cuda, program, runtime = [], [], [], {}
    for e in fevents:
        if e.device_type == device_type:
            if e.name not in keep and "spin_kernel" not in e.name:
                cuda.append(e)  # not the spans' own rows, not the framing
            continue
        a, b = e.time_range.start, e.time_range.end
        if e.name in keep or e.name.startswith(PROGRAM):
            events.append(("host", e.name, a, b))
        if e.name.startswith(PROGRAM):
            program.append((e.name, a, b))
        if getattr(e, "linked_correlation_id", 0) or e.name.startswith("cu"):
            runtime[e.id] = a   # a runtime call: the id of its device rows
    launched = [e for e in cuda if e.id in runtime]
    _, _, found = _sweep(program, [], [runtime[e.id] for e in launched])
    spans = {id(e): {n for _, n in o} for e, o in zip(launched, found)}
    unclaimed = 0
    for e in cuda:
        names = tuple(sorted(spans.get(id(e), ())))
        unclaimed += not names
        events.append(("device", e.name, e.time_range.start,
                       e.time_range.end, names))
    return events, unclaimed


def profiled(loop, device) -> dict:
    """Run ``loop()`` (which returns the number of steps it ran) under
    ``torch.profiler``, inside a host span "window" that ends after a
    synchronization, and summarize it (:func:`trace_events`,
    :func:`summarize_trace`). Two short spin kernels on each side frame
    the window (the profiler tends to lose the first device event of a
    session); they are outside it. The events stay in memory. The device
    time no program span claims, and the idle and device time by span,
    go to standard error."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with warnings.catch_warnings(), profile(activities=acts) as prof:
        warnings.simplefilter("ignore", UserWarning)
        if device.type == "cuda":
            for _ in range(2):
                torch.cuda._sleep(1000)
            sync(device)
        with record_function("window"):
            steps = loop()
            sync(device)
        if device.type == "cuda":
            for _ in range(2):
                torch.cuda._sleep(1000)
            sync(device)
    events, unclaimed = trace_events(prof.events(), DeviceType.CUDA)
    tr = summarize_trace(events, steps)
    if tr:
        print_trace(tr, unclaimed)
    return tr


def print_trace(tr: dict, unclaimed: int) -> None:
    """The traced window's charges on standard error."""
    def top(d, k=12):
        return ", ".join(f"{n} {v!r}" for n, v in list(d.items())[:k])

    idle = tr["window_s"] - tr["busy_s"]
    print(f"benchmark: traced device time no program span claims: "
          f"{tr['device_unclaimed_s']!r} s of {tr['kernel_s']!r} s "
          f"({unclaimed} device events)", file=sys.stderr)
    print(f"benchmark: traced idle {idle!r} s of {tr['window_s']!r} s; by "
          f"root (sum {sum(tr['idle_by_root'].values())!r}): "
          f"{top(tr['idle_by_root'])}", file=sys.stderr)
    print(f"benchmark: traced idle by span: {top(tr['idle_by_span'])}",
          file=sys.stderr)
    print(f"benchmark: traced device time by span: "
          f"{top(tr['device_by_span'])}", file=sys.stderr)


# ---------------------------------------------------------------------- #
# the card
# ---------------------------------------------------------------------- #
def find_card(chips: int):
    """The card the run uses; raises :class:`NoCard` when there are fewer
    than ``chips``. Never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"torch.cuda.device_count() is {n}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({type(exc).__name__})"
    return proc.stdout.strip() or f"not read (exit {proc.returncode})"


def device_block(device, chips: int, peak: int,
                 trace: Optional[dict]) -> dict:
    import torch

    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if trace:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    :data:`FORBIDDEN`, compared whole (``pothoscomms_tpu_torch`` is not
    ``pothoscomms_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def idle_pct(trace: Optional[dict], roots) -> Optional[float]:
    """The share of the traced window, in %, in which the card idled while
    the outermost program span open on the host was named with one of the
    prefixes ``roots``, a tuple (``idle_by_root``). None without a trace,
    a device event or a program span."""
    if not trace or not trace.get("busy_s") or not trace.get("window_s") \
            or not trace.get("program_spans"):
        return None
    idle = sum(s for n, s in trace["idle_by_root"].items()
               if n.startswith(roots))
    return 100.0 * idle / trace["window_s"]


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


# ---------------------------------------------------------------------- #
# one run
# ---------------------------------------------------------------------- #
def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Set-up, window, check and metrics of one run; returns the result
    object (without printing it)."""
    import torch

    ctx = Context(cell, seed, device, t_start)
    driver = cell.driver
    state = driver.setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start
    meas = driver.measure(state, seconds, trace)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    t_check = time.perf_counter()
    checks, attempted, failed = driver.check(state)
    print(f"benchmark: setup_s {setup_s!r}, window_s "
          f"{meas.get('window_s')!r}, steps {meas.get('steps')!r}, check "
          f"{time.perf_counter() - t_check!r} s", file=sys.stderr)
    meas["setup_s"] = setup_s
    meas["work"] = cell.counts.work(cell.cfg, meas["step_shape"])
    meas["peaks"] = cell.peaks.get(
        torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu")
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(meas)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = failed == 0 and all(
        v is not None and v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_block(device, cell.chips, peak,
                                     meas.get("trace") if trace else None)}
    if trace and meas.get("trace"):
        result["breakdown"] = {"device_ops": meas["trace"]["device_ops"],
                               "idle_gaps": meas["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None, t_start: Optional[float] = None, root: Path = ROOT,
         require_card: bool = True, device=None) -> int:
    """One run of one cell; prints the result as the last line of stdout
    and returns the exit code: 0, or 2 without a card, 3 when a
    forbidden module is loaded, 4 when the program is not this
    checkout's (then no result is printed)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    manifest = load_json(Path(root) / "BENCHMARK.json")
    cell = Cell(manifest, args.workload, root)
    import torch

    program = Path(sys.modules["pothoscomms_tpu_torch"].__file__).resolve()
    if ROOT not in program.parents:
        print(f"benchmark: the program was imported from {program}, not "
              f"from this checkout ({ROOT}); no result", file=sys.stderr)
        return 4

    t_imports = time.perf_counter()
    if require_card:
        try:
            device = find_card(cell.chips)
        except NoCard as exc:
            print(f"benchmark: no card: {exc}; no result", file=sys.stderr)
            return 2
    else:
        device = torch.device("cpu") if device is None else device
    print(f"benchmark: before set-up s: imports {t_imports - t_start:.3f}, "
          f"card {time.perf_counter() - t_imports:.3f}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start)
    if device.type == "cuda":
        print(f"benchmark: {cell.name} on {torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} card(s) seen, {cell.chips} "
              f"used; nvidia-smi: {power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0
