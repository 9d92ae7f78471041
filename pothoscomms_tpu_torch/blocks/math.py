"""Elementwise math blocks (reference: math/ module, SURVEY.md §2.1); the
port of the JAX package's ``blocks/math.py``: all 35 registered paths.

Each block wraps a functional core from :mod:`pothoscomms_tpu_torch.ops.
elementwise`. Where each dtype runs when the block streams:

- float32 and complex_float32: torch ops on the topology's device (the
  card unless the topology names another), as ``blocks/fft.py`` does;
- float64, complex_float64, the signed integers, uint8 and the complex
  integers built on them: torch ops on the host;
- uint16, uint32, uint64 and their complex forms: numpy on the host for
  the binary ops, comparators, conjugate and the Q-format products of
  Scale and Rotate (torch has no ``+``, ``>`` or ``>>`` on them); their
  unary ops evaluate in float64 through torch on the host, which needs
  only casts.

Fused (core/fusion.py), every float32 and complex_float32 instance that
has a core runs it on the segment's device over planar float32 [C, T] or
[C, T, 2] blocks; comparator verdicts ride as 0/1 float32 and cast to int8
when a host block reads them.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.qformat import float_to_q, q_dtype_for
from pothoscomms_tpu_torch.core.registry import register_block
from pothoscomms_tpu_torch.ops import cint, elementwise as ew


def _f32(dtype: DType) -> bool:
    """float32 and complex_float32 streams run on the block's device."""
    return dtype.is_float and dtype.bits == 32


def _real_f32(dtype: DType) -> bool:
    return _f32(dtype) and not dtype.is_complex


def _tensor(arr, dtype: DType, device) -> torch.Tensor:
    """A queued numpy buffer as a tensor where ``dtype`` computes."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device) if _f32(dtype) else t


def _array(t: torch.Tensor, dtype: DType) -> np.ndarray:
    return t.cpu().numpy().astype(dtype.np, copy=False)


class ElementwiseBlock(Block):
    """Generic N-in/M-out elementwise block: work() = the core over the
    min-available elements (reference pattern: math/Arithmetic.cpp:204-231).

    Every 1-in/1-out float32 instance also implements the auto-fusion
    protocol (core/fusion.py), so chains holding an abs/sinc/trig/... hop
    stay fused — the reference bar is that EVERY math block gets its fast
    kernel from the scheduler automatically (math/Arithmetic.cpp:46-67).
    Real-f32 blocks reuse the core directly on the planar [C, T] block;
    complex-f32 blocks need an explicit ``planar_core`` over [C, T, 2]
    (re, im) planes. ``numpy_core`` marks a core written for numpy arrays
    (the uint16/32/64 twins), run on the host."""

    def __init__(self, dtype, core: Callable, n_in=1, n_out=1, out_dtype=None,
                 planar_core: Callable = None, numpy_core: bool = False):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.out_dtype = DType.parse(out_dtype) if out_dtype else self.dtype
        for i in range(n_in):
            self.setup_input(i, self.dtype)
        for i in range(n_out):
            self.setup_output(i, self.out_dtype)
        self._raw_core = core
        self._planar_core = planar_core
        self._numpy_core = numpy_core
        self._n_in = n_in
        self._n_out = n_out

    def work(self):
        elems = self.clamp_work_size(
            min(self.input(i).elements() for i in range(self._n_in)))
        if elems == 0:
            return
        bufs = [self.input(i).buffer(elems) for i in range(self._n_in)]
        if self._numpy_core:
            outs = self._raw_core(*bufs)
        else:
            outs = self._raw_core(*[_tensor(b, self.dtype, self.device)
                                    for b in bufs])
        if self._n_out == 1:
            outs = (outs,)
        for i in range(self._n_in):
            self.input(i).consume(elems)
        for i in range(self._n_out):
            o = outs[i]
            self.output(i).post(
                np.asarray(o).astype(self.out_dtype.np, copy=False)
                if self._numpy_core else _array(o, self.out_dtype))

    # -- auto-fusion protocol (core/fusion.py): stateless elementwise -- #
    def _fuse_planar_core(self):
        """The core applied on the fused (planar float32) path, or None
        if this instance cannot fuse. N-input instances (Comparator,
        Beta) may HEAD a fan-in segment; an int8 output (comparator
        verdicts) rides as 0/1 f32 and casts on materialization."""
        if self._n_out != 1:
            return None
        if self._n_in == 1 and self._planar_core is not None:
            return self._planar_core
        out_ok = (_real_f32(self.out_dtype)
                  or (self.out_dtype.is_integer
                      and not self.out_dtype.is_complex))
        if _real_f32(self.dtype) and out_ok:
            return self._raw_core
        return None

    def fuse_ready(self) -> bool:
        return self._fuse_planar_core() is not None

    def fuse_label_adjust(self, lb):
        """Elementwise blocks propagate labels verbatim and their compute
        ignores labels — safe to carry labels through a fused quantum
        (single-input runs only; fan-in heads stay opaque)."""
        return lb

    def fuse_export(self, channels: int):
        f = self._fuse_planar_core()
        if self._n_in == 1:
            def step(carry, x):
                return carry, f(x).to(torch.float32)
        else:
            def step(carry, xs):
                return carry, f(*xs).to(torch.float32)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/arithmetic — N-ary elementwise chain with preload for feedback
# loops (reference: math/Arithmetic.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/arithmetic", "/blocks/arithmetic")
def arithmetic_factory(dtype, operation: str):
    return Arithmetic(dtype, operation)


def _planar_binary(op: str):
    """Complex ADD/SUB/MUL/DIV on planar [..., 2] float32."""
    def pfn(a, b):
        ar, ai = a[..., 0], a[..., 1]
        br, bi = b[..., 0], b[..., 1]
        if op == "ADD":
            return a + b
        if op == "SUB":
            return a - b
        if op == "MUL":
            return torch.stack([ar * br - ai * bi, ar * bi + ai * br], -1)
        den = br * br + bi * bi
        return torch.stack([(ar * br + ai * bi) / den,
                            (ai * br - ar * bi) / den], -1)

    return pfn


class Arithmetic(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["arithmetic", "add", "subtract", "multiply",
                     "divide"],
        "factory_args": {
            "operation": {
                "label": "Operation",
                "options": [{"label": o.title(), "value": o} for o in
                            ("ADD", "SUB", "MUL", "DIV")],
                "default": "ADD",
            },
        },
        "params": {
            "num_inputs": {"label": "Num Inputs", "default": 2,
                           "widget": "SpinBox(minimum=2)"},
            "preload": {"label": "Preload", "default": [],
                        "desc": "Zero-sample preload per input port "
                                "(feedback topologies)."},
        },
    }

    def __init__(self, dtype, operation: str):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self._operation = operation.upper()
        self._numpy = ew.host_numpy(self.dtype)
        self._fcn = (ew.binary_arith_np if self._numpy
                     else ew.binary_arith_fn)(self.dtype, self._operation)
        self.setup_input(0, self.dtype)
        self.setup_input(1, self.dtype)  # requires >= 2 inputs
        self.setup_output(0, self.dtype)
        self._preload: List[int] = []
        self._num_inline_buffers = 0

    def set_num_inputs(self, num_inputs: int):
        if num_inputs < 2:
            raise ValueError("Arithmetic requires inputs >= 2")
        for i in range(len(self.inputs), num_inputs):
            self.setup_input(i, self.dtype)

    def set_preload(self, preload: List[int]):
        self.set_num_inputs(max(2, len(preload)))
        self._preload = list(preload)

    def preload(self) -> List[int]:
        return self._preload

    def get_num_inline_buffers(self) -> int:
        return self._num_inline_buffers

    def activate(self):
        # pad chosen inputs with zeros for feedback topologies
        # (reference: math/Arithmetic.cpp:191-202)
        for i, n in enumerate(self._preload):
            if n == 0:
                continue
            shape = (n,) + self.dtype.storage_shape_suffix
            self.input(i).push_buffer(np.zeros(shape, self.dtype.np))

    def work(self):
        ports = [self.input(i) for i in range(len(self.inputs))]
        elems = self.clamp_work_size(min(p.elements() for p in ports))
        if elems == 0:
            return
        bufs = [p.buffer(elems) for p in ports]
        if self._numpy:
            out = bufs[0]
            for b in bufs[1:]:
                out = self._fcn(out, b)
        else:
            # fold into a private copy of in0, in place where the op
            # allows it: the reference's setReadBeforeWrite inlining
            # (math/Arithmetic.cpp:165-168), asserted through the count
            # (math/TestArithmeticBlocks.cpp:381-383)
            x0 = torch.tensor(bufs[0], device=self.device) \
                if _f32(self.dtype) else torch.tensor(bufs[0])
            acc = x0
            for b in bufs[1:]:
                acc = self._fold(acc, _tensor(b, self.dtype, self.device))
            if acc.data_ptr() == x0.data_ptr():
                self._num_inline_buffers += 1
            out = _array(acc, self.dtype)
        for p in ports:
            p.consume(elems)
        self.output(0).post(out)

    def _fold(self, acc, x):
        """acc op x, written over acc for the real ops that have an
        in-place form (C truncating division and complex products build
        new tensors)."""
        op = self._operation
        if not self.dtype.is_complex_int and (op in ("ADD", "SUB", "MUL")
                                             or self.dtype.is_float):
            inplace = {"ADD": acc.add_, "SUB": acc.sub_, "MUL": acc.mul_,
                       "DIV": acc.div_}[op]
            return inplace(x)
        return self._fcn(acc, x)

    def propagate_labels(self, port, labels):
        # feedback (preloaded) ports do not propagate labels
        # (reference: math/Arithmetic.cpp:233-240)
        idx = int(port.name)
        if idx < len(self._preload) and self._preload[idx] > 0:
            return
        super().propagate_labels(port, labels)

    # -- auto-fusion protocol: N-ary fan-in HEAD (core/fusion.py) ------- #
    # The fused segment pulls an aligned quantum from EVERY input port and
    # reduces on device; complex streams fold via planar mul/div.
    def fuse_ready(self) -> bool:
        return _f32(self.dtype)

    def fuse_export(self, channels: int):
        pfn = (_planar_binary(self._operation) if self.dtype.is_complex
               else ew.binary_arith_fn(self.dtype, self._operation))

        def step(carry, xs):
            acc = xs[0]
            for x in xs[1:]:
                acc = pfn(acc, x)
            return carry, acc

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/const_arithmetic (reference: math/ConstArithmetic.cpp)
# --------------------------------------------------------------------- #
_CONST_OP_KEYS = {
    "X+K": "X_PLUS_K",
    "X-K": "X_MINUS_K",
    "K-X": "K_MINUS_X",
    "X*K": "X_MULT_K",
    "X/K": "X_DIV_K",
    "K/X": "K_DIV_X",
}


@register_block("/comms/const_arithmetic")
def const_arithmetic_factory(dtype, operation: str, constant):
    return ConstArithmetic(dtype, operation, constant)


class ConstArithmetic(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["arithmetic", "constant", "scale", "offset"],
        "factory_args": {
            "operation": {
                "label": "Operation",
                "options": [{"label": o, "value": o} for o in
                            ("X+K", "X-K", "K-X", "X*K", "X/K", "K/X")],
                "default": "X+K",
            },
        },
        "params": {
            "constant": {"label": "Constant", "default": 0.0},
        },
    }

    def __init__(self, dtype, operation, constant):
        super().__init__()
        self.dtype = DType.parse(dtype)
        key = _CONST_OP_KEYS.get(operation, operation)
        self._op_key = key
        self._numpy = ew.host_numpy(self.dtype)
        self._fcn = (ew.const_arith_np if self._numpy
                     else ew.const_arith_fn)(self.dtype, key)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self.set_constant(constant)

    def set_constant(self, constant):
        if self.dtype.is_complex_int:
            c = np.asarray([np.real(constant), np.imag(constant)],
                           self.dtype.scalar.np)
        else:
            c = np.asarray(constant, self.dtype.np)
        self._constant = c
        self._bump_fuse_epoch()

    def constant(self):
        if self.dtype.is_complex_int:
            return complex(self._constant[0], self._constant[1])
        return self._constant[()]

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        buf = port.buffer(elems)
        if self._numpy:
            out = self._fcn(buf, self._constant)
        else:
            k = _tensor(self._constant, self.dtype, self.device)
            out = _array(self._fcn(_tensor(buf, self.dtype, self.device),
                                   k), self.dtype)
        port.consume(elems)
        self.output(0).post(out)

    # -- auto-fusion protocol: stateless planar const-arith ------------- #
    def fuse_ready(self) -> bool:
        return _f32(self.dtype)

    def fuse_export(self, channels: int):
        op = self._op_key
        if not self.dtype.is_complex:
            k = float(np.float32(self._constant))
            base = ew.const_arith_fn(self.dtype, op)

            def step(carry, x):
                return carry, base(x, k)

            return (), step
        # complex f32: constant applied in planar (re, im) form
        c = complex(self._constant)
        kr, ki = float(np.float32(c.real)), float(np.float32(c.imag))

        def cmul(x, ar, ai):
            re = x[..., 0] * ar - x[..., 1] * ai
            im = x[..., 0] * ai + x[..., 1] * ar
            return torch.stack([re, im], -1)

        if op == "X_PLUS_K":
            f = lambda x: torch.stack([x[..., 0] + kr, x[..., 1] + ki], -1)
        elif op == "X_MINUS_K":
            f = lambda x: torch.stack([x[..., 0] - kr, x[..., 1] - ki], -1)
        elif op == "K_MINUS_X":
            f = lambda x: torch.stack([kr - x[..., 0], ki - x[..., 1]], -1)
        elif op == "X_MULT_K":
            f = lambda x: cmul(x, kr, ki)
        elif op == "X_DIV_K":
            inv = 1.0 / (c if c != 0 else 1.0)
            ir, ii = float(np.float32(inv.real)), float(np.float32(inv.imag))
            f = lambda x: cmul(x, ir, ii)
        else:  # K_DIV_X: K * conj(x) / |x|^2
            def f(x):
                d = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                d = torch.where(d == 0, torch.ones_like(d), d)
                re = (kr * x[..., 0] + ki * x[..., 1]) / d
                im = (ki * x[..., 0] - kr * x[..., 1]) / d
                return torch.stack([re, im], -1)

        def step(carry, x):
            return carry, f(x)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/scale — Q-format multiply with label-driven factor updates
# (reference: math/Scale.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/scale", "/blocks/scale")
def scale_factory(dtype):
    return Scale(dtype)


class Scale(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["scale", "multiply", "gain"],
        "params": {
            "factor": {"label": "Factor", "default": 0.0},
            "label_id": {"label": "Label ID", "default": "",
                         "preview": "valid",
                         "desc": "Label ID whose data sets the factor "
                                 "sample-accurately mid-stream."},
        },
    }

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self._qdtype = q_dtype_for(self.dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._label_id = ""
        self.set_factor(0.0)

    def _kernel(self, buf):
        """tmp = factor_q * Q(x); out = fromQ(tmp) (reference
        math/Scale.cpp:15-23), on a queued buffer."""
        qs = self._qdtype.scalar
        if self.dtype.is_integer:
            half = qs.bits // 2
            if ew.host_numpy(qs):
                with np.errstate(over="ignore"):
                    tmp = buf.astype(qs.np) * self._factor_scaled
                return (tmp >> half).astype(self.dtype.np)
            tmp = torch.from_numpy(buf).to(qs.torch) \
                * int(self._factor_scaled)
            return (tmp >> half).to(self.dtype.torch).numpy()
        x = _tensor(buf, self.dtype, self.device)
        return _array(x * float(self._factor_scaled), self.dtype)

    def set_factor(self, factor: float):
        self._factor = float(factor)
        # ScaleType is the real scalar Q type even for complex data
        self._factor_scaled = float_to_q(self._factor, self._qdtype.scalar)
        self._bump_fuse_epoch()

    def get_factor(self) -> float:
        return self._factor

    def set_label_id(self, label_id: str):
        self._label_id = label_id

    def get_label_id(self) -> str:
        return self._label_id

    def _scan_labels(self, port, elems: int) -> int:
        """Apply label-driven reconfiguration; returns the (possibly
        truncated) work size (reference: math/Scale.cpp:104-122)."""
        if not self._label_id:
            return elems
        for lb in sorted(port.labels, key=lambda l: l.index):
            if lb.index >= elems:
                break
            if lb.id == self._label_id:
                if lb.index == 0:
                    self.set_factor(float(lb.data))
                else:
                    return lb.index
        return elems

    def work(self):
        port = self.input(0)
        elems = self.clamp_work_size(port.elements())
        if elems == 0:
            return
        elems = self._scan_labels(port, elems)
        out = self._kernel(np.ascontiguousarray(port.buffer(elems)))
        port.consume(elems)
        self.output(0).post(out)

    def device_core(self, channels: int, device=None):
        """Fused-chain core (parallel/compiler.py): y = x * factor over a
        planar float32 [C, T(, 2)] block; stateless, runs where x lies."""
        factor = float(np.float32(self._factor))

        def step(carry, x):
            return carry, x * factor

        return (), step

    # -- auto-fusion protocol (core/fusion.py): stateless; label-driven
    # factor updates arrive as labels, which disengage the segment.
    def fuse_ready(self) -> bool:
        return _f32(self.dtype)

    def fuse_export(self, channels: int):
        return self.device_core(channels)

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# /comms/rotate — complex multiply by e^{j phase} in Q format
# (reference: math/Rotate.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/rotate")
def rotate_factory(dtype):
    return Rotate(dtype)


class Rotate(Block):
    DOC = {
        "category": "/Math",
        "keywords": ["rotate", "phasor", "multiply"],
        "params": {
            "phase": {"label": "Phase", "default": 0.0,
                      "units": "radians"},
            "label_id": {"label": "Label ID", "default": "",
                         "preview": "valid"},
        },
    }

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if not self.dtype.is_complex:
            raise ValueError("rotate requires a complex dtype")
        self._qdtype = q_dtype_for(self.dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._label_id = ""
        self.set_phase(0.0)

    def _kernel(self, buf):
        qs = self._qdtype.scalar
        if self.dtype.is_integer:
            half = qs.bits // 2
            ph = self._phasor.astype(qs.np)
            if ew.host_numpy(qs):
                prod = ew.cint_mul_np(buf.astype(qs.np), ph)
                return (prod >> half).astype(self.dtype.np)
            prod = cint.mul(torch.from_numpy(buf).to(qs.torch),
                            torch.from_numpy(ph))
            return (prod >> half).to(self.dtype.torch).numpy()
        x = _tensor(buf, self.dtype, self.device)
        phasor = torch.from_numpy(np.asarray(self._phasor)).to(x.device)
        return _array(x * phasor, self.dtype)

    def set_phase(self, phase: float):
        self._phase = float(phase)
        self._phasor = float_to_q(np.exp(1j * self._phase), self._qdtype)
        self._bump_fuse_epoch()

    def get_phase(self) -> float:
        return self._phase

    def set_label_id(self, label_id: str):
        self._label_id = label_id

    def get_label_id(self) -> str:
        return self._label_id

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        if self._label_id:
            for lb in sorted(port.labels, key=lambda l: l.index):
                if lb.index >= elems:
                    break
                if lb.id == self._label_id:
                    if lb.index == 0:
                        self.set_phase(float(lb.data))
                    else:
                        elems = lb.index
                        break
        out = self._kernel(np.ascontiguousarray(port.buffer(elems)))
        port.consume(elems)
        self.output(0).post(out)

    # -- auto-fusion protocol: stateless planar complex rotate ---------- #
    def fuse_ready(self) -> bool:
        return _f32(self.dtype)

    def fuse_export(self, channels: int):
        ph = np.exp(1j * self._phase)
        pr, pi = float(np.float32(ph.real)), float(np.float32(ph.imag))

        def step(carry, x):
            re = x[..., 0] * pr - x[..., 1] * pi
            im = x[..., 0] * pi + x[..., 1] * pr
            return carry, torch.stack([re, im], -1)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# --------------------------------------------------------------------- #
# Comparators (reference: math/Comparator.cpp, math/ConstComparator.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/comparator")
def comparator_factory(dtype, operation: str):
    dt = DType.parse(dtype)
    if ew.host_numpy(dt):
        return ElementwiseBlock(dt, ew.comparator_np(operation), n_in=2,
                                out_dtype="int8", numpy_core=True)
    return ElementwiseBlock(dt, ew.comparator_fn(operation), n_in=2,
                            out_dtype="int8")


@register_block("/comms/const_comparator")
def const_comparator_factory(dtype, operation: str, constant=0):
    return ConstComparator(DType.parse(dtype), operation, constant)


class ConstComparator(Block):
    def __init__(self, dtype, operation, constant):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, DType.parse("int8"))
        self._numpy = ew.host_numpy(self.dtype)
        self._cmp = (ew.comparator_np if self._numpy
                     else ew.comparator_fn)(operation)
        self.set_constant(constant)

    def set_constant(self, constant):
        self._constant = np.asarray(constant, self.dtype.np)
        self._bump_fuse_epoch()

    # -- auto-fusion protocol: f32 stream -> 0/1 planar (int8 tail) ----- #
    def fuse_ready(self) -> bool:
        return _real_f32(self.dtype)

    def fuse_export(self, channels: int):
        k = float(np.float32(self._constant))
        cmp = self._cmp

        def step(carry, x):
            # the fused path is float32: emit 0.0/1.0; the DeviceChunk's
            # int8 dtype casts on materialization
            return carry, cmp(x, k).to(torch.float32)

        return (), step

    def fuse_import(self, carry) -> None:
        pass

    def constant(self):
        return self._constant[()]

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        buf = port.buffer(elems)
        if self._numpy:
            out = self._cmp(buf, self._constant)
        else:
            x = _tensor(buf, self.dtype, self.device)
            k = _tensor(self._constant, self.dtype, self.device)
            out = self._cmp(x, k).cpu().numpy()
        port.consume(elems)
        self.output(0).post(out)


# --------------------------------------------------------------------- #
# Simple unary blocks
# --------------------------------------------------------------------- #
def _planar_abs(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def _planar_angle(x):
    return torch.atan2(x[..., 1], x[..., 0])


def _planar_conj(x):
    return torch.stack([x[..., 0], -x[..., 1]], -1)


def _np_conj(x):
    return np.stack([x[..., 0], -x[..., 1]], -1)


@register_block("/comms/abs")
def abs_factory(dtype):
    dt = DType.parse(dtype)
    if dt.kind == "uint":
        raise ValueError("abs: unsigned types unsupported (reference matrix)")
    out = dt.scalar if dt.is_complex else dt
    planar = _planar_abs if (dt.is_complex and _f32(dt)) else None
    return ElementwiseBlock(dt, ew.abs_fn(dt), out_dtype=out,
                            planar_core=planar)


@register_block("/comms/angle")
def angle_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_complex:
        raise ValueError("angle requires a complex dtype")
    planar = _planar_angle if _f32(dt) else None
    return ElementwiseBlock(dt, ew.angle_fn(dt), out_dtype=dt.scalar,
                            planar_core=planar)


@register_block("/comms/conjugate")
def conjugate_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_complex:
        raise ValueError("conjugate requires a complex dtype")
    if ew.host_numpy(dt):
        return ElementwiseBlock(dt, _np_conj, numpy_core=True)
    planar = _planar_conj if _f32(dt) else None
    return ElementwiseBlock(dt, ew.conjugate_fn(dt), planar_core=planar)


def _float_unary_factory(name):
    def factory(dtype):
        dt = DType.parse(dtype)
        if not dt.is_float or dt.is_complex:
            raise ValueError(f"{name}: float types only")
        return ElementwiseBlock(dt, ew.unary_fn(dt, name))

    return factory


for _name in ("sinc", "sigmoid", "gamma", "lngamma", "erf", "erfc"):
    register_block(f"/comms/{_name}")(_float_unary_factory(_name))


@register_block("/comms/rsqrt")
def rsqrt_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("rsqrt: float types only")
    return ElementwiseBlock(dt, ew.rsqrt_fn(dt))


@register_block("/comms/beta")
def beta_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("beta: float types only")
    return ElementwiseBlock(dt, ew.beta_fn(dt), n_in=2)


# --------------------------------------------------------------------- #
# Trigonometric — 24 ops in one block (reference: math/Trigonometric.cpp)
# --------------------------------------------------------------------- #
@register_block("/comms/trigonometric")
def trig_factory(dtype, operation: str):
    return Trigonometric(dtype, operation)


class Trigonometric(ElementwiseBlock):
    DOC = {
        "category": "/Math",
        "keywords": ["trig", "sin", "cos", "tan", "hyperbolic"],
        "params": {
            "operation": {
                "label": "Operation",
                "options": [{"label": o.title(), "value": o}
                            for o in sorted(ew.TRIG_OPS)],
                "default": "SIN",
            },
        },
    }

    def __init__(self, dtype, operation):
        dt = DType.parse(dtype)
        if not dt.is_float or dt.is_complex:
            raise ValueError("trigonometric: float types only")
        self._op = None
        super().__init__(dt, lambda x: x)
        self.set_operation(operation)

    def set_operation(self, op: str):
        if op not in ew.TRIG_OPS:
            raise ValueError(f"invalid trig operation {op}")
        self._op = op
        self._raw_core = ew.TRIG_OPS[op]
        self._bump_fuse_epoch()


# --------------------------------------------------------------------- #
# Pow / roots (reference: math/Pow.cpp, math/Root.cpp)
# --------------------------------------------------------------------- #
class _ParamUnary(Block):
    """Unary block with one runtime scalar parameter."""

    def __init__(self, dtype, core2, param):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._raw_core2 = core2
        self._param = np.asarray(param, np.float64)

    def set_param(self, value) -> None:
        self._param = np.asarray(value, np.float64)
        self._bump_fuse_epoch()

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        x = _tensor(port.buffer(elems), self.dtype, self.device)
        out = self._raw_core2(x, float(self._param))
        port.consume(elems)
        self.output(0).post(_array(out, self.dtype))

    # -- auto-fusion protocol: stateless f32 unary with baked param ----- #
    def fuse_ready(self) -> bool:
        return _real_f32(self.dtype)

    def fuse_export(self, channels: int):
        p = float(np.float32(self._param))
        core2 = self._raw_core2

        def step(carry, x):
            return carry, core2(x, p)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


@register_block("/comms/pow")
def pow_factory(dtype, exponent=0.0):
    dt = DType.parse(dtype)
    if dt.is_complex:
        raise ValueError("pow: real types only")
    blk = _ParamUnary(dt, ew.pow_fn(dt), exponent)
    blk.set_exponent = blk.set_param
    blk.exponent = lambda: blk._param[()]
    blk.setExponent = blk.set_exponent
    return blk


@register_block("/comms/sqrt")
def sqrt_factory(dtype):
    dt = DType.parse(dtype)
    return ElementwiseBlock(dt, ew.root_fn(dt, "sqrt"))


@register_block("/comms/cbrt")
def cbrt_factory(dtype):
    dt = DType.parse(dtype)
    return ElementwiseBlock(dt, ew.root_fn(dt, "cbrt"))


@register_block("/comms/nth_root")
def nth_root_factory(dtype, root=1.0):
    dt = DType.parse(dtype)
    blk = _ParamUnary(dt, ew.root_fn(dt, "nth"), root)
    blk.set_root = blk.set_param
    blk.root = lambda: blk._param[()]
    blk.setRoot = blk.set_root
    return blk


# --------------------------------------------------------------------- #
# Log / Exp families (reference: math/Log.cpp, math/Exp.cpp)
# --------------------------------------------------------------------- #
def _simple_unary_factory(name):
    def factory(dtype):
        dt = DType.parse(dtype)
        if dt.is_complex:
            raise ValueError(f"{name}: real types only")
        return ElementwiseBlock(dt, ew.unary_fn(dt, name))

    return factory


for _name in ("log", "log2", "log10", "log1p", "exp", "exp2", "exp10",
              "expm1"):
    register_block(f"/comms/{_name}")(_simple_unary_factory(_name))


class _BaseUnary(ElementwiseBlock):
    """logN / expN: an elementwise block whose core depends on a base."""

    _make = None  # ew.logn_fn or ew.expn_fn
    _what = ""

    def __init__(self, dtype, base):
        super().__init__(dtype, type(self)._make(DType.parse(dtype),
                                                 float(base)))
        self._base = float(base)

    def set_base(self, b):
        if b <= 1:
            raise ValueError(f"{self._what} base must be > 1")
        self._raw_core = type(self)._make(self.dtype, float(b))
        self._base = float(b)
        self._bump_fuse_epoch()

    def base(self):
        return self._base


class _LogN(_BaseUnary):
    _make = staticmethod(ew.logn_fn)
    _what = "logN"


class _ExpN(_BaseUnary):
    _make = staticmethod(ew.expn_fn)
    _what = "expN"


@register_block("/comms/logN")
def logn_factory(dtype, base=10.0):
    return _LogN(dtype, base)


@register_block("/comms/expN")
def expn_factory(dtype, base=10.0):
    return _ExpN(dtype, base)


# --------------------------------------------------------------------- #
# ModF — two output ports (reference: math/ModF.cpp:17-40)
# --------------------------------------------------------------------- #
@register_block("/comms/modf")
def modf_factory(dtype):
    dt = DType.parse(dtype)
    if not dt.is_float or dt.is_complex:
        raise ValueError("modf: float types only")
    return ModF(dt)


class ModF(Block):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output("int", self.dtype)
        self.setup_output("frac", self.dtype)
        self._core = ew.modf_fn(self.dtype)

    def work(self):
        port = self.input(0)
        elems = port.elements()
        if elems == 0:
            return
        integral, frac = self._core(_tensor(port.buffer(elems), self.dtype,
                                            self.device))
        port.consume(elems)
        self.output("int").post(_array(integral, self.dtype))
        self.output("frac").post(_array(frac, self.dtype))

    # -- auto-fusion: 2-output TAIL (int plane, frac plane) ------------- #
    def fuse_ready(self) -> bool:
        return _real_f32(self.dtype)

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        def step(carry, x):
            i = torch.trunc(x)
            return carry, (i, x - i)

        return (), step

    def fuse_import(self, carry) -> None:
        pass
