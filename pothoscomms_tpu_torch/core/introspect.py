"""Observability + checkpoint/resume + docs plane (the port of the JAX
package's ``core/introspect.py``).

The reference has none of this in-repo (SURVEY.md §5: stats exist only in
Pothos core; no checkpointing anywhere). Here they are first-class:

- ``query_stats(topology)``: per-block work/time/port counters, the
  equivalent of Pothos core's ``queryJSONStats`` (referenced from
  mac/TestSimpleLlc.cpp:82).
- ``save_state``/``load_state``: carry-state checkpointing. Because every
  block's streaming state is explicit attributes (numpy arrays, scalars,
  deques) rather than hidden actor stack state, a checkpoint is a
  filtered snapshot of block __dict__ plus port queues. A checkpoint
  holds host data only: a tensor attribute is stored as numpy, a device
  cache (an attribute named ``*_dev``, rebuilt at use) is left out and
  cleared on restore, and queued device chunks are copied to the host.
- ``block_doc``/``catalog``: declarative per-block schema generated by
  introspection — the analog of the |PothosDoc comment DSL that Pothos
  parses into GUI/config metadata.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict

import numpy as np
import torch

# infrastructure attributes never checkpointed
_SKIP_ATTRS = {
    "inputs", "outputs", "name", "dtype", "out_dtype", "scalar",
    "_signals", "_probes", "_topology", "_emit_queue", "_rng", "_lib",
}


def _is_device_cache(name: str) -> bool:
    """Attributes named ``*_dev`` hold a copy of other state on a device
    (the FIR's planar taps), rebuilt at use."""
    return name.endswith("_dev")


def _host(v: Any) -> Any:
    """``v`` with every tensor in it (also inside tuples, lists and dicts)
    as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_host(x) for x in v)
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    return v


def _picklable(v: Any) -> bool:
    try:
        pickle.dumps(v)
        return True
    except Exception:
        return False


def block_state(blk) -> Dict[str, Any]:
    """Snapshot a block's runtime state (whatever is picklable and not
    infrastructure — callables, ports and device caches are rebuilt, not
    stored)."""
    out = {}
    for k, v in blk.__dict__.items():
        if k in _SKIP_ATTRS or _is_device_cache(k) or callable(v):
            continue
        v = _host(v)
        if _picklable(v):
            out[k] = pickle.loads(pickle.dumps(v))
    return out


def restore_block_state(blk, state: Dict[str, Any]) -> None:
    for k, v in state.items():
        setattr(blk, k, v)
    for k in blk.__dict__:
        if _is_device_cache(k):
            setattr(blk, k, None)


def port_state(port) -> Dict[str, Any]:
    # the queue front may live in the port's contiguous scratch (see
    # InputPort): serialize scratch live region + pending parts in order;
    # a device chunk comes to the host through its __array__
    parts = []
    if port._scratch_live():
        parts.append(np.array(
            port._scratch[port._s_start:port._s_end], copy=True))
    parts.extend(np.array(p, copy=True) for p in port._parts)
    return {
        "parts": parts,
        "elements": port._elements,
        "labels": pickle.loads(pickle.dumps(port.labels)),
        "messages": [m for m in port._messages if _picklable(m)],
        "reserve": port.reserve,
        "total_consumed": port.total_consumed,
        "total_popped": port.total_popped,
    }


def restore_port_state(port, st: Dict[str, Any]) -> None:
    port._parts = [np.array(p, copy=True) for p in st["parts"]]
    port._scratch = None
    port._s_start = port._s_end = 0
    port._elements = st["elements"]
    port.labels = list(st["labels"])
    port._messages.clear()
    port._messages.extend(st["messages"])
    port.reserve = st["reserve"]
    port.total_consumed = st["total_consumed"]
    port.total_popped = st["total_popped"]


def save_state(topology, path: str) -> None:
    """Checkpoint a committed topology: per-block carry state + queued
    port data. Blocks are matched by graph position on restore."""
    blob = []
    for blk in topology.blocks:
        blob.append({
            "type": type(blk).__name__,
            "state": block_state(blk),
            "ports": {name: port_state(p) for name, p in blk.inputs.items()},
        })
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def load_state(topology, path: str) -> None:
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if len(blob) != len(topology.blocks):
        raise ValueError(
            f"checkpoint has {len(blob)} blocks, topology has "
            f"{len(topology.blocks)}"
        )
    for blk, entry in zip(topology.blocks, blob):
        if type(blk).__name__ != entry["type"]:
            raise ValueError(
                f"checkpoint block {entry['type']} != topology block "
                f"{type(blk).__name__}"
            )
        restore_block_state(blk, entry["state"])
        for name, st in entry["ports"].items():
            if name in blk.inputs:
                restore_port_state(blk.inputs[name], st)


def query_stats(topology) -> Dict[str, Any]:
    """Per-block runtime statistics (Pothos queryJSONStats equivalent)."""
    stats = {}
    for blk in topology.blocks:
        key = blk.name
        stats[key] = {
            "type": type(blk).__name__,
            "work_calls": blk._work_calls,
            "work_time_s": round(blk._work_time, 6),
            "inputs": {
                name: {
                    "consumed": p.total_consumed,
                    "queued": p.elements(),
                    "messages_popped": p.total_popped,
                    "messages_queued": len(p._messages),
                }
                for name, p in blk.inputs.items()
            },
            "outputs": {
                name: {"produced": o.total_produced}
                for name, o in blk.outputs.items()
            },
        }
    return stats


# --------------------------------------------------------------------- #
# Docs plane (|PothosDoc analog)
# --------------------------------------------------------------------- #
_SETTER_RE = re.compile(r"^set_[a-z0-9_]+$")


def _param_value(blk, name: str):
    """Current value of a settable param via its getter, if readable."""
    for getter in (f"get_{name}", name):
        fn = getattr(blk, getter, None)
        if callable(fn):
            try:
                v = fn()
            except Exception:
                continue
            if isinstance(v, (bool, int, float, str)) or v is None:
                return v
            if isinstance(v, complex):
                return [v.real, v.imag]
            if isinstance(v, np.generic):
                return v.item()
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().tolist()
            if isinstance(v, (list, tuple, np.ndarray)):
                try:
                    return np.asarray(v).tolist()
                except Exception:
                    pass
            return repr(v)
    return None


def block_doc(blk) -> Dict[str, Any]:
    """Declarative schema for a block instance: ports, settable params
    (with defaults, option enums, units, widget/preview hints), signals,
    probes, and the class docstring. This is what a GUI or config loader
    consumes — field parity with the reference's |PothosDoc headers
    (e.g. filter/FIRDesigner.cpp:20-137: param labels, option lists,
    defaults, units, widget and preview rules).

    Per-param spec fields come from the block class's ``DOC`` attribute
    (``{"category": ..., "keywords": [...], "params": {name: spec}}``);
    the live construction-time value read through the getter fills
    ``default`` for params without an explicit spec."""
    # instance DOC wins (factory-built blocks share a generic class)
    spec = getattr(blk, "DOC", {}) or {}
    spec_params = dict(spec.get("params", {}))
    names = set(spec_params)
    for attr in sorted(dir(type(blk))):
        if _SETTER_RE.match(attr) and callable(getattr(blk, attr, None)):
            names.add(attr[4:])
    params = {}
    for name in sorted(names):
        p = dict(spec_params.get(name, {}))
        value = _param_value(blk, name)
        if value is not None:
            p.setdefault("default", value)
        setter = getattr(blk, f"set_{name}", None)
        if callable(setter) and setter.__doc__ and "desc" not in p:
            p["desc"] = setter.__doc__.strip().splitlines()[0]
        params[name] = p
    return {
        "type": type(blk).__name__,
        "doc": (type(blk).__doc__ or "").strip(),
        "category": spec.get("category", ""),
        "keywords": list(spec.get("keywords", [])),
        "inputs": list(blk.inputs),
        "outputs": list(blk.outputs),
        "params": params,
        "signals": sorted(blk._signals),
        "probes": sorted(blk._probes),
    }


# construction arguments for blocks whose factories require them
_DOC_ARGS = {
    "/comms/arithmetic": ("float32", "ADD"),
    "/comms/const_arithmetic": ("float32", "X+K", 0.0),
    "/comms/comparator": ("float32", ">"),
    "/comms/const_comparator": ("float32", ">"),
    "/comms/trigonometric": ("float32", "SIN"),
    "/comms/bitwise_unary": ("int32", "NOT"),
    "/comms/bitwise_binary": ("int32", "AND"),
    "/comms/const_bitwise_binary": ("int32", 0, "AND"),
    "/comms/bitshift": ("int32", "LEFTSHIFT", 0),
}


def catalog() -> Dict[str, Any]:
    """Schema for every registered /comms/ block."""
    from pothoscomms_tpu_torch.core.registry import BlockRegistry

    out = {}
    for path in BlockRegistry.paths():
        if not path.startswith("/comms/"):
            continue
        for args in (_DOC_ARGS.get(path, ()), (), ("float32",),
                     ("complex_float32",)):
            try:
                blk = BlockRegistry.make(path, *args)
                out[path] = block_doc(blk)
                break
            except Exception:
                continue
        else:
            out[path] = {"type": "?", "error": "needs args"}
    return out
