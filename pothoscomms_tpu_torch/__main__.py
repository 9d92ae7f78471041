"""Command-line entry point of the port — the equivalent of ``PothosUtil``'s
block discovery (SURVEY.md §3.5):

    python -m pothoscomms_tpu_torch catalog            # JSON block/param schema
    python -m pothoscomms_tpu_torch list               # registered block paths
    python -m pothoscomms_tpu_torch doc /comms/fft     # one block's schema
    python -m pothoscomms_tpu_torch doc /comms/fir_filter float32 REAL

``doc`` reads its constructor arguments as Python literals where they
parse as one (``1024``, ``False``) and as strings otherwise. An unknown
command, or a block that cannot be built, exits with code 2.
"""

from __future__ import annotations

import ast
import json
import sys


def _load_registry():
    import pothoscomms_tpu_torch.blocks  # noqa: F401 — registers everything
    from pothoscomms_tpu_torch.core.registry import BlockRegistry

    return BlockRegistry


def cmd_list(_args):
    reg = _load_registry()
    for path in sorted(reg.paths()):
        print(path)
    return 0


def cmd_catalog(_args):
    from pothoscomms_tpu_torch.core.introspect import catalog

    _load_registry()
    print(json.dumps(catalog(), indent=2, default=str))
    return 0


def _coerce(a: str):
    try:
        return ast.literal_eval(a)
    except (ValueError, SyntaxError):
        return a


def cmd_doc(args):
    if not args:
        print("usage: python -m pothoscomms_tpu_torch doc </comms/path> "
              "[ctor args]", file=sys.stderr)
        return 2
    from pothoscomms_tpu_torch.core.introspect import block_doc

    reg = _load_registry()
    try:
        blk = reg.make(args[0], *[_coerce(a) for a in args[1:]])
    except (KeyError, ValueError, TypeError) as exc:
        print(f"doc: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(block_doc(blk), indent=2, default=str))
    return 0


COMMANDS = {
    "list": cmd_list,
    "catalog": cmd_catalog,
    "doc": cmd_doc,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if not argv or argv[0] not in COMMANDS:
        print(__doc__, file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
