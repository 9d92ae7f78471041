"""Command-line entry point of the port — the equivalent of ``PothosUtil``'s
block discovery (SURVEY.md §3.5):

    python -m pothoscomms_tpu_torch catalog            # JSON block/param schema
    python -m pothoscomms_tpu_torch list               # registered block paths
    python -m pothoscomms_tpu_torch doc /comms/fft     # one block's schema
    python -m pothoscomms_tpu_torch doc /comms/fir_filter float32 REAL
    python -m pothoscomms_tpu_torch self-test          # the port's tests
    python -m pothoscomms_tpu_torch self-test tests/test_torch_mesh.py -x
    python -m pothoscomms_tpu_torch bench [--device DEV] [name ...]

``self-test`` runs the port's tests from a source checkout with pytest:
``tests/test_torch_*.py`` where JAX is installed (they hold the port
against the JAX package), else ``tests/test_torch_cuda.py`` alone with
``--noconftest`` (the card's tests, which import no JAX). Arguments that
name existing files replace that set; the others pass through to pytest.
``bench`` runs the BASELINE bench suite of a source checkout
(``benches_torch/bench_suite.py``: fir_1ch, fft_64ch_1024, resampler_3_2,
fm_chain_256ch, digital_link, digital_modem_bulk, digital_link_sharded;
all by default) on the card, or on ``--device``, one JSON line a
workload; it exits 1 when a workload raises or fails its gate, and 2 for
an unknown name.
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


def cmd_self_test(args):
    import importlib.util
    import os
    import subprocess
    from pathlib import Path

    tests = Path(__file__).resolve().parent.parent / "tests"
    if not tests.is_dir():
        print("self-test requires the source checkout (tests/ not packaged)",
              file=sys.stderr)
        return 2
    files = [str(Path(a).resolve()) for a in args if Path(a).is_file()]
    rest = [a for a in args if not Path(a).is_file()]
    if importlib.util.find_spec("jax") is None:
        files = files or [str(tests / "test_torch_cuda.py")]
        rest = ["--noconftest", *rest]
    else:
        files = files or sorted(str(p) for p in tests.glob("test_torch_*.py"))
    return subprocess.call(
        [sys.executable, "-m", "pytest", *files, "-q", *rest],
        cwd=str(tests.parent), env=dict(os.environ),
    )


def cmd_bench(args):
    import importlib.util
    from pathlib import Path

    suite = Path(__file__).resolve().parent.parent / "benches_torch" \
        / "bench_suite.py"
    if not suite.exists():
        print("bench requires the source checkout (benches_torch/ not "
              "packaged)", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("bench_suite", suite)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(args)


COMMANDS = {
    "list": cmd_list,
    "catalog": cmd_catalog,
    "doc": cmd_doc,
    "self-test": cmd_self_test,
    "bench": cmd_bench,
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
