"""setup.kernels_s (s): the program's seconds in its kernels' set-up: the
first-build seconds of the program's build record
(``pothoscomms_tpu_torch.parallel.profiling.build_record()``, read at the
end of the run) under ``pc.build.library.*`` (a library's hash, nvcc
where it ran, its ``ctypes`` load) and ``pc.build.first_launch.*`` (a
kernel wrapper's first call on the card: its constants and the card's
load of the kernel's module). A first build happens once a key in a
process, so where the window builds nothing these are set-up's seconds.

A reader imports nothing of the port: the record is read from the
program's ``profiling`` module as the run loaded it (``sys.modules``).
None where the run loaded no such module or it keeps no build record."""

import sys

KERNELS = ("pc.build.library.", "pc.build.first_launch.")
PROFILING = "pothoscomms_tpu_torch.parallel.profiling"


def first_build_s(kernels: bool):
    """The first-build seconds of the build record's names under
    :data:`KERNELS` (``kernels``) or of every other ``pc.build.*`` name;
    None where the program has no build record."""
    record = getattr(sys.modules.get(PROFILING), "build_record", None)
    if record is None:
        return None
    return sum(r["first_s"] for n, r in record()["builds"].items()
               if n.startswith("pc.build.")
               and n.startswith(KERNELS) == kernels)


def read(m: dict):
    return first_build_s(True)
