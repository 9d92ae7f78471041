"""setup.build_s (s): the program's seconds building what its steps keep:
the first-build seconds of the program's build record
(``pothoscomms_tpu_torch.parallel.profiling.build_record()``, read at the
end of the run) under every ``pc.build.*`` name but the kernels' of
``setup.kernels_s``: a chain's operators (``pc.build.fir_fft.*``), the
blocks' cores (``pc.build.core.*``), I1's tables, the link's receiver,
the block API's pair core. A build's seconds are its own, those of the
builds inside it left out. Read as ``setup.kernels_s`` reads the record;
None where the program keeps no build record."""

from pathlib import Path

from benchmark.harness import load_module


def read(m: dict):
    kernels = load_module(Path(__file__).with_name("setup.kernels_s.py"))
    return kernels.first_build_s(False)
