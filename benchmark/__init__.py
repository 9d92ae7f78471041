"""The benchmark of pothoscomms_tpu_torch on one NVIDIA H100: one run of
one cell a process (``python3 benchmark/run.py --workload <cell> ...``).

Everything that belongs to one configuration, traffic mix, driver or
metric sits in files of its own, found by the names in
``BENCHMARK.json``: ``configs/<config>.json`` and ``.py``,
``reference/<config>.py``, ``counts/<config>.py``, ``traffic/<traffic>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.
"""
