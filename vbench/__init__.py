"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of V-BOINC.

One command runs one cell once, from the root of a checkout:

    python3 -m vbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell of ``BENCHMARK.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``);
the cell's own limits are in ``workloads/<cell>.json``, and each per-layer
metric is read by ``metrics/<metric>.py``.  Nothing here imports JAX or the
JAX package; the plain reference (``reference/``) imports nothing of the
port either.
"""
