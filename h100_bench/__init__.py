"""The benchmark of ``sgnn_tpu_torch`` on an NVIDIA H100.

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (whose ``runner`` names ``runners/<runner>.py``),
``workloads/<cell>.json`` (the limits of its correctness check) and
``metrics/<metric>.py`` (one reader per per-layer metric). Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the port.
"""
