"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``).  Everything a cell needs is found by
name: its configuration in ``configs/``, its traffic mix in ``traffic/``,
the limits of its correctness check in ``workloads/``, the driver of the
mix's kind in ``kinds/``, each per-layer metric's reader in ``metrics/``
and each model family's plain reference in ``reference/``.
"""
