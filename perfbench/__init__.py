"""The benchmark of ``alphatpu_torch`` on one NVIDIA H100: a cell is a
configuration (``configs/``) under a traffic mix (``traffic/``), as
``BENCHMARK.json`` lists them; ``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one."""
