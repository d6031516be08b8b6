"""The benchmark of ``dlrm_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/harness.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell is made of is a file found by its name:
``configs/<config>.json`` (the model's sizes), ``traffic/<mix>.json`` (the
batches and the job that drives them), ``cells/<cell>.json`` (the limits of
the correctness check), ``entries/<entry>.py`` (how a mix drives the
program), and ``metrics/<metric>.py`` (one reader a metric).  The plain
reference that decides ``correct`` lives in ``reference/`` and imports
nothing of the program.
"""
