"""The benchmark of the PyTorch/CUDA port (``skypilot_tpu_torch``).

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell is made of is found by name: its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<mix>.json``, read by the generator of its ``kind``), its own
parameters (``workloads/<cell>.json``) and one reader per metric
(``metrics/<name>.py``). ``README.md`` says how to add each.

Nothing here imports ``jax`` or the JAX package; the port is imported
only by the processes that run it, through its public constructors.
"""
