"""Benchmark of the PyTorch/CUDA port (``repro_torch``) of MEMHD.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the GPU and prints
one JSON line. Everything a cell needs is found by name under this folder:
``workloads/<cell>.json`` names a configuration (``configs/``) and a
traffic mix (``traffic/``), whose ``kind`` is the loop that serves it
(``loops/``); the configuration names its program (``programs/``, MEMHD
where it names none) and the maker of its weights and input rows
(``inputs/``) and holds deploy options, typed by ``options/``; the mix's
route names the plain reference of the served answers, which also judges
when a row agrees (``reference/<target>.py``); a per-layer metric is the
reader ``metrics/<name>.py`` and a kernel's operations and bytes are
``counts/<kernel>.py``. Nothing here imports jax or the JAX package
``repro``; ``reference/`` imports nothing of ``repro_torch``.
"""
