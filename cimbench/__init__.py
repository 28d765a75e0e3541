"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the command; ``BENCHMARK.json`` at the root names the cells
(a configuration under ``configs/`` and a traffic mix under ``traffic/``,
which names its kind of runner under ``runners/``), the metrics (a reader
each under ``metrics/``) and the bounds.  The reference under
``reference/`` imports nothing of the program.
"""
