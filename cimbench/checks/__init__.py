"""The benchmark's own tests, on the CPU (the ``cuda``-marked ones on the
card): ``python -m pytest cimbench/checks`` from the root."""
