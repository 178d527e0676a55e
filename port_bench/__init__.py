"""The benchmark of maus_tpu_torch on one H100: ``python3 -m port_bench``.

See ``port_bench/run.py`` for a run and ``BENCHMARK.json`` at the root of
the repository for the cells. Nothing here imports JAX or the JAX package.
"""
