"""The port's measuring programs, each a module run as
``python -m maus_tpu_torch.benchmarks.<name>`` (``headline`` also as
``python -m maus_tpu_torch bench``), each the counterpart of one of the JAX
package's programs, with its keys:

- ``headline``: the north-star solve of ``bench.py`` (4096², κ = 1e6,
  complex64, 16 candidates, tol 1e-8), with the scorecard embedded;
- ``scorecard``: ``benchmarks/mfu.py``'s per-kernel rows, measured live;
- ``throughput``: ``benchmarks/throughput.py``'s shifted solves a second;
- ``spectral_large``: ``benchmarks/spectral_large_probe.py``'s eig and SVD
  rows through the public API;
- ``eig_paths``: ``benchmarks/eig_paths.py``, the direct eig step against
  the Jacobi–Davidson one;
- ``solve16k``: ``benchmarks/solve16k_probe.py``, the headline at 16384²;
- ``age``: ``benchmarks/age_probe.py``'s KAIROSAGE and scenario rows.

Each prints one JSON line a row and names its device in every line. Each
``main(argv, device=None)`` runs on the card unless ``device="cpu"``; with
neither a card nor that request it raises.
"""
