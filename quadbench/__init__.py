"""The benchmark of ``repro_torch``: bracketed inverse forms, a bracketed
logdet and greedy MAP on the paper's dense-RBF and sparse-Laplacian
regimes. ``run.py`` runs one cell once; ``BENCHMARK.json`` at the root of
the repository names the cells, configurations and metrics, and the
files under ``configs/``, ``workloads/`` and ``metrics/`` hold each one.
"""
