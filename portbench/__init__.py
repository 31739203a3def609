"""The benchmark of the PyTorch and CUDA port (``llama_nuts_and_bolts_tpu_torch``).

``BENCHMARK.json`` at the root of the checkout names its cells and metrics;
``python3 -m portbench.run`` runs one cell once on the card. See
``portbench/run.py`` and ``PERF.md``.
"""
