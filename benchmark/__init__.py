"""The benchmark of the PyTorch/CUDA port, ``petibm_tpu_torch``.

``python3 benchmark/run.py --help`` lists its cells.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it."""
