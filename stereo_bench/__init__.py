"""The benchmark of the PyTorch and CUDA port (``ecm_torch``): one run of one
cell is ``python3 -m stereo_bench.run``; ``BENCHMARK.json`` at the root names
the cells, configurations and metrics, each a file of this package."""
