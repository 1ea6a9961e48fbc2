"""The benchmark of the PyTorch and CUDA port (``freesound_classification_tpu_torch``).

One run of one cell:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, the end-to-end
and per-layer metrics and their bounds; everything that belongs to one
configuration, traffic mix, cell, per-layer metric or kernel sits in a file
of its own under this directory, found by the name ``BENCHMARK.json`` gives
(``README.md``). Nothing here imports JAX or the JAX package, and the plain
reference (``reference/``) imports nothing of the port.
"""
