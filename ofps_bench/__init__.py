"""The benchmark of ``ofps_torch`` on an NVIDIA H100.

``python -m ofps_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line; see
``ofps_bench/README.md``.  Nothing here imports ``jax`` or ``ofps_tpu``, and
``ofps_bench.reference`` imports nothing of ``ofps_torch``.
"""
