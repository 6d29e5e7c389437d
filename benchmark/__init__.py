"""The benchmark of phlash_tpu_torch: see benchmark/run.py and BENCHMARK.json."""
