"""The benchmark of glz_tpu_torch, the PyTorch and CUDA port: one cell of
BENCHMARK.json a run (`python3 -m glzbench --help`)."""
