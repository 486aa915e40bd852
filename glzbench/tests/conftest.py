"""The benchmark's own tests (`python3 -m pytest glzbench/tests`): the
harness, its arithmetic and its reference on the CPU, at small sizes; the
tests marked `gpu` run the benchmark on a CUDA card and skip without one."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:  # the package is used from the checkout's root
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)  # the CPU tests' tensors are small: threads only contend

    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skipped when torch.cuda.is_available() is false)")
