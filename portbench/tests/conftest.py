"""The benchmark's own tests: `python -m pytest portbench/tests` from the
root of the repository, on the CPU. Tests marked `cuda` skip without a card."""

import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
