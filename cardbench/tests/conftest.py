"""The harness's CPU tests: ``python -m pytest cardbench/tests`` from the
root of the repository (the repository's own run, ``testpaths = tests``,
does not collect them)."""
import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import smoke  # noqa: E402,F401  (puts cardbench/ and src/ on the path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips "
                            "without one")


@pytest.fixture(autouse=True)
def few_threads():
    """The smoke runs are small: more threads than cores only contend.
    The count is put back after each test, so that tests of other
    directories in the same worker keep their own order of sums."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, os.cpu_count() or 1))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="session")
def bench():
    from benchlib.spec import Benchmark
    return Benchmark(smoke.ROOT)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
