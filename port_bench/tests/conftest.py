import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell at a size the CPU runs in a second or two (the program's plain route)
TINY = {
    "gpr-n10k-train": {"traffic": {"n": 200}},
    "gpr-n2k-train": {"traffic": {"n": 120}},
    "svgp-n100k-train": {"config": {"num_data": 2000, "num_inducing": 16}, "traffic": {"batch_size": 64}},
    "gpr-n10k-serve": {"traffic": {"n": 300, "max_points": 64, "block": 16, "pool": 200, "sample": 8}},
    "nkn-n10k-train": {"traffic": {"n": 150}},
}


def manifest():
    """BENCHMARK.json with the cells held back in pending/ added."""
    from port_bench import harness

    return harness.load_manifest(pending=True)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
