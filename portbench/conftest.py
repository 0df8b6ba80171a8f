"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker, and a copy of the benchmark at a size the CPU
holds."""

import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one"
    )


@pytest.fixture
def card():
    """Skip a test marked ``card`` where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run these tests on a machine with one")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ at a CPU size, every cell
    file entered."""
    from portbench.testing import register_all_cells, shrink

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(tmp_path)
    register_all_cells(tmp_path)
    return tmp_path
