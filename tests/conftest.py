import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); on the card "
        "run `python -m pytest -q -m cuda <file>` on files that import no "
        "JAX")
