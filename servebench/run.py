"""Run one cell of the port's benchmark once (see servebench/core/cli.py).

    python3 servebench/run.py --workload llava.longdoc --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout: the port is imported from ``src/``, and
every cache the run builds stays inside the checkout, at fixed paths.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "servebench", sub)

from servebench.core.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
