"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", "_cache")


def _environment() -> None:
    """Caches at fixed places inside the checkout; no library loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path[0] != ROOT:
        sys.path.insert(0, ROOT)


if __name__ == "__main__":
    _environment()
    from portbench.harness.runner import main

    sys.exit(main(sys.argv[1:], T_START))
