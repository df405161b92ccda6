"""Run one cell of the port's benchmark on the card.

From the root of a checkout::

    python3 bench_h100/run.py --workload higgs.fit.random.k50 --seed 7 \
        --seconds 20 --trace 0

prints the result as one JSON line (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and a ``breakdown``), the numbers compared last.  It exits with
another code than 0, printing no result, where there is no CUDA device
(or fewer than the cell asks for), where the cell's files or the program
are missing, or where JAX or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    here = Path(__file__).resolve().parent
    root = here.parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path[:0] = [str(root), str(root / "src")]
    from bench_h100 import harness
    harness.environment(root)
    return harness.main(sys.argv[1:] if argv is None else argv, _T0)


if __name__ == "__main__":
    sys.exit(main())
