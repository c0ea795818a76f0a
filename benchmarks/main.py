"""Benchmark CLI (C16) — thin checkout wrapper over ``jax_spmv.cli``.

The demo itself lives in the installable package (``jax_spmv/cli.py``,
console script ``jax-spmv-benchmark``); this file keeps the documented
``python benchmarks/main.py`` invocation working from a source checkout.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jax_spmv.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
