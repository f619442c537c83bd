#!/usr/bin/env python3
"""One run of one benchmark cell of ``multigrad_tpu_torch`` on the card.

    python3 perfbench/run.py --workload smf_1e9.adam --seed 7 \
        --seconds 30 --trace 0

Reads the cell from ``BENCHMARK.json`` beside this folder, makes its
catalog and guesses from ``--seed``, warms up, measures for ``--seconds``
seconds, checks the fits the window produced against the plain reference
of ``perfbench/reference/`` and prints one JSON line last on standard
output (see :mod:`perfbench.core.harness`).  Exits non-zero, with no
result, when there is no CUDA card or fewer cards than the cell asks for.
"""
import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Compiled bytecode (the port's, PyTorch's and their imports') is cached
# inside the checkout at a fixed path, so that only the first run of a
# checkout compiles it.
sys.pycache_prefix = os.path.join(ROOT, "build", "perfbench", "pycache")

from perfbench.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], root=ROOT, start=START))
