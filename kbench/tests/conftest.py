"""The benchmark's own tests, on the CPU at sizes a test run holds:

    python -m pytest kbench/tests -q

``cuda``-marked tests run a cell at a small size on the card and skip
without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
