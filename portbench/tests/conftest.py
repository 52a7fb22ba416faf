"""Tests of the benchmark itself, on the CPU at tiny sizes (run from the
repository root: ``python -m pytest portbench/tests -q``). Tests that need
the card are marked ``requires_cuda`` and skip here."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
