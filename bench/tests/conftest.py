"""The benchmark's own tests: ``python -m pytest bench/tests`` from the root.

The CPU tests drive the harness at smoke sizes on the program's plain CPU
path; the ``cuda``-marked ones run on the card (they skip without one)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
