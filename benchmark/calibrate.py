"""Readings for a cell's limits on the card (kbench/calibrate.py)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

from kbench import calibrate  # noqa: E402

if __name__ == "__main__":
    sys.exit(calibrate.main())
