"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
checkout's root (CPU); `-m gpu` runs those that need a card, on one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
