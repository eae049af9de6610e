"""The benchmark's CPU tests: ``python -m pytest portbench/tests``. Tests
marked ``cuda`` decide inside the test whether a card is present and skip
without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
