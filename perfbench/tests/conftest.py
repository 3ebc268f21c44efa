"""The benchmark's own tests: on the CPU at tiny sizes, and, marked
``cuda``, on the card (they skip where there is none)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
