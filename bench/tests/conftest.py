"""The benchmark's tests import ``bench`` and the port from the repository
root, whichever directory pytest starts in."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
