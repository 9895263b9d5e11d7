import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent), str(HERE.parents[1])):
    if p not in sys.path:
        sys.path.insert(0, p)
