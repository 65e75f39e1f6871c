"""Run one cell with a fault planted under the harness, to read the
control and the faults on the card at the cell's own size:

    python3 portbench/control.py --fault answer_altered --workload CELL \\
        --seed N --seconds S --trace 0

The faults are in ``faults.py``.  The benchmark's own runs never call this.
"""
from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import faults, run  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    return run.main(argv, tamper=faults.FAULTS[name])


if __name__ == "__main__":
    sys.exit(main())
