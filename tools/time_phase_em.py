"""Check and time the phasing EM kernel of one checkout on one CUDA card:
chip_smoke.py phase 9's windows (chip_smoke.check_em), one JSON line.

    python3 tools/time_phase_em.py [--root DIR] [--out FILE]

The modules, the kernel source and chip_smoke.py are those of the
checkout at ``--root`` (default: this one), put first on sys.path and
built there, so that two checkouts can be compared in turns in one call
(baseline, change, change, baseline), each a process of its own.  Each
window is held bit-equal to the plain version first, then timed (CUDA
events: the kernel queued behind a sleep kernel, host included, and the
torch form warm); the line holds every window's row with the card's name
and power limit; ``--out`` appends it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    import torch
    if not torch.cuda.is_available():
        print("time_phase_em: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke

    rows = chip_smoke.check_em(chip_smoke.card_int32_rate())[0]
    line = json.dumps({"root": os.path.relpath(root, HERE),
                       "card": chip_smoke.card_line(), "rows": rows})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
