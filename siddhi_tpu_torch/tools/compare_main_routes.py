"""Times the main path through both ingress routes in one call.

    python3 siddhi_tpu_torch/tools/compare_main_routes.py [--seed 42]
                                                           [--events 2000000]

Runs ``chip_smoke.py``'s phases ``main`` (events routed in Python through
``send_many``) and ``native_main`` (the same events as CSV bytes through the
C++ loader) in the order main, native, native, main, each timed and each
held step by step against the plain version on the card, and prints each
phase's JSON line, then the card's name and power limit. Both routes get the
same 2,000,000 events from the seed. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--events", type=int, default=2_000_000)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.phase_device()
    for route in ("main", "native", "native", "main"):
        if route == "main":
            cs.phase_main(args.seed, args.events)
        else:
            cs.phase_native_main(args.seed, args.events)
    print(cs.smi(), flush=True)


if __name__ == "__main__":
    main()
