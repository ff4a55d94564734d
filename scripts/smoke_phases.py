"""Time some of ``chip_smoke.py``'s phases of one checkout, alone, on the
card: the kernels built (phase 2), then each named phase function in
order, its wall seconds printed.  Two checkouts' phases are compared by
running this for each in one call (parent, change, parent), since a card
set below 700 W runs slower under load; the card's name and power limit
are printed first.

    python scripts/smoke_phases.py --root PATH [--phases training,lm,lm_train,gnn]

``--phases`` names ``chip_smoke.phase_<name>`` functions that take the
kernel modules (phases 16-19 by default).
"""

import argparse
import importlib
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(prog="python scripts/smoke_phases.py")
    ap.add_argument("--root", required=True, help="the checkout whose phases run")
    ap.add_argument("--phases", default="training,lm,lm_train,gnn")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    smoke = importlib.import_module("chip_smoke")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    smoke.phase_build()
    from repro_torch.kernels import bucket_dedup, hash_mix, nested_join, scan_join

    mods = {"hash_mix": hash_mix, "bucket_dedup": bucket_dedup, "nested_join": nested_join,
            "scan_join": scan_join}
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        getattr(smoke, f"phase_{name}")(mods)
        print(f"[smoke_phases] {root} phase_{name} {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
