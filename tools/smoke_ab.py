#!/usr/bin/env python3
"""``chip_smoke.py`` of several checkouts in turns, each line time-stamped.

    python3 tools/smoke_ab.py [--out LOGDIR] DIR [DIR ...]

Runs ``python3 -u chip_smoke.py`` from each directory in turn and writes
its output to ``LOGDIR/ab_<i>_<dir name>.log`` (default ``_checkout/ab``,
relative to the current directory), every line prefixed with the seconds
since that run started, so that two trees' phases can be compared line by
line on one machine. To time an earlier commit beside the working tree:
unpack it (``git archive``) into ``_checkout/parent`` and run ``python3
tools/smoke_ab.py _checkout/parent .``. Prints one ``[ab]`` line a run and
exits with the largest exit code.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(dirs, out):
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    rcs = []
    for i, d in enumerate(dirs):
        tag = f"{i}_{os.path.basename(os.path.abspath(d))}"
        t0 = time.perf_counter()
        with open(os.path.join(out, f"ab_{tag}.log"), "w") as log:
            p = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=d,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for line in p.stdout:
                log.write(f"{time.perf_counter() - t0:8.1f} {line}")
                log.flush()
            rcs.append(p.wait())
        print(f"[ab] {d}: rc {rcs[-1]} in {time.perf_counter() - t0:.1f} s", flush=True)
    return max(rcs)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="_checkout/ab", help="directory of the logs")
    parser.add_argument("dirs", nargs="+", help="checkouts to run chip_smoke.py from")
    args = parser.parse_args()
    sys.exit(main(args.dirs, args.out))
