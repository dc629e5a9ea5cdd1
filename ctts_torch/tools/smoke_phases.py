"""Run some of ``chip_smoke.py``'s phases from several checkouts in turn,
on one card, to compare two versions of a kernel in one run.

    python3 ctts_torch/tools/smoke_phases.py --phases gather mas \\
        --timeout 600 OLD NEW NEW OLD

Each checkout is a directory holding ``chip_smoke.py`` and ``ctts_torch/``
(an unpacked ``git archive`` of a commit, say). Each run is a process of
its own started in that directory, so it imports that checkout's package
and builds that checkout's kernels (under its own ``build/``); a checkout
named twice reuses its build. A run that outlives ``--timeout`` seconds is
killed, so a kernel that hangs costs one run. Each run's output is printed
under a header naming the checkout and the run. Exits non-zero if any run
failed.
"""

import argparse
import os
import subprocess
import sys

# TF32 off, as chip_smoke.main sets it
RUN = ("import sys, torch, chip_smoke as c\n"
       "torch.backends.cuda.matmul.allow_tf32 = False\n"
       "torch.backends.cudnn.allow_tf32 = False\n"
       "s = c.Smoke()\n"
       "for p in sys.argv[1:]:\n"
       "    s.phase(p, getattr(s, p))\n"
       "sys.exit(1 if s.failures else 0)\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", required=True,
                    help="methods of chip_smoke.Smoke, e.g. gather mas")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("checkouts", nargs="+")
    args = ap.parse_args(argv)
    failed = 0
    for i, root in enumerate(args.checkouts):
        root = os.path.abspath(root)
        print(f"=== run {i + 1}/{len(args.checkouts)}: {root}", flush=True)
        try:
            res = subprocess.run([sys.executable, "-c", RUN, *args.phases],
                                 cwd=root, timeout=args.timeout)
            rc = res.returncode
        except subprocess.TimeoutExpired:
            rc = "killed at the time limit"
        print(f"=== run {i + 1} exit {rc}", flush=True)
        failed += rc != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
