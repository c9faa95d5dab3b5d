"""Eager generate, one checkout against another on the same card.

    python3 compare_generate.py [--runs 7] [--turns 3] TREE [TREE ...]

Each TREE is the root of a checkout (for example a `git archive` of the
parent unpacked under build/). In each of --turns rounds, every tree in
turn gets a process of its own that builds its kernels, makes GPT-2
small from the seed and calls that tree's chip_smoke.generate_phase
--runs times (eager bf16 generate at GEN_SHAPE, one timed call each).
Prints one JSON line per process and, last, each tree's median over all
its calls. One card; the host's spread between single calls is wide, so
compare medians, not calls.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
_build.build()
model = cs._gpt_model(pt, "cuda")
ms = [cs.generate_phase(torch, pt, fa, model)["ms_per_token"]
      for _ in range(int(sys.argv[1]))]
print("RESULT " + json.dumps({"card": cs.nvidia_smi(), "ms_per_token": ms}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    calls = {t: [] for t in args.trees}
    for turn in range(args.turns):
        for tree in args.trees:
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, str(args.runs)],
                cwd=os.path.abspath(tree), capture_output=True, text=True,
                timeout=600)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if out.returncode or not lines:
                sys.stderr.write(out.stdout[-3000:] + out.stderr[-3000:])
                sys.exit(f"{tree}: exit {out.returncode}, no result")
            row = json.loads(lines[-1][len("RESULT "):])
            calls[tree] += row["ms_per_token"]
            print(json.dumps(dict(tree=tree, turn=turn, **row,
                                  median=statistics.median(
                                      row["ms_per_token"]))), flush=True)
    print(json.dumps({"median_ms_per_token": {
        t: statistics.median(v) for t, v in calls.items()}}))


if __name__ == "__main__":
    main()
