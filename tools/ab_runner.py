"""The runner shared by the A/B timing tools (``tools/ab_*.py``): runs a
tool's ``child(tree)`` for two checkouts of this repository, each in a
process of its own, in the order old, new, new, old, and prints the card's
name and power limit, then one line a measurement: old and new, each the
mean of its two processes (each process's value in brackets), and old /
new."""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable


def main(tool: str, child: Callable[[Path], dict], title: str, doc: str) -> int:
    """``python3 TOOL OLD_DIR NEW_DIR``; ``TOOL --child DIR`` prints the
    JSON of ``child(DIR)`` (the tool's own file runs itself as the child)."""
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(doc, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in sys.argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = {"old": [], "new": []}
    for which, tree in (("old", old), ("new", new), ("new", new), ("old", old)):
        done = subprocess.run([sys.executable, tool, "--child", str(tree)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        runs[which].append(json.loads(done.stdout.strip().splitlines()[-1]))
    print(f"{title}: old ({old}) against new ({new}), mean of two processes each", flush=True)
    for key in runs["old"][0]:
        o = [r[key] for r in runs["old"]]
        n = [r[key] for r in runs["new"]]
        mo, mn = statistics.fmean(o), statistics.fmean(n)
        print(f"{key}: old {mo:.6f} [{o[0]:.6f} {o[1]:.6f}] new {mn:.6f} "
              f"[{n[0]:.6f} {n[1]:.6f}] old/new {mo / mn:.2f}", flush=True)
    return 0
