"""Run every (arch x shape x mesh) dry-run cell in an isolated subprocess
(``python -m repro_torch.launch.dryrun``: each cell's fake world and the
memory of its trace are its own), the port of the JAX package's
``launch/run_all_dryruns.py``.

  PYTHONPATH=src python -m repro_torch.launch.run_all_dryruns [--meshes pod1]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="pod1,pod2")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()

    from repro_torch.launch.shapes import cell_matrix

    Path(args.outdir).mkdir(parents=True, exist_ok=True)
    results = []
    for mesh in args.meshes.split(","):
        multi = mesh == "pod2"
        for arch, shape, status in cell_matrix():
            out = Path(args.outdir) / f"{arch}__{shape}__{mesh}.json"
            if status != "run":
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "skipped", "reason": status,
                }, indent=2))
                print(f"SKIP  {arch:28s} {shape:12s} {mesh}: {status}")
                continue
            if args.skip_existing and out.exists():
                rec = json.loads(out.read_text())
                if rec.get("status") == "ok":
                    print(f"HAVE  {arch:28s} {shape:12s} {mesh}")
                    continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--out", str(out),
            ] + (["--multi-pod"] if multi else [])
            t0 = time.time()
            try:
                proc = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=args.timeout
                )
                ok = proc.returncode == 0
            except subprocess.TimeoutExpired:
                ok = False
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "error", "error": "timeout",
                }, indent=2))
            dt = time.time() - t0
            print(f"{'OK  ' if ok else 'FAIL'}  {arch:28s} {shape:12s} {mesh} "
                  f"({dt:.0f}s)", flush=True)
            if not ok and out.exists():
                rec = json.loads(out.read_text())
                print("      ", rec.get("error", "?")[:200])
            results.append((arch, shape, mesh, ok))
    bad = [r for r in results if not r[3]]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells OK; {len(bad)} failed")
    for b in bad:
        print("  FAILED:", b)


if __name__ == "__main__":
    main()
