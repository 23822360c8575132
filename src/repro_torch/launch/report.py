"""The dry-run and roofline tables from the JSON records of
``launch.dryrun`` (the port's, or the JAX package's: the lines are the
same), a copy of the JAX package's ``launch/report.py`` with the H100
meshes in its headings.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_s(s: float) -> str:
    if s == 0:
        return "0"
    if s < 1e-3:
        return f"{s * 1e6:.0f}us"
    if s < 1:
        return f"{s * 1e3:.1f}ms"
    return f"{s:.2f}s"


def load(dirpath: str) -> list[dict]:
    recs = []
    for f in sorted(Path(dirpath).glob("*.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def rec_mesh(r: dict) -> str:
    m = r.get("mesh")
    if isinstance(m, str):
        return m
    if isinstance(m, dict):
        return "pod2" if len(m) == 3 else "pod1"
    return "pod1"


def dryrun_table(recs: list[dict], mesh: str) -> list[str]:
    out = [
        "| arch | shape | status | lower | compile | args/dev | temp/dev | HLO flops (global) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if rec_mesh(r) == mesh:
            if r["status"] == "skipped":
                out.append(
                    f"| {r['arch']} | {r['shape']} | SKIP ({r['reason'].split(':')[-1].strip()}) | | | | | |"
                )
                continue
            if r["status"] != "ok":
                out.append(f"| {r['arch']} | {r['shape']} | **{r['status']}** | | | | | |")
                continue
            chips = r["chips"]
            args_dev = r.get("argument_size_in_bytes", 0)
            temp_dev = r.get("temp_size_in_bytes", 0)
            out.append(
                f"| {r['arch']} | {r['shape']} | ok | {r['lower_s']:.1f}s "
                f"| {r['compile_s']:.1f}s | {fmt_bytes(args_dev)} "
                f"| {fmt_bytes(temp_dev)} "
                f"| {r['roofline'].get('hlo_flops_global', r['roofline']['flops_global']):.2e} |"
            )
    return out


def roofline_table(recs: list[dict]) -> list[str]:
    out = [
        "| arch | shape | t_compute | t_mem | t_coll (raw) | t_coll (wire) | dominant | 6ND/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok" or rec_mesh(r) != "pod1":
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['t_compute_s'])} "
            f"| {fmt_s(rf['t_mem_s'])} | {fmt_s(rf['t_coll_s'])} "
            f"| {fmt_s(rf['t_coll_wire_s'])} | {rf['dominant']} "
            f"| {r.get('useful_flops', 0) / max(rf['flops_global'], 1):.2f} "
            f"| {r.get('roofline_fraction', 0) * 100:.1f}% |"
        )
    return out


def optimized_table(base: list[dict], opt: list[dict]) -> list[str]:
    bidx = {(r.get("arch"), r.get("shape")): r for r in base
            if r.get("status") == "ok" and rec_mesh(r) == "pod1"}
    out = [
        "| arch | shape | t_coll base -> opt | x | dominant after | frac base -> opt |",
        "|---|---|---|---|---|---|",
    ]
    for r in opt:
        if r.get("status") != "ok":
            continue
        b = bidx.get((r["arch"], r["shape"]))
        if not b:
            continue
        tb = b["roofline"]["t_coll_s"]
        to = r["roofline"]["t_coll_s"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(tb)} -> {fmt_s(to)} "
            f"| {tb / max(to, 1e-12):.1f}x | {r['roofline']['dominant']} "
            f"| {b.get('roofline_fraction', 0) * 100:.1f}% -> "
            f"{r.get('roofline_fraction', 0) * 100:.1f}% |"
        )
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--opt-dir", default="experiments/dryrun_torch_opt")
    args = ap.parse_args()
    recs = load(args.dir)
    print("### Dry-run, single pod (32x8 = 256 GPUs)\n")
    print("\n".join(dryrun_table(recs, "pod1")))
    print("\n### Dry-run, multi-pod (2x32x8 = 512 GPUs)\n")
    print("\n".join(dryrun_table(recs, "pod2")))
    print("\n### Roofline (single pod)\n")
    print("\n".join(roofline_table(recs)))
    if Path(args.opt_dir).exists():
        print("\n### Optimized policy (auto-policy + gather hints) vs baseline\n")
        print("\n".join(optimized_table(recs, load(args.opt_dir))))


if __name__ == "__main__":
    main()
