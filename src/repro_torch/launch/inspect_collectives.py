"""Per-op collective breakdown for one cell: the microscope, the port of the
JAX package's ``launch/inspect_collectives.py``. It traces the cell as
``launch.dryrun`` does (``meta`` tensors, a fake world of the production
mesh's size, no card) and prints the ``--top`` collectives by effective
bytes a rank: GB, the multiplier (``n_periods - 1`` for the layer stack's
second period, see ``dryrun.per_period``), kind, result shape and module
path.

  PYTHONPATH=src python -m repro_torch.launch.inspect_collectives --arch granite-3-8b --shape train_4k
"""
import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--gather-weights", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--decode-2d", action="store_true")
    ap.add_argument("--remat", default="dots")
    args = ap.parse_args()

    import math

    from repro_torch import configs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
    from repro_torch.launch.shapes import SHAPES

    cfg = configs.get(configs.canonical(args.arch))
    sh = SHAPES[args.shape]
    with D.fake_world(math.prod(PRODUCTION_SHAPES[args.multi_pod])):
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        pol, gather, seq = D.resolve_policy(cfg, sh.kind, mesh, D.policy_overrides_of(args),
                                            args.gather_weights, args.seq_shard)
        p = D.predict(cfg, sh, mesh, pol, remat=args.remat, gather_weights=gather,
                      seq_shard=seq)
    rows = []
    for c in p["records"]:
        mult = c.mult(p["trip_hints"])
        shape = f"{c.dtype}[{','.join(map(str, c.shape))}]"
        rows.append((c.result_bytes * mult, mult, c.kind, shape, c.path or "?"))
    rows.sort(key=lambda r: (-r[0], r[2], r[3], r[4]))
    total = sum(r[0] for r in rows)
    print(f"total effective per-device collective result bytes: {total/1e9:.1f} GB")
    for eff, mult, kind, shape, name in rows[: args.top]:
        print(f"{eff/1e9:9.2f}GB x{mult:3.0f} {kind:18s} {shape:40s} {name[-90:]}")


if __name__ == "__main__":
    main()
