"""Sharded forest demo on the PyTorch/CUDA port: cell-partitioned *windowed*
build + the owner-routed all-to-all bulk drain over the ranks of a
``torch.distributed`` process group, bit-identical to the single-device
path; plus occupancy rebalancing for a spiky distribution and an in-place
delta update that rebuilds only the dirty shards' windows. The twin of
``examples/sharded_forest.py``, whose 8 fake JAX devices become ranks here.

  PYTHONPATH=src python examples/torch_sharded_forest.py                          # nccl, one rank a card
  PYTHONPATH=src python examples/torch_sharded_forest.py --device cpu --world 4  # gloo

The ranks are processes (``torch.multiprocessing.spawn``; one rank runs in
this process) that meet over a ``FileStore`` in a temporary directory. On
the card the group is nccl, one rank a card; on the CPU it is gloo. Every
rank runs every step and checks every equality; rank 0 prints.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import build_forest, forest_to_numpy, normalize_weights, sample_forest
from repro_torch.core.cdf import SCAN_CHUNKS
from repro_torch.dist import forest as DF


def walkthrough(rank: int, world: int, device: torch.device) -> None:
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = DF.default_mesh("data", device=device)
    group = mesh.get_group()
    n, m = 1 << 14, 1 << 14
    weights = normalize_weights(np.arange(1, n + 1, dtype=np.float64) ** 20)
    say(f"devices: {world} x {device.type} (mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.shape)}, {dist.get_backend(group)})")

    # --- build: single-device reference vs cell-partitioned sharded ---------
    f1 = build_forest(weights, m, device=device)
    sharded = DF.build_forest_sharded(weights, m, group=group, device=device)
    D = sharded.n_shards
    bounds = DF.cell_partition(m, D)
    say(f"sharded over {D} shards, cell ranges "
        + ", ".join(f"[{bounds[i]},{bounds[i+1]})" for i in range(min(D, 4)))
        + (", ..." if D > 4 else ""))

    gathered = DF.gather_forest(sharded)
    a, b = forest_to_numpy(f1), forest_to_numpy(gathered)
    for key in ("cdf", "table", "left", "right", "cell_first", "fallback"):
        assert np.array_equal(a[key], b[key]), key
    say("build: sharded gather is BIT-IDENTICAL to single-device build_forest")
    say(f"windowed: each of the {D} shards built a {sharded.capacity}-leaf "
        f"window of the {n}-leaf world "
        f"(owned leaves per shard: {sharded.window_count.tolist()})")

    # --- sample: owner-routed bulk drain vs Algorithm 2 ---------------------
    # Each rank takes ~B/D lanes of the batch and buckets them by owning
    # shard (static bucket capacity planned on the host), one all-to-all
    # delivers every draw to its owner, the owner descends ONLY its owned
    # draws over its local leaf window, and a second all-to-all routes the
    # interval ids back. The drain plan shows the structural win: descent
    # lanes per shard ~B/D, not the full batch every shard pays on the
    # all-reduce oracle (routed=False, kept as the reference).
    xi = np.random.default_rng(0).random(1 << 16).astype(np.float32)
    plan = DF.drain_plan(sharded, xi, group=group, device=device)
    say(f"drain plan: {plan['batch']} draws -> {plan['lanes_per_shard']} lanes "
        f"per shard, bucket capacity {plan['bucket_capacity']} -> each shard "
        f"descends {plan['descent_lanes']} lanes (oracle descends all "
        f"{plan['padded_batch']})")
    ids_sharded = DF.sample_sharded(sharded, xi, group=group, device=device).cpu().numpy()
    ids_oracle = DF.sample_sharded(sharded, xi, group=group, routed=False,
                                   device=device).cpu().numpy()
    ids_single = sample_forest(f1, xi, device=device).cpu().numpy()
    assert np.array_equal(ids_sharded, ids_single)
    assert np.array_equal(ids_oracle, ids_single)
    say(f"sampling: {xi.shape[0]} owner-routed draws == all-reduce oracle "
        "== single-device draws")

    counts = np.bincount(ids_sharded, minlength=n)
    expected = weights * len(xi)
    chi2 = float(np.sum((counts - expected) ** 2 / np.maximum(expected, 1e-9)))
    say(f"chi-square vs target weights: {chi2:.0f} (dof {n - 1})")

    # --- occupancy rebalancing ----------------------------------------------
    # The i^20 distribution piles nearly all its probability mass, and hence
    # nearly all its CDF intervals, into the last guide cells. An equal-width
    # cell partition puts almost every leaf on the last shard; occupancy
    # rebalancing keeps the partition contiguous and cell-aligned but sizes
    # the cell ranges by leaf count, shrinking the window capacity every
    # shard must budget for.
    rebalanced = DF.build_forest_sharded(weights, m, group=group, rebalance=True,
                                         device=device)
    b = forest_to_numpy(DF.gather_forest(rebalanced))
    for key in ("cdf", "table", "left", "right", "cell_first", "fallback"):
        assert np.array_equal(a[key], b[key]), key
    rbounds = rebalanced.cell_bounds.tolist()
    say(f"rebalance: window capacity {sharded.capacity} -> "
        f"{rebalanced.capacity}, cell ranges "
        + ", ".join(f"[{rbounds[i]},{rbounds[i+1]})" for i in range(D))
        + " - still bit-identical")
    # The two partitions balance *different* loads. Guide cells are
    # equal-probability strata of xi, so the equal-width partition already
    # balances the routed drain's owner loads (~B/D draws each); it is the
    # *build* that piles onto one shard. Occupancy rebalance flips that.
    rplan = DF.drain_plan(rebalanced, xi, group=group, device=device)
    assert np.array_equal(
        DF.sample_sharded(rebalanced, xi, group=group, device=device).cpu().numpy(),
        ids_single)
    say(f"drain plan equal vs rebalanced partition: bucket "
        f"{plan['bucket_capacity']} -> {rplan['bucket_capacity']}, descent "
        f"lanes per shard {plan['descent_lanes']} -> {rplan['descent_lanes']} "
        f"- build balance and drain balance trade off on spiky weights")

    # --- delta update -------------------------------------------------------
    # Re-target a handful of weights in place: the CDF is rescanned on the
    # fixed SCAN_CHUNKS grid, the changed-bits mask comes from the
    # forest_delta_update kernel, and only shards whose leaf windows
    # actually moved rebuild their (window-sized) trees. Integer-valued
    # weights keep the scan exact, so the sparse perturbation really leaves
    # most shards clean.
    iw = np.random.default_rng(1).integers(2, 50, n).astype(np.float32)
    base = DF.build_forest_sharded(iw, m, group=group, device=device)
    iw2 = iw.copy()
    iw2[n // 2] += 1.0
    iw2[n // 2 + 1] -= 1.0   # total preserved -> one CDF entry moves
    updated, stats = DF.update_forest_sharded(base, iw2, group=group, with_stats=True,
                                              device=device)
    scratch = DF.build_forest_sharded(
        iw2, m, group=group, partition=base.cell_bounds.cpu().numpy(),
        capacity=updated.capacity, device=device)  # hysteresis may keep the larger window
    for key in updated._fields:
        assert torch.equal(getattr(updated, key), getattr(scratch, key)), key
    say(f"delta update: {stats['rebuilt_windows']}/{D} shard windows rebuilt "
        f"({stats['dirty_chunks']}/{SCAN_CHUNKS} scan chunks dirty) - "
        f"ShardedForest bit-identical to a from-scratch rebuild")
    _, nstats = DF.update_forest_sharded(base, iw, group=group, with_stats=True, device=device)
    assert not nstats["rebuilt"]
    say("delta update: no-op delta skips the tree rebuild entirely")

    # --- rank-count sweep ---------------------------------------------------
    # Every rank makes every subgroup (new_group is collective); the ranks of
    # a subgroup build and drain on it, the others wait at the barrier.
    say("build/sample timing sweep (ranks share this host's cores; the row "
        "structure, not the absolute ms, is the point here):")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for D in (c for c in (1, 2, 4, 8) if c <= world):
        sub = dist.new_group(list(range(D)))
        if rank < D:
            sf = DF.build_forest_sharded(weights, m, group=sub, device=device)
            sync()                                  # first build: warm
            t0 = time.perf_counter()
            for _ in range(3):
                sf = DF.build_forest_sharded(weights, m, group=sub, device=device)
                sync()
            t_build = (time.perf_counter() - t0) / 3
            times = {}
            for routed in (True, False):
                DF.sample_sharded(sf, xi, group=sub, routed=routed, device=device)
                sync()
                t0 = time.perf_counter()
                for _ in range(3):
                    DF.sample_sharded(sf, xi, group=sub, routed=routed, device=device)
                    sync()
                times[routed] = (time.perf_counter() - t0) / 3
            say(f"  D={D}: build {t_build * 1e3:8.1f} ms   "
                f"sample routed {times[True] * 1e3:8.1f} ms / "
                f"oracle {times[False] * 1e3:8.1f} ms / {xi.shape[0]} draws")
        dist.barrier()
        dist.destroy_process_group(sub)


def worker(rank: int, world: int, device: str, store_path: str) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    torch.set_num_threads(1)  # the ranks share this host's cores
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        walkthrough(rank, world, dev)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: one a card on cuda, 8 on the CPU)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    cards = torch.cuda.device_count() if dev.type == "cuda" else None
    world = args.world or cards or 8
    if cards is not None and world > cards:
        raise ValueError(f"nccl takes one rank a card: {world} ranks, {cards} cards")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if world == 1:
            worker(0, 1, args.device, store)
        else:
            mp.spawn(worker, args=(world, args.device, store), nprocs=world)


if __name__ == "__main__":
    main()
