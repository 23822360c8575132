"""Multi-pod dry run: every (arch x shape x mesh) cell traced on ``meta``
tensors under the fake process-group backend, the port of the JAX
package's ``launch/dryrun.py``. No card is needed.

For each cell this makes a fake world of the production mesh's size
(``launch.mesh.make_production_mesh``: 256 or 512 H100s), builds the cell's
state on ``meta`` (parameters from ``launch.shapes.params_struct`` placed
by the sharding policy, AdamW moments, the batch, or the decode cache and
inputs), runs the real step once on it under :class:`~repro_torch.launch.
roofline.StepTrace` (the rank's collectives, FLOPs and peak allocation),
derives the three roofline terms and writes a JSON record with the JAX
package's keys where they have a meaning. A sharding mismatch or a cell
whose state does not fit is a real finding in the distribution config:
that is the point of the exercise.

Trace cost: the step is traced with the layer stack cut to one period and
to two (the embedding, head and loss count once); the difference (the
collectives, FLOPs, argument and output bytes and the temp peak's growth)
is multiplied by ``n_periods - 1``, as the JAX package's ``trip_hints``
multiply the body of its layer scan. Every period holds the same
parameters, so the bytes extrapolate exactly. This process plays rank 0.

Record fields against the JAX package's: ``lower_s`` is the time to build
and place the two states, ``compile_s`` the two traces';
``argument_size_in_bytes`` the rank's local bytes of every step input,
placed as the JAX package's ``in_shardings`` place them;
``alias_size_in_bytes`` the outputs updated in place
(every step of the port updates its state in place, whatever ``donate``
says); ``temp_size_in_bytes`` the peak of what the step allocates beyond
its inputs. ``generated_code_size_in_bytes`` has no counterpart.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --list
"""
import argparse
import collections
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

# Import hygiene: everything heavyweight (torch.distributed, the models, the
# dist layer, the step builders) is imported inside function bodies.
# Importing this module must stay cheap and dependency-free so `--list`, the
# report tooling and the import tests cannot be taken down by a broken
# subsystem.


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``fake`` default process group of ``world_size`` ranks (no
    communication: collectives return their inputs' shapes), in which this
    process plays ``rank``; destroyed after. DTensor's caches keep the
    meshes of an earlier world in the process, so an op they planned on an
    equal mesh may name that world's dead groups: a cell runs in a process
    of its own (``run_all_dryruns``)."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 (registers "fake")

    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cut(cfg, k: int):
    """``cfg`` with ``k`` periods (and ``k`` encoder layers: the encoder,
    Whisper's, is as deep as the decoder's periods)."""
    if cfg.encoder_layers and cfg.encoder_layers != cfg.n_periods:
        raise ValueError(f"{cfg.name}: {cfg.encoder_layers} encoder layers against "
                         f"{cfg.n_periods} periods do not cut together")
    return dataclasses.replace(cfg, n_layers=k * len(cfg.block_pattern),
                               encoder_layers=k if cfg.encoder_layers else 0)


def _placed(t, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding as S

    pl = S.placements(S._sanitize(spec, tuple(t.shape), S.mesh_shape(mesh)), mesh)
    return distribute_tensor(t, mesh, pl)


def _placed_batch(cfg, sh, mesh, pol) -> dict:
    from repro_torch.dist import sharding as S
    from repro_torch.launch.shapes import batch_specs_struct

    b = batch_specs_struct(cfg, sh)
    return {k: _placed(t, mesh, spec) for (k, t), spec in
            zip(b.items(), S.batch_specs(cfg, pol, list(b)).values())}


def build_state(cfg, sh, mesh, pol, opt_dtype: str = "float32", params_dtype: str = "float32"):
    """The step's inputs on ``meta``, placed by ``pol`` on ``mesh`` as the
    JAX package's ``in_shardings`` place them (the batch by
    ``batch_specs``; the decode cache by ``cache_spec_tree``, its token,
    position and uniform over ``dp``): a namespace with ``kind``, ``model``
    (the distributed LM), ``args`` (the step's positional arguments after
    the model) and ``inputs`` (every input tensor)."""
    import torch

    from repro_torch.dist import sharding as S
    from repro_torch.launch.shapes import decode_inputs_struct, params_struct

    model = params_struct(cfg)
    if params_dtype == "bfloat16":
        # pure-bf16 parameter variant (m/v stay in opt_dtype), every float32
        # leaf as the JAX package's
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = torch.empty_like(p, dtype=torch.bfloat16)
    if sh.kind == "train":
        model.requires_grad_(True)
    S.distribute_params(model, mesh, pol)
    st = SimpleNamespace(kind=sh.kind, model=model, oc=None)
    if sh.kind == "train":
        from repro_torch.train import AdamWConfig, init_opt

        st.oc = AdamWConfig(opt_dtype=opt_dtype)
        opt = init_opt(st.oc, model)
        st.args = [opt, _placed_batch(cfg, sh, mesh, pol)]
        st.groups = {"opt": opt, "batch": st.args[1]}
    elif sh.kind == "prefill":
        st.args = [_placed_batch(cfg, sh, mesh, pol)]
        st.groups = {"batch": st.args[0]}
    else:   # decode / long
        d = decode_inputs_struct(cfg, sh)
        dp = None if pol.shard_seq else S._dp_entry(pol)
        st.args = [S.distribute_cache(cfg, d["cache"], mesh, pol)] + [
            _placed(d[k], mesh, (dp,) + (None,) * (d[k].dim() - 1))
            for k in ("token", "pos", "xi")]
        if cfg.encoder_layers:
            sp = S._entry(pol.sp) if pol.shard_seq else None
            st.args.append(_placed(d["enc_out"], mesh, (dp, sp, None)))
        st.groups = {"cache": st.args[0], "inputs": st.args[1:]}
    st.groups = {"params": model, **st.groups}
    st.inputs = _tensors(list(st.groups.values()))
    return st


def input_bytes(st) -> dict:
    """The rank's bytes of each group of the step's inputs (``params``;
    ``opt`` and ``batch`` for train, ``batch`` for prefill, ``cache`` and
    ``inputs`` (token, position, uniform, encoder output) for decode)."""
    return {k: local_bytes(_tensors(v)) for k, v in st.groups.items()}


def _grow(a, b, n_periods: int):
    """``a + (b - a) * (n_periods - 1)``: a quantity of the one-period cut
    ``a`` and of the two-period cut ``b`` at ``n_periods`` (dicts by key)."""
    if isinstance(a, dict):
        return {k: _grow(a[k], b[k], n_periods) for k in a}
    return a + (b - a) * (n_periods - 1)


def argument_bytes(cfg, sh, mesh, pol, opt_dtype: str = "float32",
                   params_dtype: str = "float32") -> dict:
    """:func:`input_bytes` of the cell's state at ``cfg.n_periods``, from
    the one- and two-period states (no step is traced)."""
    runs = [input_bytes(build_state(cut(cfg, k), sh, mesh, pol, opt_dtype, params_dtype))
            for k in ((1, 2) if cfg.n_periods > 1 else (1,))]
    return _grow(runs[0], runs[-1], cfg.n_periods)


def _tensors(x) -> list:
    """Every tensor in ``x`` (a module's parameters, pytrees of tensors)."""
    import torch
    from torch.utils._pytree import tree_leaves

    out = []
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tensors) -> int:
    """The rank's bytes of ``tensors``: a DTensor's local shard, each storage
    once."""
    seen, n = set(), 0
    for t in tensors:
        t = _local(t)
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def trace_step(cfg, st, mesh, pol, remat: str = "dots", microbatches: int = 1,
               gather_weights: bool = False, seq_shard: bool = False, max_seq: int = 0):
    """Run the cell's step once on ``st`` under :class:`StepTrace`; returns
    ``(trace, output bytes, of which aliased to the inputs)``. MoE dispatch
    indexes by a mask, whose size on ``meta`` is taken as every element
    (all pairs kept)."""
    import torch.fx.experimental._config as fx_config

    from repro_torch.dist.hints import Hints, sharding_hints
    from repro_torch.launch.roofline import StepTrace
    from repro_torch.train.step import make_prefill_step, make_serve_step, make_train_step

    if st.kind == "train":
        step = make_train_step(cfg, st.oc, remat=remat, microbatches=microbatches)
    elif st.kind == "prefill":
        step = make_prefill_step(cfg, max_seq=max_seq)
    else:
        step = make_serve_step(cfg)
    hint_ctx = (sharding_hints(Hints(pol, gather_weights=gather_weights, seq_shard=seq_shard))
                if (gather_weights or seq_shard) else contextlib.nullcontext())
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), hint_ctx, \
            StepTrace(mesh, known=st.inputs, model=st.model) as tr:
        out = step(st.model, *st.args)
    outs = _tensors(out)
    mine = {_local(t).untyped_storage()._cdata for t in st.inputs}
    aliased = [t for t in outs if _local(t).untyped_storage()._cdata in mine]
    return tr, local_bytes(outs), local_bytes(aliased)


def _key(c) -> tuple:
    return (c.kind, c.dtype, c.shape, c.group_size, c.dims)


def _later_period(path: str) -> bool:
    return ".layers.1" in path or ".encoder.1" in path


def per_period(one: list, two: list) -> list:
    """The records of the two-period trace with the second period's marked
    depth 1 (so ``trip_hints=(n_periods - 1,)`` gives ``one + (two - one) *
    (n_periods - 1)`` in every total): each record is matched to one of the
    one-period trace's with the same kind, dtype, shape and group, those of
    the second period's modules last; a record with no match is the
    second period's. A one-period record left unmatched counts once and
    ``-(n_periods - 1)`` times (weights +1 and -1)."""
    left = collections.Counter(_key(c) for c in one)
    out = list(two)
    for i in sorted(range(len(two)), key=lambda i: _later_period(two[i].path)):
        k = _key(two[i])
        if left[k] > 0:
            left[k] -= 1
        else:
            out[i] = dataclasses.replace(two[i], depth=1)
    for c in one:
        if left[_key(c)] > 0:
            left[_key(c)] -= 1
            out += [c, dataclasses.replace(c, depth=1, weight=-1)]
    return out


def predict(cfg, sh, mesh, pol, opt_dtype: str = "float32", remat: str = "dots",
            microbatches: int = 1, gather_weights: bool = False, seq_shard: bool = False,
            params_dtype: str = "float32") -> dict:
    """Build and trace the cell at one period and at two, and extrapolate to
    ``cfg.n_periods`` (module docstring). Returns the record's numbers:
    ``lower_s``, ``compile_s``, the four ``*_size_in_bytes`` and
    ``argument_bytes_by_input`` (:func:`input_bytes`), ``records`` (the
    collectives, with ``trip_hints``) and ``traced_flops`` (per rank)."""
    P = cfg.n_periods
    runs = []
    for k in ((1, 2) if P > 1 else (1,)):
        c = cut(cfg, k)
        t0 = time.time()
        st = build_state(c, sh, mesh, pol, opt_dtype, params_dtype)
        t1 = time.time()
        tr, out_b, alias_b = trace_step(c, st, mesh, pol, remat, microbatches,
                                        gather_weights, seq_shard, max_seq=sh.seq_len)
        runs.append(SimpleNamespace(
            lower_s=t1 - t0, compile_s=time.time() - t1, records=tr.records,
            n={"flops": tr.flops, "temp": tr.peak_bytes, "out": out_b, "alias": alias_b,
               "inputs": input_bytes(st)}))
        del st, tr
    n = _grow(runs[0].n, runs[-1].n, P)
    return {
        "lower_s": sum(r.lower_s for r in runs),
        "compile_s": sum(r.compile_s for r in runs),
        "argument_size_in_bytes": sum(n["inputs"].values()),
        "argument_bytes_by_input": n["inputs"],
        "output_size_in_bytes": n["out"],
        "alias_size_in_bytes": n["alias"],
        "temp_size_in_bytes": max(n["temp"], 0),
        "traced_flops": n["flops"],
        "records": per_period(runs[0].records, runs[-1].records) if P > 1 else runs[0].records,
        "trip_hints": (P - 1,) if P > 1 else (),
    }


def resolve_policy(cfg, kind: str, mesh, policy_overrides: dict | None,
                   gather_weights: bool, seq_shard: bool):
    """The JAX package's policy choice: ``Policy.recommended`` with
    ``{"auto": True}`` (gather-on-use for train, the preset's sequence
    sharding), else ``Policy.for_mesh``; other overrides replace fields.
    Returns ``(policy, gather_weights, seq_shard)``."""
    from repro_torch.dist.sharding import Policy

    if policy_overrides and policy_overrides.get("auto"):
        pol = Policy.recommended(cfg, mesh, kind)
        # measured: gather-on-use pays for train only (the JAX package's
        # finding, refuted there for prefill at 70B and small-model decode)
        gather_weights = kind == "train"
        seq_shard = pol.shard_seq
        policy_overrides = {k: v for k, v in policy_overrides.items() if k != "auto"}
    else:
        pol = Policy.for_mesh(mesh, kind)
    if policy_overrides:
        pol = dataclasses.replace(pol, **policy_overrides)
    return pol, gather_weights, seq_shard


def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool = False,
    opt_dtype: str = "float32",
    remat: str = "dots",
    microbatches: int = 1,
    policy_overrides: dict | None = None,
    donate: bool = True,
    gather_weights: bool = False,
    seq_shard: bool = False,
    params_dtype: str = "float32",
) -> dict:
    """One cell's record (module docstring) in a fake world of the
    production mesh's size. ``donate`` is accepted for the JAX package's signature: the port's steps update
    their state in place either way."""
    from repro_torch import configs
    from repro_torch.launch import analytic as A
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
    from repro_torch.launch.shapes import SHAPES

    cfg = configs.get(arch)
    sh = SHAPES[shape]
    dims = PRODUCTION_SHAPES[multi_pod]
    with fake_world(math.prod(dims)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        pol, gather_weights, seq_shard = resolve_policy(
            cfg, sh.kind, mesh, policy_overrides, gather_weights, seq_shard)
        rec: dict = {
            "arch": arch,
            "shape": shape,
            "mesh": dict(zip(mesh.mesh_dim_names, dims)),
            "chips": chips,
            "kind": sh.kind,
            "policy": dataclasses.asdict(pol),
            "opt_dtype": opt_dtype,
            "remat": remat,
            "microbatches": microbatches,
            "hints": {"gather_weights": gather_weights, "seq_shard": seq_shard},
            "params_dtype": params_dtype,
        }
        p = predict(cfg, sh, mesh, pol, opt_dtype, remat, microbatches, gather_weights,
                    seq_shard, params_dtype)
        for k in ("lower_s", "compile_s", "argument_size_in_bytes", "argument_bytes_by_input",
                  "output_size_in_bytes", "temp_size_in_bytes", "alias_size_in_bytes"):
            rec[k] = p[k]
        print("memory (bytes a rank): " + ", ".join(
            f"{k}={rec[k]}" for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                      "alias_size_in_bytes", "temp_size_in_bytes")))
        print(f"traced: flops={p['traced_flops']:.3e} a rank, "
              f"{len(p['records'])} collective records")

        af = A.step_flops(cfg, sh.kind, sh.seq_len, sh.global_batch, remat)
        ab = A.step_bytes(cfg, sh.kind, sh.seq_len, sh.global_batch,
                          opt_bytes_per_param=12 if opt_dtype == "float32" else 8)
        roof = R.analyze(p["records"], p["traced_flops"], mesh, chips,
                         trip_hints=p["trip_hints"], analytic_flops=af["step_flops"],
                         analytic_bytes=ab["step_bytes"])
    rec["roofline"] = roof.to_dict()
    rec["analytic"] = {**af, **ab}
    tokens = sh.global_batch * (sh.seq_len if sh.kind in ("train", "prefill") else 1)
    mf = R.model_flops(cfg, tokens)
    rec.update(mf)
    useful = mf["model_flops_6NactiveD" if cfg.n_experts else "model_flops_6ND"]
    if sh.kind != "train":
        useful /= 3.0  # 6ND assumes fwd+bwd; fwd-only is 2ND
    rec["useful_flops"] = useful
    rec["useful_over_hlo"] = useful / max(roof.flops_global, 1.0)
    bound = max(roof.t_compute, roof.t_mem, roof.t_coll, roof.t_coll_wire)
    rec["roofline_fraction"] = (
        useful / (R.PEAK_FLOPS * chips * bound) if bound > 0 else 0.0
    )
    return rec


def policy_overrides_of(args) -> dict:
    """The CLI's policy flags as ``run_cell``'s ``policy_overrides``."""
    overrides = {}
    if args.no_fsdp:
        overrides["fsdp"] = ()
    if getattr(args, "dp_only", False):
        axes = ("pod", "data", "model") if args.multi_pod else ("data", "model")
        overrides.update(dp=axes, fsdp=axes, tp=None)
    if args.decode_2d:
        overrides.update(dp=(), fsdp=(), tp=("data", "model"), shard_seq=True)
    if getattr(args, "auto_policy", False):
        overrides["auto"] = True
    return overrides


def main() -> None:
    from repro_torch import configs
    from repro_torch.launch.shapes import SHAPES, cell_matrix

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true", help="hillclimb knob")
    ap.add_argument("--gather-weights", action="store_true", help="ZeRO-3 gather-on-use")
    ap.add_argument("--dp-only", action="store_true",
                    help="fold the model axis into DP/FSDP (no TP)")
    ap.add_argument("--params-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--decode-2d", action="store_true",
                    help="decode: 2D weight-stationary TP over (data,model), "
                         "seq-sharded KV, replicated per-token activations")
    ap.add_argument("--auto-policy", action="store_true",
                    help="use Policy.recommended (the hillclimbed presets)")
    ap.add_argument("--seq-shard", action="store_true", help="Megatron-SP residual")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        for arch, shape, status in cell_matrix():
            print(f"{arch:28s} {shape:12s} {status}")
        return

    try:
        rec = run_cell(
            configs.canonical(args.arch),
            args.shape,
            multi_pod=args.multi_pod,
            opt_dtype=args.opt_dtype,
            remat=args.remat,
            microbatches=args.microbatches,
            policy_overrides=policy_overrides_of(args) or None,
            gather_weights=args.gather_weights,
            seq_shard=args.seq_shard,
            params_dtype=args.params_dtype,
        )
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure for the report
        rec = {
            "arch": args.arch,
            "shape": args.shape,
            "multi_pod": args.multi_pod,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(rec["traceback"])
    out = args.out or (
        f"experiments/dryrun_torch/{configs.canonical(args.arch)}__{args.shape}"
        f"__{'pod2' if args.multi_pod else 'pod1'}.json"
    )
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps(rec, indent=2, default=str))
    print(f"wrote {out}: status={rec['status']}")
    if rec["status"] != "ok":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
