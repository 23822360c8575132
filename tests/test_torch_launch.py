"""The port's dry-run tools (``repro_torch.launch.mesh.make_production_mesh``,
``launch.dryrun``, ``launch.roofline``, ``launch.report``,
``launch.run_all_dryruns``) against the JAX package's, on the CPU, on
``meta`` tensors under the fake process-group backend.

* The H100 production mesh: dims and names at 256 and 512 fake ranks.
* Per-rank argument bytes: for all ten archs at their published widths,
  every input of the train step (parameters, AdamW moments and step, the
  batch) and of the decode step (parameters, cache, token, position,
  uniform, encoder output) under
  ``Policy.for_mesh`` and ``Policy.recommended`` on the ``(32, 8)`` mesh,
  at ranks 0 and 255, equal the sum of JAX's ``NamedSharding(AbstractMesh,
  spec).shard_shape`` bytes over JAX's ``params_struct``,
  ``batch_specs_struct`` and ``decode_inputs_struct`` leaves.
* A distributed prefill returns its cache placed by ``cache_spec_tree``,
  each rank holding only its shard, at ranks 0 and last.
* ``StepTrace`` records each kind of DTensor redistribution and a
  ``torch.distributed`` call on a mesh dim's group.
* A vocabulary-sharded embedding lookup: rows whole in ``D``, one
  all-reduce.
* Collective accounting: ``parse_collectives`` of records equals JAX's
  ``parse_collectives`` of HLO lines of the same kind, dtype, shape, group
  and while depth, with trip hints.
* A pure-DP train step of a reduced config at ``(4, 2)``: only
  all-reduces; on each mesh dim their operand bytes are the float32
  gradient bytes of every parameter, beside two scalar reductions (the
  loss and the gradient norm).
* The one-and-two-period extrapolation against a full trace at three
  periods: collective totals, FLOPs and argument bytes exactly, the temp
  peak within ``TEMP_RTOL``.
* A record of ``python -m repro_torch.launch.dryrun`` (``main``): its
  fields, and ``policy``, ``analytic``, ``model_flops_*`` and
  ``useful_flops`` equal to JAX's for the same cell; a failed cell's error
  record and exit code.
* ``report``'s three tables line for line JAX's on the same records.
* ``run_all_dryruns``' commands and skip records against JAX's, with
  ``subprocess.run`` patched.
* ``--list`` equal to JAX's ``cell_matrix``, and import hygiene, in one
  subprocess.

``repro.launch.dryrun`` and ``inspect_collectives`` are never imported here:
they set ``XLA_FLAGS`` when imported (ROADMAP C5).
"""
import dataclasses
import json
import math
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import repro.configs as JC
from repro.dist import sharding as JS
from repro.launch import analytic as JA
from repro.launch import report as JREP
from repro.launch import roofline as JR
from repro.launch import run_all_dryruns as JRUN
from repro.launch import shapes as JSH
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt as jax_init_opt
import repro_torch.configs as TC
from repro_torch.dist import sharding as TS
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as REP
from repro_torch.launch import roofline as R
from repro_torch.launch import run_all_dryruns as RUN
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from _torch_threads import one_torch_thread  # noqa: F401 (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
# the temp peak of the extrapolation against a full trace: the peak is
# reached where the last period's backward starts, so the one- and
# two-period cuts see the growth of all but a few temporaries
TEMP_RTOL = 0.05


@pytest.mark.parametrize("multi_pod,dims,names", [
    (False, (32, 8), ("data", "model")),
    (True, (2, 32, 8), ("pod", "data", "model")),
])
def test_production_mesh(multi_pod, dims, names):
    with D.fake_world(math.prod(dims), rank=math.prod(dims) - 1):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.mesh_dim_names) == names
        assert tuple(mesh.shape) == dims and mesh.device_type == "cuda"
        with pytest.raises(ValueError, match="needs a world"):
            make_production_mesh(multi_pod=not multi_pod)
    with D.fake_world(8):
        assert tuple(make_production_mesh(mesh_shape=(4, 2)).shape) == (4, 2)


def _jax_bytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    sh = jax.tree_util.tree_leaves(shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(leaves) == len(sh)
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize for x, s in zip(leaves, sh))


def _jax_state_bytes(arch: str, kind: str, shape: str, pol, am) -> int:
    """JAX's per-device bytes of the step's inputs as its dry run's
    ``in_shardings`` place them, for the full config: the parameters; AdamW
    m, v and step and the batch (train); the cache, token, position,
    uniform and encoder output (decode). Specs that do not divide are
    dropped, as both packages' ``_sanitize`` drops them."""
    cfg = JC.get(arch)
    sh = JSH.SHAPES[shape]
    jpol = JS.Policy(**dataclasses.asdict(pol))
    ms = dict(am.shape)

    def placed(x, spec):
        return _jax_bytes(x, NamedSharding(am, JS._sanitize(tuple(spec), x.shape, ms)))

    p = JSH.params_struct(cfg)
    n = _jax_bytes(p, JS.param_shardings(am, p, jpol))
    if kind == "train":
        o = jax.eval_shape(lambda t: jax_init_opt(JAdamWConfig(), t), p)
        n += _jax_bytes(o.m, JS.param_shardings(am, o.m, jpol))
        n += _jax_bytes(o.v, JS.param_shardings(am, o.v, jpol)) + o.step.dtype.itemsize
    if kind == "train":
        b = JSH.batch_specs_struct(cfg, sh)
        n += sum(placed(b[k], spec) for k, spec in JS.batch_specs(cfg, jpol, b).items())
    else:
        d = JSH.decode_inputs_struct(cfg, sh)
        n += _jax_bytes(d["cache"], JS.cache_spec_tree(cfg, d["cache"], jpol, am))
        dp = None if jpol.shard_seq else JS._dp_entry(jpol)
        n += sum(placed(d[k], (dp,) + (None,) * (d[k].ndim - 1)) for k in ("token", "pos", "xi"))
        if cfg.encoder_layers:
            sp = JS._entry(jpol.sp) if jpol.shard_seq else None
            n += placed(d["enc_out"], (dp, sp, None))
    return n


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_argument_bytes_equal_jax_shards(arch):
    cfg = TC.get(arch)
    am = AbstractMesh((32, 8), ("data", "model"))
    want = {}
    for rank in (0, 255):
        with D.fake_world(256, rank):
            mesh = make_production_mesh()
            for kind, shape in (("train", "train_4k"), ("decode", "decode_32k")):
                for pol in dict.fromkeys((TS.Policy.for_mesh(mesh, kind),
                                          TS.Policy.recommended(cfg, mesh, kind))):
                    got = D.argument_bytes(cfg, SHAPES[shape], mesh, pol)
                    key = (kind, pol)
                    if key not in want:
                        want[key] = _jax_state_bytes(arch, kind, shape, pol, am)
                    assert sum(got.values()) == want[key], (arch, rank, kind, pol, got)


def _hlo_line(c: R.Collective, i: int) -> str:
    groups = 4096 // c.group_size
    scope = "jit(f)/" + "while/body/" * c.depth + "op"
    return (f'  %c{i} = {c.dtype}[{",".join(map(str, c.shape))}]{{0}} {c.kind}(%a{i}), '
            f'replica_groups=[{groups},{c.group_size}]<=[4096], '
            f'metadata={{op_name="{scope}"}}')


def test_parse_collectives_matches_jax_parser():
    records = []
    for kind in R._COLL_KINDS:
        for dtype, shape in (("f32", (1024,)), ("bf16", (64, 4096)), ("s32", ()),
                             ("bf16", (3, 5, 7))):
            for G in (2, 8, 32, 256):
                for depth in (0, 1, 2):
                    records.append(R.Collective(kind, dtype, shape, G, ("data",), depth=depth))
    hlo = "\n".join(_hlo_line(c, i) for i, c in enumerate(records))
    for hints in ((), (23,), (4, 23)):
        assert R.parse_collectives(records, hints) == JR.parse_collectives(hlo, hints)


def test_roofline_terms_and_links():
    recs = [R.Collective("all-reduce", "f32", (1000,), 8, ("model",)),
            R.Collective("all-gather", "bf16", (4000,), 32, ("data",), depth=1)]
    roof = R.Roofline(chips=256, flops_global=2.0 * 256 * R.PEAK_FLOPS,
                      bytes_global=256 * R.HBM_BW, coll_bytes_global=0.0,
                      coll_wire_global=0.0, collectives=R.parse_collectives(recs, (3,)),
                      coll_by_link=R.link_bytes(recs, (3,)))
    assert roof.t_compute == 2.0 and roof.t_mem == 1.0
    # the all-reduce stays inside a node, the gather crosses nodes
    assert roof.t_coll == 4000 / R.NVLINK_BW + 3 * 8000 / 32 / R.IB_BW
    assert roof.dominant == "compute"
    assert set(JR.Roofline(1, 1.0, 1.0, 1.0, 1.0, {}).to_dict()) <= set(roof.to_dict())


@pytest.mark.parametrize("src,dst,kind,shape", [
    ("S0", "S1", "all-to-all", (64, 16)),
    ("S0", "R", "all-gather", (64, 64)),
    ("P", "R", "all-reduce", (64, 64)),
    ("P", "S0", "reduce-scatter", (16, 64)),
])
def test_step_trace_records_redistributions(src, dst, kind, shape):
    """Each DTensor redistribution over the mesh's data dim is one record
    of its kind with the rank's result shape, group and dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = {"S0": Shard(0), "S1": Shard(1), "R": Replicate(), "P": Partial()}
    with D.fake_world(8):
        mesh = make_production_mesh(mesh_shape=(4, 2))
        local = torch.empty((16, 64) if src == "S0" else (64, 64), device="meta")
        x = DTensor.from_local(local, mesh, [pl[src], Replicate()], run_check=False)
        with R.StepTrace(mesh) as tr:
            x.redistribute(mesh, [pl[dst], Replicate()])
    assert tr.records == [R.Collective(kind, "f32", shape, 4, ("data",))]


def test_vocab_sharded_lookup_keeps_the_rows_whole():
    """A vocabulary-sharded table's lookup gives each rank its tokens' rows
    whole in ``D`` (placed as the tokens are): one all-reduce of the local
    rows over the vocabulary's dim, as GSPMD sums the masked lookup, and
    no move of the table, so the projections after it keep their heads
    sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.local import embedding_lookup

    with D.fake_world(8):
        mesh = make_production_mesh(mesh_shape=(4, 2))
        emb = DTensor.from_local(torch.empty(50, 64, device="meta"), mesh,
                                 [Replicate(), Shard(0)], run_check=False, shape=(100, 64),
                                 stride=(64, 1))
        tok = DTensor.from_local(torch.empty(2, 16, dtype=torch.long, device="meta"), mesh,
                                 [Shard(0), Replicate()], run_check=False, shape=(8, 16),
                                 stride=(16, 1))
        with R.StepTrace(mesh) as tr:
            x = embedding_lookup(emb, tok)
    assert tuple(x.placements) == (Shard(0), Replicate()) and x.shape == (8, 16, 64)
    assert tr.records == [R.Collective("all-reduce", "f32", (2, 16, 64), 2, ("model",))]


def test_step_trace_records_c10d_calls():
    """A ``torch.distributed`` call (the sequence-sharded decode's merge
    issues them) is one record on its mesh dim's group."""
    import torch.distributed as dist

    with D.fake_world(8):
        mesh = make_production_mesh(mesh_shape=(4, 2))
        with R.StepTrace(mesh) as tr:
            dist.all_reduce(torch.empty(5, 3, device="meta"), group=mesh.get_group("model"))
    assert tr.records == [R.Collective("all-reduce", "f32", (15,), 2, ("model",))]


def _pure_dp_trace():
    cfg = TC.get_reduced("qwen3_4b")
    with D.fake_world(8):
        mesh = make_production_mesh(mesh_shape=(4, 2))
        pol = TS.Policy(dp=("data", "model"), tp=None, fsdp=())
        st = D.build_state(cfg, ShapeSpec("t", 64, 8, "train"), mesh, pol)
        tr, _, _ = D.trace_step(cfg, st, mesh, pol, remat="none")
        return tr.records, sum(p.numel() * 4 for p in st.model.parameters())


def test_pure_dp_step_all_reduces_every_gradient():
    records, grad_bytes = _pure_dp_trace()
    assert {c.kind for c in records} == {"all-reduce"}
    for dim in ("data", "model"):
        on = [c for c in records if c.dims == (dim,)]
        scalars = [c for c in on if c.shape == ()]
        assert len(scalars) == 2          # the loss and the global gradient norm
        colls = R.parse_collectives([c for c in on if c.shape != ()])
        assert colls["all-reduce"]["operand_bytes"] == grad_bytes
    assert all(c.dims in (("data",), ("model",)) for c in records)


def _full_trace(cfg, sh, mesh, pol, remat):
    st = D.build_state(cfg, sh, mesh, pol)
    tr, _, _ = D.trace_step(cfg, st, mesh, pol, remat, max_seq=sh.seq_len)
    return tr, D.input_bytes(st)


@pytest.mark.parametrize("arch,kind", [("qwen3_4b", "train"), ("kimi_k2_1t_a32b", "train"),
                                       ("whisper_small", "decode")])
def test_period_extrapolation_equals_full_trace(arch, kind):
    cfg = D.cut(TC.get_reduced(arch), 3)
    sh = ShapeSpec("t", 64, 8, kind)
    with D.fake_world(8):
        mesh = make_production_mesh(mesh_shape=(4, 2))
        pol = TS.Policy.for_mesh(mesh, kind)
        p = D.predict(cfg, sh, mesh, pol, remat="dots")
        tr, inputs = _full_trace(cfg, sh, mesh, pol, "dots")
    assert p["trip_hints"] == (2,)
    got = R.parse_collectives(p["records"], p["trip_hints"])
    want = R.parse_collectives(tr.records)
    for kind in R._COLL_KINDS:   # ``count`` counts records, not their multiples
        assert {k: v for k, v in got[kind].items() if k != "count"} == \
            {k: v for k, v in want[kind].items() if k != "count"}, kind
        assert sum(c.mult(p["trip_hints"]) for c in p["records"] if c.kind == kind) == \
            want[kind]["count"], kind
    assert R.link_bytes(p["records"], p["trip_hints"]) == R.link_bytes(tr.records)
    assert p["traced_flops"] == tr.flops
    assert p["argument_bytes_by_input"] == inputs
    assert p["temp_size_in_bytes"] == pytest.approx(tr.peak_bytes, rel=TEMP_RTOL)


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "xlstm_1_3b"])
def test_prefill_places_its_cache(arch):
    """A distributed prefill (on ``meta``, at ``(4, 2)``; rank 0 with the
    batch sharded, rank 7 with the sequence sharded) returns every cache
    leaf as a DTensor placed by ``cache_spec_tree``, whose local bytes are
    JAX's shard bytes of the same leaf."""
    import torch.fx.experimental._config as fx_config
    from torch.distributed.tensor import DTensor

    from repro_torch.train.step import make_prefill_step

    cfg = TC.get_reduced(arch)
    sh = ShapeSpec("t", 16, 8, "prefill")
    am = AbstractMesh((4, 2), ("data", "model"))
    jc = JSH.cache_struct(JC.get_reduced(arch), sh.global_batch, sh.seq_len)
    for rank, pol in ((0, TS.Policy(dp=("data",), tp="model", fsdp=(), sp="model")),
                      (7, TS.Policy(dp=(), tp=("data", "model"), fsdp=(), shard_seq=True,
                                    sp="model"))):
        with D.fake_world(8, rank):
            mesh = make_production_mesh(mesh_shape=(4, 2))
            st = D.build_state(cfg, sh, mesh, pol)
            with fx_config.patch(meta_nonzero_assume_all_nonzero=True), \
                    R.StepTrace(mesh, known=st.inputs, model=st.model):
                _, cache, _ = make_prefill_step(cfg, sh.seq_len)(st.model, *st.args)
            specs = TS.cache_spec_tree(cfg, cache, pol, mesh)
        jspecs = JS.cache_spec_tree(cfg, jc, JS.Policy(**dataclasses.asdict(pol)), am)
        for b, c in cache.items():
            for n, t in c.items():
                assert isinstance(t, DTensor), (arch, b, n)
                assert list(t.placements) == TS.placements(specs[b][n], mesh)
                assert D.local_bytes([t]) == _jax_bytes(jc[b][n], jspecs[b][n]), \
                    (arch, rank, pol, b, n)


def test_dryrun_record_matches_jax(tmp_path, monkeypatch, capsys):
    out = tmp_path / "rec.json"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen1.5-0.5b", "--shape",
                                      "decode_32k", "--auto-policy", "--out", str(out)])
    D.main()
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 32, "model": 8}
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert {"lower_s", "compile_s", "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes", "roofline", "useful_over_hlo",
            "roofline_fraction", "hints", "params_dtype"} <= set(rec)
    assert "generated_code_size_in_bytes" not in rec
    assert rec["argument_size_in_bytes"] == sum(rec["argument_bytes_by_input"].values())
    assert rec["alias_size_in_bytes"] == rec["argument_bytes_by_input"]["cache"]

    jcfg, sh = JC.get("qwen1_5_0_5b"), JSH.SHAPES["decode_32k"]
    jpol = JS.Policy.recommended(jcfg, AbstractMesh((32, 8), ("data", "model")), "decode")
    assert rec["policy"] == json.loads(json.dumps(dataclasses.asdict(jpol)))
    assert rec["hints"] == {"gather_weights": False, "seq_shard": jpol.shard_seq}
    af = JA.step_flops(jcfg, "decode", sh.seq_len, sh.global_batch, "dots")
    ab = JA.step_bytes(jcfg, "decode", sh.seq_len, sh.global_batch, opt_bytes_per_param=12)
    assert rec["analytic"] == {**af, **ab}
    mf = JR.model_flops(jcfg, sh.global_batch)
    assert {k: rec[k] for k in mf} == mf
    assert rec["useful_flops"] == mf["model_flops_6ND"] / 3.0
    rf = rec["roofline"]
    assert rf["flops_global"] == af["step_flops"] and rf["bytes_global"] == ab["step_bytes"]
    for k in ("t_compute_s", "t_mem_s", "t_coll_s", "t_coll_wire_s", "hlo_flops_global"):
        assert math.isfinite(rf[k]) and rf[k] > 0, k
    assert rf["hlo_bytes_global"] is None
    assert rf["dominant"] in ("compute", "memory", "collective")
    capsys.readouterr()

    def boom(*a, **k):
        raise RuntimeError("no fit")

    monkeypatch.setattr(D, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        D.main()
    assert e.value.code == 1
    err = json.loads(out.read_text())
    assert err["status"] == "error" and err["error"] == "RuntimeError: no fit"
    assert "Traceback" in err["traceback"]


def _records() -> list[dict]:
    roof = {"t_compute_s": 0.0123, "t_mem_s": 2.5e-4, "t_coll_s": 1.7, "t_coll_wire_s": 3.1,
            "dominant": "collective", "flops_global": 4.2e15, "hlo_flops_global": 4.6e15}
    ok = {"arch": "qwen1_5_0_5b", "shape": "train_4k", "status": "ok", "chips": 256,
          "mesh": {"data": 32, "model": 8}, "lower_s": 0.93, "compile_s": 3.08,
          "argument_size_in_bytes": 31619076, "temp_size_in_bytes": 15112036872,
          "roofline": roof, "useful_flops": 2.9e15, "roofline_fraction": 0.1125}
    return [
        ok,
        {**ok, "shape": "decode_32k", "mesh": {"pod": 2, "data": 32, "model": 8},
         "roofline": {**roof, "t_coll_s": 0.0, "dominant": "memory"}},
        {**ok, "arch": "xlstm_1_3b", "mesh": "pod1", "roofline": {**roof, "t_coll_s": 9e-7}},
        {"arch": "granite_3_8b", "shape": "long_500k", "mesh": "pod1", "status": "skipped",
         "reason": "skip: pure full-attention at 512k"},
        {"arch": "kimi_k2_1t_a32b", "shape": "train_4k", "multi_pod": True, "status": "error",
         "error": "timeout"},
    ]


def test_report_tables_match_jax(tmp_path, monkeypatch, capsys):
    recs = _records()
    opt = [{**recs[0], "roofline": {**recs[0]["roofline"], "t_coll_s": 0.2}}]
    for mesh in ("pod1", "pod2"):
        assert REP.dryrun_table(recs, mesh) == JREP.dryrun_table(recs, mesh)
    assert REP.roofline_table(recs) == JREP.roofline_table(recs)
    assert REP.optimized_table(recs, opt) == JREP.optimized_table(recs, opt)
    assert REP.fmt_bytes(31619076) == JREP.fmt_bytes(31619076) == "30.2MB"
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    monkeypatch.setattr(sys, "argv", ["report", "--dir", str(tmp_path),
                                      "--opt-dir", str(tmp_path / "none")])
    REP.main()
    text = capsys.readouterr().out
    assert "### Dry-run, single pod (32x8 = 256 GPUs)" in text
    assert "### Dry-run, multi-pod (2x32x8 = 512 GPUs)" in text


def _runner(mod, outdir: pathlib.Path, monkeypatch) -> list:
    """``mod.main()`` over both meshes with ``subprocess.run`` recording
    its commands: every cell writes an ok record, the first times out."""
    cmds = []

    def run(cmd, capture_output, text, timeout):
        cmds.append(cmd)
        if len(cmds) == 1:
            raise subprocess.TimeoutExpired(cmd, timeout)
        out = cmd[cmd.index("--out") + 1]
        pathlib.Path(out).write_text(json.dumps({"status": "ok"}))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(sys, "argv", ["run_all", "--outdir", str(outdir)])
    mod.main()
    return cmds


def test_run_all_dryruns_commands_and_skips(tmp_path, monkeypatch, capsys):
    mine = _runner(RUN, tmp_path / "port", monkeypatch)
    theirs = _runner(JRUN, tmp_path / "jax", monkeypatch)
    n = 2 * sum(st == "run" for _, _, st in JSH.cell_matrix())
    assert len(mine) == n == 64
    assert [[a.replace(str(tmp_path / "port"), "OUT") for a in c] for c in mine] == \
        [[a.replace(str(tmp_path / "jax"), "OUT").replace("repro.launch", "repro_torch.launch")
          for a in c] for c in theirs]
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(files) == 80
    for name in files:
        a = json.loads((tmp_path / "port" / name).read_text())
        assert a == json.loads((tmp_path / "jax" / name).read_text()), name
    assert f"{n - 1}/{n} cells OK; 1 failed" in capsys.readouterr().out


def test_list_and_import_hygiene():
    """Importing the dry-run tools pulls no model, dist layer or DTensor;
    ``--list`` prints JAX's ``cell_matrix`` (taken in this process, so the
    subprocess imports no JAX)."""
    script = (
        "import sys\n"
        "import repro_torch.launch.dryrun as D\n"
        "import repro_torch.launch.report, repro_torch.launch.run_all_dryruns\n"
        "import repro_torch.launch.inspect_collectives\n"
        "bad = [m for m in sys.modules if m.startswith(('repro_torch.models',\n"
        "       'repro_torch.dist', 'torch.distributed.tensor', 'jax', 'repro.'))]\n"
        "assert not bad, bad\n"
        "sys.argv = ['dryrun', '--list']\n"
        "D.main()\n"
    )
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       env={"PYTHONPATH": str(_SRC), "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout == "".join(f"{a:28s} {s:12s} {st}\n" for a, s, st in JSH.cell_matrix())
