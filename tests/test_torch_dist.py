"""The port's LM ``dist`` layer (``repro_torch.dist.sharding``, ``hints``,
``local``, ``compression``, ``pipeline``, ``launch.mesh``,
``ckpt.restore(shardings=)``) against the JAX package's, on the CPU, in
this process.

* Specs, every arch of ``configs.ARCHS`` at its reduced config, meshes
  ``{data: 4, model: 2}`` and ``{pod: 2, data: 16, model: 16}``, policies
  ``for_mesh`` (train and decode), every ``recommended`` preset (the full
  configs' policies too, which reach the large-model presets) and a 2-D TP
  policy: the port's JAX-form spec of every parameter equals
  ``repro.dist.sharding.param_specs`` on ``launch.shapes.params_struct`` at
  the same leaf path, every JAX leaf covered; ``batch_specs`` and
  ``cache_spec_tree`` equal JAX's; the policies equal JAX's.
* Placements: tensors distributed on a fake-backend mesh of 8 ranks (meta
  tensors) have local shapes equal to JAX's shard shapes carried into the
  port's layout; ``distribute_params`` places every arch there (MoE, Mamba,
  xLSTM, encoder and embedding frontend included).
* MoE: ``group_plan`` on routing ids gathered from two batch halves gives
  ``dispatch_plan``'s slots on the whole batch.
* Hints: the same object outside the context.
* On a gloo group of one rank: the hinted distributed forward bit for bit
  the unhinted plain forward, and within ``1e-5`` of JAX's forward (the
  tolerance of ``tests/test_torch_flash.py``); a distributed train step,
  decode steps on a placed cache, a sharded Trainer's resume and
  ``restore(shardings=)`` bit for bit their unsharded runs; ``gpipe`` at
  one stage and the pod all-reduce at one rank.
* Local attention heads: a rank's query heads ``h0..h0+Hl`` read global KV
  head ``(h0 + h) // (H / KV)`` (nonzero ``h0``, groups split or whole).
* Compression: ``quantize_int8``, ``dequantize_int8`` and
  ``compress_grads_with_feedback`` bit for bit JAX's on seeded inputs,
  zeros, exact ``.5`` ties and values clipped at +-127.

World sizes 2 and 4 are ``tests/test_torch_dist_lm.py``.
"""
import dataclasses
import functools
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding, PartitionSpec as P

import repro.configs as JC
from repro.dist import compression as JQ
from repro.dist import sharding as JS
from repro.launch import shapes as JSH
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
import repro_torch.configs as TC
from repro_torch import ckpt
from repro_torch.dist import compression as Q
from repro_torch.dist import hints as H
from repro_torch.dist import sharding as TS
from repro_torch.dist.local import _kv_heads, _seq_sharded_attention, whole
from repro_torch.dist.pipeline import gpipe
from repro_torch.interop import params_from_jax
from repro_torch.kernels.ref import ref_flash_attention
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.layout import _to_port
from repro_torch.train import AdamWConfig, TrainConfig, Trainer, init_opt
from repro_torch.train.step import make_train_step
from _torch_threads import one_torch_thread  # noqa: F401 (pytestmark uses it)

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

pytestmark = pytest.mark.usefixtures("one_torch_thread")


MESHES = [{"data": 4, "model": 2}, {"pod": 2, "data": 16, "model": 16}]


def _norm(spec, ndim: int) -> tuple:
    """A spec as a tuple of ``ndim`` entries (JAX drops trailing Nones)."""
    s = tuple(spec)
    return s + (None,) * (ndim - len(s))


def _amesh(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _policies(arch: str, shape: dict):
    """(port Policy, JAX Policy) pairs: for_mesh train and decode, every
    recommended mode of the reduced and of the full config, a 2-D TP
    policy; the pairs are checked equal field for field."""
    am = _amesh(shape)
    pairs = [(TS.Policy.for_mesh(shape), JS.Policy.for_mesh(am)),
             (TS.Policy.for_mesh(shape, "decode"), JS.Policy.for_mesh(am, "decode"))]
    for mode in ("train", "prefill", "decode"):
        for tcfg, jcfg in ((TC.get_reduced(arch), JC.get_reduced(arch)),
                           (TC.get(arch), JC.get(arch))):
            pairs.append((TS.Policy.recommended(tcfg, shape, mode),
                          JS.Policy.recommended(jcfg, am, mode)))
    axes = tuple(shape)
    pairs.append((TS.Policy(dp=(), tp=axes, fsdp=(), shard_seq=True, sp="model"),
                   JS.Policy(dp=(), tp=axes, fsdp=(), shard_seq=True, sp="model")))
    for a, b in pairs:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    return list({a: None for a, _ in pairs})


@functools.cache
def _jax_params_struct(arch: str):
    return JSH.params_struct(JC.get_reduced(arch))


def _jax_leaf_specs(arch: str, pol, shape: dict) -> dict:
    """{JAX leaf path: (normalized spec, leaf shape)}."""
    tree = _jax_params_struct(arch)
    specs = JS.param_specs(tree, JS.Policy(**dataclasses.asdict(pol)), shape)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return {tuple(k.key for k in path): (_norm(s, len(x.shape)), tuple(x.shape))
            for (path, x), s in zip(leaves, spec_leaves)}


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_specs_match_jax(arch):
    cfg = TC.get_reduced(arch)
    lv = TS.leaves(cfg)
    for shape in MESHES:
        for pol in _policies(arch, shape):
            want = _jax_leaf_specs(arch, pol, shape)
            got = TS.param_specs(cfg, pol, shape)
            assert {lv[n].path for n in got} == set(want)   # every leaf covered
            for name, spec in got.items():
                wspec, wshape = want[lv[name].path]
                assert lv[name].shape == wshape, name
                assert _norm(spec, len(wshape)) == wspec, (name, pol, shape)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_batch_and_cache_specs_match_jax(arch):
    tcfg, jcfg = TC.get_reduced(arch), JC.get_reduced(arch)
    B, S = 32, 64
    cache = init_cache(tcfg, B, S, device="cpu")
    jcache = JSH.cache_struct(jcfg, B, S)
    for shape in MESHES:
        am = _amesh(shape)
        for pol in _policies(arch, shape):
            jpol = JS.Policy(**dataclasses.asdict(pol))
            want = {k: tuple(v) for k, v in JS.batch_specs(jcfg, jpol).items()}
            assert TS.batch_specs(tcfg, pol) == want
            got = TS.cache_spec_tree(tcfg, cache, pol, shape)
            jtree = JS.cache_spec_tree(jcfg, jcache, jpol, am)
            assert set(got) == set(jtree)
            for b, leaves in jtree.items():
                assert set(got[b]) == set(leaves)
                for n, sh in leaves.items():
                    nd = cache[b][n].dim()
                    assert _norm(got[b][n], nd) == _norm(sh.spec, nd), (b, n, pol)


@pytest.fixture
def fake_world(request):
    """A fake-backend process group of 8 ranks (this process plays
    ``request.param``'s rank), destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=request.param, world_size=8)
    yield request.param
    dist.destroy_process_group()


@pytest.mark.parametrize("fake_world", [0, 5], indirect=True)
@pytest.mark.parametrize("arch", ["qwen3_4b", "kimi_k2_1t_a32b", "jamba_1_5_large_398b",
                                  "xlstm_1_3b", "whisper_small", "llama4_maverick_400b_a17b",
                                  "internvl2_76b"])
def test_placements_give_jax_shard_shapes(arch, fake_world):
    """Local shapes of every parameter distributed on a (4, 2) mesh of the
    fake backend equal JAX's shard shapes in the port's layout."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    shape = MESHES[0]
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    cfg = TC.get_reduced(arch)
    am = _amesh(shape)
    for pol in _policies(arch, shape):
        for name, lf in TS.leaves(cfg).items():
            jspec = TS._leaf_spec(lf.path, lf.shape, pol, shape)
            shard = JNamedSharding(am, P(*jspec)).shard_shape(lf.shape)
            if lf.path[0] in ("layers", "encoder"):
                shard = shard[1:]
            want = tuple(_to_port(torch.empty(shard, device="meta"), lf.kind).shape)
            full = tuple(_to_port(torch.empty(lf.shape[1:] if lf.path[0] in ("layers", "encoder")
                                              else lf.shape, device="meta"), lf.kind).shape)
            pl = TS.placements(TS.port_spec(lf, jspec), mesh)
            t = distribute_tensor(torch.empty(full, device="meta"), mesh, pl)
            assert tuple(t.to_local().shape) == want, (name, pol)


def test_port_spec_and_placements():
    lf = TS.Leaf(("layers", "b0", "wq"), "in", (2, 128, 4, 32))
    assert TS.port_spec(lf, (None, "data", "model", None)) == ("model", "data")
    lf = TS.Leaf(("layers", "b0", "wo"), "out", (2, 4, 32, 128))
    assert TS.port_spec(lf, (None, "model", None, "data")) == ("data", "model")
    lf = TS.Leaf(("layers", "b0", "bq"), "flat", (2, 4, 32))
    assert TS.port_spec(lf, (None, "model", None)) == ("model",)
    with pytest.raises(ValueError, match="trailing"):
        TS.port_spec(lf, (None, None, "model"))
    from torch.distributed.tensor import Replicate, Shard

    names = {"pod": 2, "data": 4, "model": 2}
    assert TS.placements((("pod", "data"), "model"), names) == [Shard(0), Shard(0), Shard(1)]
    assert TS.placements((None,), names) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements((("data", "pod"),), names)


def test_hints_are_identity_outside_the_context():
    cfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), dtype="float32")
    model = init_params(cfg, device="cpu")
    period, x = model.layers[0], torch.zeros(2, 4, cfg.d_model)
    d = {"embed": model.embed}
    assert H.current_hints() is None
    assert H.gather_params(period) is period and H.gather_params(d) is d
    assert H.act_seq(x) is x
    pol = TS.Policy.for_mesh({"data": 1, "model": 1})
    with H.sharding_hints(H.Hints(pol)) as h:
        assert H.current_hints() is h
        assert H.gather_params(period) is period and H.act_seq(x) is x
    with H.sharding_hints(H.Hints(pol, gather_weights=True, seq_shard=True)):
        # plain (non-DTensor) tensors are left as they are
        g = H.gather_params(period)
        assert g.b0.wq is period.b0.wq and H.act_seq(x) is x
    assert H.current_hints() is None


@pytest.mark.parametrize("fake_world", [5], indirect=True)
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_every_family_distributes(arch, fake_world):
    """``distribute_params`` places every arch (MoE, Mamba, xLSTM, encoder
    and embedding frontend included) on a (4, 2) mesh of the fake backend
    under the train, decode and 2-D decode policies, each local shape JAX's
    shard shape in the port's layout."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MESHES[0]
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    am = _amesh(shape)
    cfg = TC.get_reduced(arch)
    lv = TS.leaves(cfg)
    for pol in (TS.Policy.for_mesh(mesh), TS.Policy.for_mesh(mesh, "decode"),
                TS.Policy(dp=(), tp=("data", "model"), fsdp=(), shard_seq=True, sp="model")):
        model = TS.distribute_params(init_params(cfg, device="cpu"), mesh, pol)
        assert model.dist_state == (mesh, pol)
        for name, p in model.named_parameters():
            lf = lv[name]
            jspec = TS._leaf_spec(lf.path, lf.shape, pol, shape)
            shard = JNamedSharding(am, P(*jspec)).shard_shape(lf.shape)
            if lf.path[0] in ("layers", "encoder"):
                shard = shard[1:]
            want = tuple(_to_port(torch.empty(shard, device="meta"), lf.kind).shape)
            assert tuple(p.to_local().shape) == want, (arch, name, pol)


def test_moe_group_plan_over_batch_halves():
    """Routing ids gathered from the two halves of a batch give each
    half's tokens the slots ``dispatch_plan`` gives them on the whole batch
    (one group spans both halves; at capacity factor 0.5 pairs drop), which
    a plan of a half alone does not."""
    from repro_torch.models import moe as M

    E, k, T = 4, 2, 64
    G = M._pick_groups(T)
    cap = M.capacity(T // G, k, E, 0.5)
    rng = np.random.default_rng(4)
    halves = [torch.from_numpy(rng.integers(0, E, (T // 2, k))) for _ in range(2)]
    ids = torch.cat(halves)                        # what the gather over the halves gives
    keep, pos = M.dispatch_plan(ids.view(G, T // G, k), E, cap)
    keep, pos = keep.reshape(T, k, E), pos.reshape(T, k)
    assert (keep.sum((1, 2)) < k).any()
    for h, t0 in enumerate((0, T // 2)):
        gids, gkeep, gpos = M.group_plan(ids, G, t0, T // 2, E, cap)
        g = T // G
        gi0 = t0 // g
        lo = t0 - gi0 * g
        assert torch.equal(gids.reshape(-1, k)[lo:lo + T // 2], halves[h])
        assert torch.equal(gkeep.reshape(-1, k, E)[lo:lo + T // 2], keep[t0:t0 + T // 2])
        assert torch.equal(gpos.reshape(-1, k)[lo:lo + T // 2], pos[t0:t0 + T // 2])
    alone, _ = M.dispatch_plan(halves[1].view(1, T // 2, k), E, M.capacity(T // 2, k, E, 0.5))
    assert not torch.equal(alone.reshape(-1, k, E), keep[T // 2:])


@pytest.mark.parametrize("H_,KV,h0,Hl", [(8, 2, 2, 2), (8, 2, 4, 4), (6, 3, 3, 3), (6, 3, 1, 2),
                                         (4, 4, 2, 2)])
def test_local_heads_read_their_kv_heads(H_, KV, h0, Hl):
    """A rank's query heads h0..h0+Hl over the whole KV heads: attention
    equal to the same heads of the unsharded attention."""
    rng = np.random.default_rng(H_ * 10 + h0)
    q = torch.from_numpy(rng.normal(size=(2, 9, H_, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 9, KV, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 9, KV, 32)).astype(np.float32))
    G = H_ // KV
    kl, vl = _kv_heads(k, h0, Hl, G), _kv_heads(v, h0, Hl, G)
    want = torch.arange(h0, h0 + Hl) // G
    expand = Hl // kl.shape[2]
    assert torch.equal(kl.repeat_interleave(expand, 2), k[:, :, want])
    got = ref_flash_attention(q[:, :, h0:h0 + Hl], kl, vl, causal=True)
    ref = ref_flash_attention(q, k, v, causal=True)[:, :, h0:h0 + Hl]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)



def test_seq_sharded_attention_rounds_weights_as_sdpa():
    """The decode attention over a sequence-sharded cache, on one slice
    (no group to merge over), in bfloat16: equal to ``_sdpa``, which
    rounds the float32 softmax weights to the model dtype before their
    product with the values."""
    from repro_torch.models.layers import _sdpa

    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((3, 1, 8, 64), (3, 24, 2, 64), (3, 24, 2, 64)))
    keep = torch.arange(24)[None] <= torch.tensor([3, 10, 23])[:, None]
    got = _seq_sharded_attention(q, k, v, keep, [])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _sdpa(q, k, v, keep[:, None, None, None, :]))


# ------------------------------------------------------------ compression


def _compression_inputs():
    rng = np.random.default_rng(11)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 126.5, -127.0, 127.0], np.float32)
    return [np.zeros(17, np.float32), ties, rng.normal(size=1000).astype(np.float32),
            (rng.normal(size=(8, 33)) * 1e-3).astype(np.float32),
            rng.standard_cauchy(500).astype(np.float32)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_quantize_matches_jax_bits():
    for x in _compression_inputs():
        q, s = Q.quantize_int8(torch.from_numpy(x))
        jq, js = JQ.quantize_int8(jnp.asarray(x))
        _same(q.numpy(), jq)
        _same(s.numpy(), js)
        _same(Q.dequantize_int8(q, s).numpy(), JQ.dequantize_int8(jq, js))
        # a given scale below the absmax clips at +-127
        for scale in (np.float32(0.01), np.float32(0.0)):
            q, s = Q.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
            jq, js = JQ.quantize_int8(jnp.asarray(x), jnp.asarray(scale))
            _same(q.numpy(), jq)
            _same(Q.dequantize_int8(q, s).numpy(), JQ.dequantize_int8(jq, js))
    # the ties round half to even, and a bfloat16 input computes in float32
    q, _ = Q.quantize_int8(torch.from_numpy(_compression_inputs()[1]))
    assert q.tolist()[:6] == [0, 2, 2, 0, -2, 4]
    xb = torch.from_numpy(_compression_inputs()[2]).to(torch.bfloat16)
    jq, js = JQ.quantize_int8(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    q, s = Q.quantize_int8(xb)
    _same(q.numpy(), jq)
    _same(s.numpy(), js)


def test_feedback_matches_jax_bits():
    rng = np.random.default_rng(5)
    res, jres = None, None
    for step in range(4):
        g = (rng.normal(size=200) * (step + 1)).astype(np.float32)
        d, res = Q.compress_grads_with_feedback(torch.from_numpy(g), res)
        jd, jres = JQ.compress_grads_with_feedback(jnp.asarray(g), jres)
        _same(d.numpy(), jd)
        _same(res.numpy(), jres)


# ------------------------------------------------------- a group of one rank


@pytest.fixture(scope="module")
def group_of_one(tmp_path_factory):
    """A gloo process group of one rank in this process, and its (1, 1)
    host mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "s"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield make_host_mesh(1, 1, device="cpu")
    dist.destroy_process_group()


def _f32(arch: str, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(JC.get_reduced(arch), **over),
            dataclasses.replace(TC.get_reduced(arch), **over))


def _batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"labels": tok}
    if cfg.frontend == "embed":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = tok
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(size=(B, 12, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen3_4b", "whisper_small", "internvl2_76b"])
def test_hinted_forward_on_one_rank(arch, group_of_one):
    """Distributed under every policy of the (1, 1) mesh, with the hints
    on: bit for bit the plain forward, and within 1e-5 of JAX's."""
    mesh = group_of_one
    jcfg, tcfg = _f32(arch)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jp)
    batch = _batch(tcfg, 2, 16)
    plain = params_from_jax(host, tcfg, "cpu")
    with torch.no_grad():
        want, _ = forward(plain, tcfg, batch)
    jl, _ = jax_forward(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(want.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    shape = {"data": 1, "model": 1}
    for pol in (TS.Policy.for_mesh(mesh), TS.Policy.recommended(tcfg, mesh, "train"),
                TS.Policy.for_mesh(mesh, "decode")):
        model = TS.distribute_params(params_from_jax(host, tcfg, "cpu"), mesh, pol)
        assert set(TS.param_specs(tcfg, pol, shape)) == {n for n, _ in model.named_parameters()}
        for hints in (None, H.Hints(pol, gather_weights=True, seq_shard=True)):
            with torch.no_grad(), (H.sharding_hints(hints) if hints else _null()):
                got, _ = forward(model, tcfg, batch)
            assert torch.equal(whole(got), want), (pol, hints)


def _null():
    import contextlib

    return contextlib.nullcontext()


def test_train_decode_and_resume_on_one_rank(group_of_one, tmp_path):
    """A distributed train step, decode steps on a placed cache, a sharded
    Trainer resumed from an unsharded checkpoint, and ``restore(shardings=)``:
    bit for bit their unsharded runs."""
    mesh = group_of_one
    _, cfg = _f32("qwen1_5_0_5b")
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg, 4, 16, seed=3)

    def model():
        return init_params(cfg, device="cpu", param_dtype=torch.float32).requires_grad_()

    ref, sh = model(), TS.distribute_params(model(), mesh, TS.Policy.for_mesh(mesh))
    o1, o2 = init_opt(oc, ref), init_opt(oc, sh)
    step = make_train_step(cfg, oc, remat="dots")
    for _ in range(2):
        _, o1, m1 = step(ref, o1, batch)
        _, o2, m2 = step(sh, o2, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m1[k], m2[k]) and not hasattr(m2[k], "placements"), k
    for (n, a), b in zip(ref.named_parameters(), sh.parameters()):
        assert torch.equal(whole(b), a), n
    for k in o1.m:
        assert torch.equal(whole(o2.m[k]), o1.m[k]) and torch.equal(whole(o2.v[k]), o1.v[k])

    # decode: four steps on a cache placed by cache_spec_tree
    pol = TS.Policy.for_mesh(mesh, "decode")
    plain = init_params(cfg, device="cpu")
    dm = TS.distribute_params(init_params(cfg, device="cpu"), mesh, pol)
    tok = torch.from_numpy(batch["tokens"][:, :8]).long()
    logits, cache, _ = prefill(plain, cfg, {"tokens": tok}, max_seq=16)
    dcache = TS.distribute_cache(cfg, {b: {n: t.clone() for n, t in c.items()}
                                       for b, c in cache.items()}, mesh, pol)
    nxt = logits.argmax(-1)
    pos = torch.full((4,), 8)
    for _ in range(4):
        a, cache = decode_step(plain, cfg, cache, nxt, pos)
        b, dcache = decode_step(dm, cfg, dcache, nxt, pos)
        assert torch.equal(whole(b), a)
        nxt, pos = a.argmax(-1), pos + 1
    for bk, c in cache.items():
        for n, t in c.items():
            assert torch.equal(whole(dcache[bk][n]), t), (bk, n)
    # prefill of the distributed model equals the plain one, its cache placed
    dl, dc, _ = prefill(dm, cfg, {"tokens": tok}, max_seq=16)
    pl, pc, _ = prefill(plain, cfg, {"tokens": tok}, max_seq=16)
    assert torch.equal(whole(dl), pl)
    specs = TS.cache_spec_tree(cfg, pc, pol, mesh)
    for bk, c in pc.items():
        for n, t in c.items():
            assert list(dc[bk][n].placements) == TS.placements(specs[bk][n], mesh), (bk, n)
            assert torch.equal(whole(dc[bk][n]), t), (bk, n)

    # restore(shardings=): a saved tree comes back as DTensors of its values
    from torch.distributed.tensor import DTensor, Replicate

    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5, dtype=torch.int32)}}
    ckpt.save(tmp_path / "tree", tree, 1)
    sh_tree = {"a": TS.NamedSharding(mesh, (Replicate(), Replicate())), "b": {"c": None}}
    like = {"a": torch.empty(3, 4, device="meta"), "b": {"c": torch.empty(5, dtype=torch.int32)}}
    got, s = ckpt.restore(tmp_path / "tree", like, shardings=sh_tree)
    assert s == 1 and isinstance(got["a"], DTensor) and not isinstance(got["b"]["c"], DTensor)
    assert torch.equal(got["a"].full_tensor(), tree["a"])

    # a sharded Trainer resumes an unsharded run's checkpoint
    def tc(name, steps):
        return TrainConfig(steps=steps, global_batch=4, seq_len=16, ckpt_dir=str(tmp_path / name),
                           ckpt_every=2, keep=3, log_every=1)

    full = Trainer(cfg, tc("plain", 3), oc=oc, device="cpu", log_fn=lambda s: None).run()
    # the plain run's directory as it stood after step 2
    shutil.copytree(tmp_path / "plain", tmp_path / "resumed")
    shutil.rmtree(tmp_path / "resumed" / "step_00000003")
    logs = []
    res = Trainer(cfg, tc("resumed", 3), oc=oc, device="cpu", mesh=mesh,
                  policy=TS.Policy.recommended(cfg, mesh, "train"), log_fn=logs.append).run()
    assert "resumed from step 2" in logs
    assert [m["loss"] for m in res["metrics"]] == [m["loss"] for m in full["metrics"][2:]]


def test_pipeline_and_allreduce_on_one_rank(group_of_one):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pipe",))
    rng = np.random.default_rng(2)
    Ws = torch.from_numpy((rng.normal(size=(4, 8, 8)) * 0.3).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(3, 2, 8)).astype(np.float32))

    def block(W, h):
        return torch.tanh(h @ W)

    got = gpipe(block, mesh, "pipe")(Ws, xs)
    want = xs
    for W in Ws:
        want = block(W, want)
    assert torch.equal(got, want)
    x = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    assert torch.equal(Q.make_pod_allreduce()(x), x)
    q, s = Q.quantize_int8(x)
    assert torch.equal(Q.make_pod_allreduce(compress=True)(x), Q.dequantize_int8(q, s))
