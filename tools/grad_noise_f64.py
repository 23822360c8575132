"""How far float32 gradients of a reduced config stray from float64, in the
JAX package and in the port: the noise floor under the gradient tolerances
of ``tests/test_torch_train_families.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/grad_noise_f64.py --arch jamba_1_5_large_398b --step 0

One ``loss_fn`` gradient of JAX's init on one ``make_batch`` batch (2 x 16)
in three ways: the JAX package in float32, the port in float32, and a copy
of the JAX package in a temporary directory with every ``float32`` made
``float64``, run under ``jax_enable_x64`` in a subprocess on the same
float32 parameters and batch. Prints, per leaf whose two float32 gradients
differ by more than 1e-5 of the float64 leaf's largest entry, each one's
distance from float64 in that unit, and the worst of each over all leaves.
It imports both packages, as the tests do.
"""
import argparse
import dataclasses
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

F64_RUN = """
import dataclasses, sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, {root!r})
import repro.configs as C
from repro.models import init_params, loss_fn
cfg = dataclasses.replace(C.get_reduced({arch!r}), dtype="float32")
p32 = np.load({d!r} + "/params.npz")
params = jax.tree_util.tree_map_with_path(
    lambda k, x: jnp.asarray(p32[jax.tree_util.keystr(k)].astype(np.float64)),
    jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg)))
b = np.load({d!r} + "/batch.npz")
batch = {{k: jnp.asarray(b[k].astype(np.float64) if b[k].dtype.kind == "f" else b[k])
          for k in b.files}}
g = jax.jit(jax.grad(lambda p: loss_fn(p, cfg, batch)[0]))(params)
np.savez({d!r} + "/g64.npz", **{{jax.tree_util.keystr(k): np.asarray(v)
                                 for k, v in jax.tree_util.tree_leaves_with_path(g)}})
"""


def _keyed(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba_1_5_large_398b")
    ap.add_argument("--step", type=int, default=0, help="make_batch step of the batch")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    import repro.configs as JC
    from repro.models import init_params as jax_init_params
    from repro.models import loss_fn as jax_loss_fn
    import repro_torch.configs as TC
    from repro_torch.data import make_batch
    from repro_torch.interop import params_from_jax, params_to_jax
    from repro_torch.models import loss_fn

    jcfg = dataclasses.replace(JC.get_reduced(args.arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced(args.arch), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    batch = make_batch(tcfg, args.step, 2, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g_jax = _keyed(jax.jit(jax.grad(lambda p: jax_loss_fn(p, jcfg, jb)[0]))(jp))
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                            param_dtype=torch.float32).requires_grad_(True)
    loss_fn(model, tcfg, batch)[0].backward()
    g_port = _keyed(params_to_jax({n: p.grad for n, p in model.named_parameters()}, tcfg))

    d = tempfile.mkdtemp(prefix="grad_noise_f64_")
    try:
        shutil.copytree(ROOT / "src" / "repro", Path(d) / "repro",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for f in (Path(d) / "repro").rglob("*.py"):
            f.write_text(f.read_text().replace("jnp.float32", "jnp.float64")
                         .replace("np.float32", "np.float64"))
        np.savez(Path(d) / "params.npz", **{k: np.asarray(v) for k, v in _keyed(jp).items()})
        np.savez(Path(d) / "batch.npz", **batch)
        subprocess.run([sys.executable, "-c", F64_RUN.format(root=d, arch=args.arch, d=d)],
                       check=True)
        g64 = dict(np.load(Path(d) / "g64.npz"))
    finally:
        shutil.rmtree(d, ignore_errors=True)

    worst = {"jax": 0.0, "port": 0.0, "jax-port": 0.0}
    print(f"{args.arch} reduced, float32, make_batch step {args.step}; distances in units of "
          "the float64 leaf's largest entry")
    for k, t in g64.items():
        mx = float(np.abs(t).max()) or 1.0
        dist = {"jax": np.abs(g_jax[k] - t).max() / mx, "port": np.abs(g_port[k] - t).max() / mx,
                "jax-port": np.abs(g_jax[k] - g_port[k]).max() / mx}
        worst = {n: max(worst[n], float(v)) for n, v in dist.items()}
        if dist["jax-port"] > 1e-5:
            print(f"{k}: " + ", ".join(f"{n} {v:.2e}" for n, v in dist.items()))
    print("worst over all leaves: " + ", ".join(f"{n} {v:.2e}" for n, v in worst.items()))


if __name__ == "__main__":
    main()
