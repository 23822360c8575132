"""The kernel library's first-use build when processes race for it.

A stand-in ``nvcc`` (found through ``CUDA_HOME``) writes each object in two
halves with a pause between them and links by concatenating the objects,
so the build runs here without a CUDA toolkit. Two processes wait on a
barrier, then call ``build()`` at once into an empty build directory: one
must compile, the other must wait for it and load the same, whole library.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from repro_torch.kernels import _build

_SRC = Path(__file__).resolve().parent.parent / "src"

_FAKE_NVCC = """\
#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as log:
    log.write(("link" if "-shared" in args else "compile") + "\\n")
if "-shared" in args:
    objs = [a for a in args if a.endswith(".o")]
    with open(out, "w") as f:
        f.write("".join(open(o).read() for o in objs))
else:
    src = os.path.basename(args[args.index("-c") + 1])
    with open(out, "w") as f:
        f.write("half of " + src + ";")
        f.flush()
        time.sleep(0.5)
        f.write(" rest of " + src + "\\n")
"""

_CALLER = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from repro_torch.kernels import _build

    root, barrier, who = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
    _build._BUILD_ROOT = root
    (barrier / who).touch()
    while len(list(barrier.iterdir())) < 2:
        time.sleep(0.01)
    print(_build.build())
""")


def test_concurrent_first_use_builds_once(tmp_path):
    cuda_home, barrier, root = tmp_path / "cuda", tmp_path / "barrier", tmp_path / "build"
    (cuda_home / "bin").mkdir(parents=True)
    barrier.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = cuda_home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(cuda_home), PYTHONPATH=str(_SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CALLER, str(root), str(barrier), who],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for who in ("a", "b")]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = {out.strip() for out, _err in outs}
    assert len(libs) == 1
    want = "".join(f"half of {s}; rest of {s}\n" for s in _build._SOURCES)
    assert Path(libs.pop()).read_text() == want
    assert sorted(log.read_text().split()) == ["compile"] * len(_build._SOURCES) + ["link"]
