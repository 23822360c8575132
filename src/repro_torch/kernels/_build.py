"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``. The
library is built at first use into ``build/repro_torch/<hash>/`` at the root
of the checkout (listed in ``.gitignore``), keyed by a hash of the sources
and flags, so a checkout builds it once and reuses it until a source
changes. Each source compiles in its own ``nvcc`` process, all started
together; the objects are then linked. Processes that build at the same time
take turns on a file lock in the build directory: the first compiles, the
others wait and load its library. No fast-math flag: the kernels rely on
IEEE division and rounding.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_SOURCES = ("cdf_scan.cu", "forest_delta.cu", "forest_sample.cu",
            "forest_sample_batched.cu", "alias_build.cu", "alias_sample.cu",
            "sample_tiled.cu", "flash_attention.cu")
_HEADERS = ("common.cuh",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB = "librepro_torch_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argument types. They return cudaError_t as int,
# apart from the queries named in _RETURNS.
_SIGNATURES = {
    "rt_cdf_scan": (_P, _P, *(_I,) * 10, _P),
    "rt_forest_delta": (_P, _P, _I, _I, _P),
    "rt_forest_sample": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "rt_forest_delta_update": (_P, _P, _P, _P, _I, _I, _P),
    "rt_forest_sample_batched": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rt_alias_build": (_P, _P, _P, _P, _I, _I, _P),
    "rt_alias_tiles": (_I,),
    "rt_alias_scratch_words": (_I,),
    "rt_alias_sample_batched": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "rt_sample_rows": (_P, _P, _P, _I, _I, _I, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *(_L,) * 12,
                           _I, _I, _F, _P),
}

_RETURNS = {"rt_alias_scratch_words": _L}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and Path(cuda_home, "bin", "nvcc").exists():
        return str(Path(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash is not built yet); returns
    the library path. Compiler output, with ``-Xptxas -v``'s register and
    shared-memory report, is kept in ``build.log`` beside the library."""
    out_dir = _BUILD_ROOT / _digest()
    lib = out_dir / _LIB
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():
            _compile(out_dir, lib)
    return lib


def _compile(out_dir: Path, lib: Path) -> None:
    """Compile every source into ``out_dir`` and link ``lib``."""
    nvcc = _nvcc()
    procs = []
    for name in _SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, _obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {name} (rc={p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"repro_torch: nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"{_LIB}.tmp"  # lib appears whole, for the unlocked check
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _n, o, _p in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"repro_torch: link failed:\n{link.stderr}")
    os.replace(tmp, lib)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _RETURNS.get(name, ctypes.c_int)
    return lib


def sass() -> dict[str, str]:
    """SASS of each function in the built library, by (mangled) name, from
    ``cuobjdump -sass`` beside ``nvcc``: what the card runs, e.g. to check
    that a kernel issues tensor-core instructions (``HGMMA``)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(build())], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(lines) for n, lines in funcs.items()}


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} launch failed: CUDA error {err}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
