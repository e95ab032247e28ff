"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``.
Builds happen at first use (never at import), one ``nvcc`` per source, all
started together; the output goes to ``.build/<hash>/`` beside this file,
keyed by a hash of every source and the flags, so an edit rebuilds.  A
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name(".build")
SOURCES = ("bitmap_build", "bitmap_filter", "bitplane", "compaction", "flash_attention",
           "flash_attention_bwd", "postings")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# (source, symbol) -> (the library it was looked up in, the typed function).
_functions: dict[tuple[str, str], tuple[ctypes.CDLL, object]] = {}
# Wall seconds of each source's nvcc in this process's builds.
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """``.build/<hash>``: the hash covers every file in ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _compile(name: str, out: Path) -> tuple[Path, subprocess.CompletedProcess, float]:
    tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tmp, proc, time.perf_counter() - t0


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that is not built yet, all at once.

    Returns ``{name: library path}``.  Each library's compiler output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it
    as ``lib<name>.log``, and each build's seconds in ``BUILD_SECONDS``.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    failed = []
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        results = list(pool.map(lambda n: _compile(n, out), todo))
    for name, (tmp, proc, seconds) in zip(todo, results):
        BUILD_SECONDS[name] = seconds
        (out / f"lib{name}.log").write_text(proc.stdout)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{proc.stdout}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            path = build((name,))[name]
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument
    types set and an int result, looked up once per loaded library: a
    wrapper's per-call host work is then the call itself."""
    lib = library(name)
    hit = _functions.get((name, symbol))
    if hit is not None and hit[0] is lib:
        return hit[1]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _functions[(name, symbol)] = (lib, fn)
    return fn
