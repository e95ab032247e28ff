"""Shared by the mesh-driver tests (``test_torch_mesh_*.py``): seeded
inputs, and the two sides that run them.

* The reference: one process of the JAX package on 4 fake CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), running every
  case and writing one ``.npz``.
* The port: 4 ranks of a gloo group (``python -c`` children, a ``file://``
  store in a temporary directory), each running every case and writing its
  own ``.npz``, so the tests also see that every rank returns the same.

Both sides build their inputs from the same seeds with numpy.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240


def planted_sets(n: int, seed: int, universe: int = 120, max_len: int = 14,
                 n_planted: int = 40) -> list:
    """``n`` random sets of 1 to ``max_len - 1`` tokens, the first
    ``n_planted`` of every three followed by a near copy (a token dropped
    with probability 0.1), so every similarity has pairs."""
    rng = np.random.default_rng(seed)
    sets = [rng.choice(universe, size=int(rng.integers(1, max_len)), replace=False).tolist()
            for _ in range(n)]
    for i in range(0, min(3 * n_planted, n - 1), 3):
        sets[i + 1] = [t for t in sets[i] if rng.random() > 0.1] or sets[i][:1]
    return sets


def probe_sets(base: list, n: int, seed: int, universe: int = 120) -> list:
    """``n`` probe sets: a third near copies of ``base`` rows, the rest random."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 3 == 0:
            src = base[int(rng.integers(len(base)))]
            out.append([t for t in src if rng.random() > 0.15] or src[:1])
        else:
            out.append(rng.choice(universe, size=int(rng.integers(2, 12)),
                                  replace=False).tolist())
    return out


def hot_sets(n: int, seed: int) -> list:
    """Sets over a Zipf-hot universe of 60 tokens: a few tokens carry most
    postings, so no cut balances the slabs."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n):
        size = int(rng.integers(2, 12))
        sets.append(np.unique(np.minimum(rng.zipf(1.25, size=3 * size + 6), 60))[:size]
                    .tolist())
    for i in range(0, 90, 3):
        sets[i + 1] = sets[i]
    return sets


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT / "tests")]))
    env.update(extra)
    return env


def start_reference(script: str, out: Path) -> subprocess.Popen:
    """The JAX package on 4 fake devices runs ``script`` with ``OUT`` set to
    the ``.npz`` it writes."""
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               JAX_PLATFORMS="cpu", OUT=str(out))
    return subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_port(script: str, out_dir: Path) -> list:
    """4 gloo ranks run ``script``, each with ``RANK``, ``WORLD_SIZE``,
    ``INIT`` (a ``file://`` store) and ``OUT`` (its ``.npz``) set."""
    init = f"file://{out_dir / 'store'}"
    return [subprocess.Popen(
        [sys.executable, "-c", script],
        env=_env(RANK=str(r), WORLD_SIZE=str(WORLD), INIT=init,
                 OUT=str(out_dir / f"port{r}.npz"), OMP_NUM_THREADS="1"),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]


def wait(procs: list, timeout: float = TIMEOUT) -> None:
    """Wait for every process; on a failure or a timeout kill the rest and
    raise with the failing one's output."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    bad = [(k, p.returncode, o, e) for k, (p, (o, e)) in enumerate(zip(procs, outs))
           if p.returncode]
    if bad:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise AssertionError("\n".join(f"process {k} exit {rc}\n{o[-2000:]}\n{e[-3000:]}"
                                        for k, rc, o, e in bad))


# The port's child: join the gloo group, bind OUT's results.
PORT_PRELUDE = r"""
import os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=RANK,
                        world_size=int(os.environ["WORLD_SIZE"]))
from repro_torch.launch.mesh import make_mesh
RES = {}
"""

PORT_EPILOGUE = r"""
np.savez(os.environ["OUT"], **RES)
dist.barrier()
dist.destroy_process_group()
"""

REF_PRELUDE = r"""
import os
import numpy as np
import jax
assert jax.device_count() == 4, jax.devices()
from repro.launch.mesh import make_mesh
RES = {}
"""

REF_EPILOGUE = r"""
np.savez(os.environ["OUT"], **RES)
"""


def stats_row(stats) -> np.ndarray:
    """A ``JoinStats`` as int64[8], in its field order."""
    return np.array([stats.total_pairs, stats.blocks_total, stats.blocks_skipped,
                     stats.candidates, stats.verified_true, stats.overflow_blocks,
                     stats.candidates_generated, stats.postings_expanded], dtype=np.int64)


def load(out_dir: Path) -> tuple:
    """``(reference, [rank 0, ..., rank 3])`` results as dicts of arrays."""
    ref = dict(np.load(out_dir / "ref.npz"))
    ports = [dict(np.load(out_dir / f"port{r}.npz")) for r in range(WORLD)]
    return ref, ports
