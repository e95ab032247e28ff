"""Dry run of every (arch x shape x mesh) cell at the production meshes (the
port of ``repro.launch.dryrun``): one rank's sharded program run on
``meta`` tensors under a fake process group of 256 or 512 ranks, its
flops, bytes, collectives and memory counted (``launch/cost.py``) and its
roofline on the H100 (``launch/roofline.py``).

Usage:

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--jobs 4] [--mesh both]
    python -m repro_torch.launch.dryrun --arch bitmap-join --shape join_1m

Train cells run ``sharded_train_step`` on this rank's slices of the state;
prefill and decode cells ``sharded_prefill`` (``last_only``) and
``sharded_decode_step`` on its slices of the parameters and the cache (at
long_500k's batch of 1 every rank holds the row and the shared block's K/V
sequence is split over the data axes, the cache's sequence fallback).  A
shape a config does not take (long_500k outside the ssm and hybrid
families) ends as ``skipped``.  The join cell
runs one rank's ring sweep (``core.join.ring_sweep``) for real, on the
device present (the card, else the CPU), at its shard of the 1M-set
collection; its flops and bytes are row 1's analytic count (the verdict
kernel's, as ``chip_smoke.py`` counts its bound), its traffic the ring's
hops as ``RingShift`` records them.

Each cell writes one JSON file to ``--out`` (``dryrun_out/`` at the repo's
root by default, which git ignores) with the reference's fields
(``trace_seconds`` in place of ``compile_seconds``); ``--all`` runs each
cell in a fresh subprocess and prints a summary that counts skipped cells
apart from failures.  ``python -m repro_torch.launch.report DIR`` prints
the tables.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, input_specs, shape_applicable
from repro_torch.launch import cost, roofline

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"

JOIN_SHAPES = {"join_1m": dict(n_sets=1 << 20, max_len=64, b=128, tau=0.8, capacity=2048)}
# Row 1's count per (r, s) pair, as chip_smoke.py's bound counts it: the
# verdict's integer ops (2 positivity + 2 cutoff tests, sum, sub, shift, 2
# min, compare) and the Hamming distance's (an inner product's W words and
# two popcounts a word).
VERDICT_OPS = 10


def _meta(shape, dtype, requires_grad=False) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=requires_grad)


def _local_tree(shapes: Dict, specs: Dict, sizes: dict, requires_grad=False) -> Dict:
    """Meta tensors of this rank's slices of a tree of meta tensors."""
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.train.tree import tree_map

    return tree_map(lambda t, sp: _meta(local_shape(t.shape, sp, sizes), t.dtype, requires_grad),
                    shapes, specs)


def _batch(cfg, sp: ShapeSpec, mesh_sizes: dict, batch_axes) -> Dict[str, torch.Tensor]:
    """This rank's rows of the cell's inputs (``input_specs``): over the
    batch axes when the global batch divides them, as the reference's
    dry run lays them out."""
    n = math.prod(mesh_sizes[a] for a in batch_axes) if batch_axes else 1
    rows = sp.global_batch // n if sp.global_batch % n == 0 else sp.global_batch
    return {k: _meta((rows,) + tuple(v.shape[1:]), v.dtype)
            for k, v in input_specs(cfg, sp).items()}


def trace_cell(cfg, sp: ShapeSpec, mesh, opts: Optional[dict] = None) -> cost.Measured:
    """Run one rank's program of ``cfg`` at shape ``sp`` on ``mesh`` (a
    ``DeviceMesh`` over an initialised, usually fake, group) on meta tensors
    and count it."""
    from repro_torch.distributed.sharding import activation_sharding, mesh_sizes
    from repro_torch.models.decode import cache_shapes, cache_specs, sharded_decode_step, \
        sharded_prefill
    from repro_torch.models.model import dtype_of, param_shapes, param_specs
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.optimizer import opt_init
    from repro_torch.train.step import sharded_train_step

    opts = opts or {}
    sizes = mesh_sizes(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in sizes)
    sp_kw = {"seq_parallel": bool(opts.get("seq_parallel", False))}
    if sp.kind == "train":
        opt_cfg = OptimizerConfig(name=opts.get("optimizer", "adamw"))
        step, sspecs, _ = sharded_train_step(
            cfg, opt_cfg, mesh, microbatches=opts.get("microbatches", 1),
            triangle=opts.get("triangle", False), fsdp=fsdp, **sp_kw)
        params = _local_tree(param_shapes(cfg), sspecs["params"], sizes, requires_grad=True)
        state = {"step": _meta((), torch.int32), "params": params,
                 "opt": opt_init(opt_cfg, params)}
        batch = _batch(cfg, sp, sizes, fsdp)
        return cost.measure(step, state, batch, arguments=(state, batch))
    pspecs = param_specs(cfg, mesh, fsdp=fsdp)
    params = _local_tree(param_shapes(cfg), pspecs, sizes)
    batch = _batch(cfg, sp, sizes, fsdp)
    if sp.kind == "prefill":
        def run():
            with torch.no_grad(), activation_sharding(mesh, batch_axes=fsdp, **sp_kw):
                return sharded_prefill(cfg, params, pspecs, batch, max_len=sp.seq_len,
                                       last_only=True, global_batch=sp.global_batch)
        return cost.measure(run, arguments=(params, batch))
    cdt = dtype_of(cfg.dtype)

    def meta_leaves(shapes):   # the hybrid's shared K/V nests
        return {k: meta_leaves(v) if isinstance(v, dict) else
                _meta(v, torch.int32 if k == "cur" else cdt) for k, v in shapes.items()}

    cache = _local_tree(meta_leaves(cache_shapes(cfg, sp.global_batch, sp.seq_len)),
                        cache_specs(cfg, mesh, sp.global_batch, fsdp=fsdp), sizes)

    def run():
        with torch.no_grad(), activation_sharding(mesh, batch_axes=fsdp, **sp_kw):
            return sharded_decode_step(cfg, params, pspecs, cache, batch)
    return cost.measure(run, arguments=(params, cache, batch))


def _record(arch: str, shape: str, mesh_name: str, n_dev: int, measured: cost.Measured,
            model_flops: float, active: int, total: int) -> dict:
    costs = measured.costs
    rl = roofline.compute_roofline(arch=arch, shape=shape, mesh_name=mesh_name,
                                   n_devices=n_dev, costs=costs, model_flops=model_flops)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name, "n_devices": n_dev,
        "trace_seconds": measured.seconds, "active_params": active, "total_params": total,
        "model_flops": model_flops, "memory": measured.memory,
        "hlo": {"flops_per_device": costs.flops, "hbm_bytes_per_device": costs.hbm_bytes,
                "collective_traffic_per_device": costs.collective_traffic,
                "collectives": [dataclasses.asdict(c) for c in costs.collectives[:20]],
                "per_opcode_flops": costs.per_opcode_flops},
        "roofline": rl.as_dict(),
    }


def lower_cell(arch: str, shape: str, mesh_name: str, *, opts: Optional[dict] = None) -> dict:
    """One cell at the production mesh, in this process (which it makes
    rank 0 of a fake group of 256 or 512 ranks): the record's fields."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import active_param_count, param_count

    opts = opts or {}
    multi = mesh_name == "multi"
    n_dev = 512 if multi else 256
    t0 = time.perf_counter()
    cost.fake_world(n_dev)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    mesh_s = time.perf_counter() - t0
    if arch == "bitmap-join":
        rec = _join_cell(shape, mesh, mesh_name, opts)
    else:
        cfg = configs.get(arch)
        sp = SHAPES[shape]
        if not shape_applicable(cfg, shape):
            raise SystemExit(f"shape {shape} not applicable to {arch}")
        measured = trace_cell(cfg, sp, mesh, opts)
        active = active_param_count(cfg)
        rec = _record(arch, shape, mesh_name, n_dev, measured,
                      roofline.model_flops_for(cfg, sp, active), active, param_count(cfg))
    rec["mesh_seconds"] = mesh_s
    return rec


def _join_cell(shape: str, mesh, mesh_name: str, opts: dict) -> dict:
    """The paper's own workload on the production mesh: one rank's ring
    sweep of the self-join, its shard of rows (a seeded ZIPF collection's
    sets, at most ``max_len`` tokens) against the S shard at each of the
    ring's hops, on the device present."""
    from repro_torch.core import verify
    from repro_torch.core.bitmap import generate_bitmaps
    from repro_torch.core.constants import PAD_TOKEN
    from repro_torch.core.join import ring_sweep
    from repro_torch.data.collections import zipf_collection
    from repro_torch.distributed.sharding import join_axes, recording_collectives

    js = JOIN_SHAPES[shape]
    _, group, n_dev, my = join_axes(mesh, None)
    n, l, b, tau = js["n_sets"], js["max_len"], js["b"], js["tau"]
    shard = n // n_dev
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    # The paper's ZIPF (Poisson(50) sizes), its sets of at most max_len
    # tokens: the collection is sorted by size, so they come first.
    col = zipf_collection(n_sets=shard + shard // 4, seed=opts.get("seed", 0))
    if col.lengths[shard - 1] > l:
        raise RuntimeError(f"fewer than {shard} sets of at most {l} tokens")
    tokens = np.full((shard, l), PAD_TOKEN, dtype=np.int32)
    width = min(l, col.tokens.shape[1])
    tokens[:, :width] = col.tokens[:shard, :width]
    tok = torch.from_numpy(tokens).to(dev)
    length = torch.from_numpy(col.lengths[:shard].astype(np.int32)).to(dev)
    word = generate_bitmaps(tok, length, b, tau_jaccard=tau)
    need_tab = verify.min_overlap_table_dev("jaccard", tau, l, l, dev)
    prune_tab = verify.prune_table_dev("jaccard", tau, l, l, dev)
    cap = int(opts.get("capacity", js["capacity"]))
    impl = opts.get("join_impl", "auto")
    from repro_torch.kernels import bitmap_filter

    if dev.type == "cuda":
        torch.cuda.synchronize()
    bitmap_filter.candidate_matrix_mxu_cuda.launches = 0
    t0 = time.perf_counter()
    with recording_collectives() as records:
        steps = ring_sweep(tok, length, word, tok, length, word, group=group, index=my,
                           n_dev=n_dev, sim="jaccard", tau=tau, need_tab=need_tab,
                           prune_tab=prune_tab, cutoff=1 << 30, impl=impl, cap=cap,
                           rs_join=False)
        counts = torch.stack([torch.stack([s[2], s[3]]) for s in steps]).sum(0).tolist()
    seconds = time.perf_counter() - t0
    collectives = cost.summarise_collectives(records)
    w = b // 32
    pairs = shard * shard * n_dev
    # Row 1's analytic count: each step reads both shards' words and
    # lengths once and writes a bool a pair; the integer ops a pair.
    step_bytes = 2 * shard * (4 * w + 4) + shard * shard
    costs = cost.Costs(flops=float(pairs * (VERDICT_OPS + 3 * w)),
                       hbm_bytes=float(step_bytes * n_dev),
                       collective_traffic=sum(c.traffic_bytes for c in collectives),
                       collectives=collectives,
                       per_opcode_flops={"candidate_matrix (row 1, int ops)":
                                         float(pairs * (VERDICT_OPS + 3 * w))})
    model_flops = 0.5 * n * n * (w * 4.0)   # the reference's: xor + popcount, N^2 / 2 pairs
    rl = roofline.compute_roofline(arch="bitmap-join", shape=shape, mesh_name=mesh_name,
                                   n_devices=n_dev, costs=costs, model_flops=model_flops,
                                   notes="flops and bytes: row 1's analytic count; the "
                                         "compute term at the bf16 tensor rate")
    arg_bytes = sum(t.numel() * t.element_size() for t in (tok, length, word))
    return {
        "arch": "bitmap-join", "shape": shape, "mesh": mesh_name, "n_devices": n_dev,
        "trace_seconds": seconds, "active_params": 0, "total_params": 0,
        "model_flops": model_flops, "device": str(dev), "shard_rows": shard, "hops": n_dev,
        "candidates": counts[0], "verified": counts[1],
        "row1_launches": bitmap_filter.candidate_matrix_mxu_cuda.launches,
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": None,
                   "temp_size_in_bytes": shard * shard, "peak_bytes": None},
        "hlo": {"flops_per_device": costs.flops, "hbm_bytes_per_device": costs.hbm_bytes,
                "collective_traffic_per_device": costs.collective_traffic,
                "collectives": [dataclasses.asdict(c) for c in collectives[:20]],
                "per_opcode_flops": costs.per_opcode_flops},
        "roofline": rl.as_dict(),
    }


def run_cell(arch: str, shape: str, mesh_name: str, out_dir, opts: Optional[dict] = None,
             tag: str = "") -> dict:
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    try:
        rec.update(lower_cell(arch, shape, mesh_name, opts=opts))
        rec["ok"] = True
        rl, mem = rec["roofline"], rec["memory"]
        print(f"== memory [{arch} {shape} {mesh_name}] == {json.dumps(mem)}")
        print(f"== roofline == t_comp={rl['t_compute'] * 1e3:.3f}ms "
              f"t_mem={rl['t_memory'] * 1e3:.3f}ms t_coll={rl['t_collective'] * 1e3:.3f}ms "
              f"bottleneck={rl['bottleneck']} useful={rl['useful_ratio']:.3f} "
              f"frac={rl['roofline_fraction']:.3f} (trace {rec['trace_seconds']:.1f} s)")
    except SystemExit as e:
        rec["skipped"] = str(e)
        rec["ok"] = True
        print(f"SKIP {arch} {shape} {mesh_name}: {e}")
    except Exception as e:  # noqa: BLE001  (the record says what failed)
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"FAIL {arch} {shape} {mesh_name}: {rec['error']}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=float))
    print("wrote", path)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--triangle", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--join-impl", default="auto")
    ap.add_argument("--optimizer", default="adamw")
    args = ap.parse_args(argv)
    opts = {"microbatches": args.microbatches, "triangle": args.triangle,
            "optimizer": args.optimizer, "seq_parallel": args.seq_parallel,
            "join_impl": args.join_impl}
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape, m) for arch in configs.ARCHS for shape in SHAPES
                 if shape_applicable(configs.get(arch), shape) for m in meshes]
        cells.append(("bitmap-join", "join_1m", meshes[0]))
        return _drive(cells, args)
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if len(meshes) > 1:   # one process group a process: each mesh in a process of its own
        return _drive([(args.arch, args.shape, m) for m in meshes], args)
    rec = run_cell(args.arch, args.shape, meshes[0], args.out, opts=opts, tag=args.tag)
    return 0 if rec["ok"] else 1


def _cell_args(args) -> list:
    out = ["--out", args.out, "--microbatches", str(args.microbatches),
           "--optimizer", args.optimizer, "--join-impl", args.join_impl]
    if args.tag:
        out += ["--tag", args.tag]
    if args.triangle:
        out.append("--triangle")
    if args.seq_parallel:
        out.append("--seq-parallel")
    return out


def _drive(cells, args) -> int:
    """Run cells in subprocesses (a fresh process group each; bounded
    parallelism); a summary counts ok, skipped and failed cells."""
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    procs: list = []
    results = []
    queue = list(cells)
    while queue or procs:
        while queue and len(procs) < args.jobs:
            arch, shape, m = cell = queue.pop(0)
            logf = open(out / f"log_{arch}__{shape}__{m}.txt", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", m] + _cell_args(args)
            procs.append((cell, subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                                 env=_child_env()), logf))
        for entry in list(procs):
            cell, p, logf = entry
            if p.poll() is not None:
                procs.remove(entry)
                logf.close()
                results.append((cell, p.returncode))
                print(f"[{len(results)}/{len(cells)}] {cell} rc={p.returncode}", flush=True)
        time.sleep(0.5)
    skipped, failed = [], []
    for (arch, shape, m), rc in results:
        suffix = f"__{args.tag}" if args.tag else ""
        path = out / f"{arch}__{shape}__{m}{suffix}.json"
        rec = json.loads(path.read_text()) if path.exists() else {"ok": False}
        if rc != 0 or not rec.get("ok"):
            failed.append((arch, shape, m))
        elif "skipped" in rec:
            skipped.append((arch, shape, m))
    n_ok = len(results) - len(skipped) - len(failed)
    print(f"done: {n_ok} cells ok, {len(skipped)} skipped, {len(failed)} failed: {failed}")
    return 1 if failed else 0


def _child_env() -> dict:
    """The children import this package from the same source tree."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [src, env.get("PYTHONPATH")]))
    return env


if __name__ == "__main__":
    sys.exit(main())
