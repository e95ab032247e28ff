"""The dry run's tables from its JSON cells (the port of
``repro.launch.report``):

    python -m repro_torch.launch.report [DIR]     # default: dryrun_out/

One roofline table and one memory table a mesh, then the hill-climbing
candidates.  The memory column asks whether a rank's peak (arguments and
temporaries, ``launch/cost.py``'s estimate) fits the H100's 80 GB
(``launch/roofline.py``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List

from repro_torch.launch import roofline

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"


def load(out_dir) -> List[dict]:
    return [json.loads(p.read_text()) for p in sorted(Path(out_dir).glob("*.json"))]


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}GiB"


def roofline_table(recs: List[dict], mesh: str) -> str:
    head = ("| arch | shape | per-dev FLOPs | per-dev HBM B | coll B | "
            "t_comp | t_mem | t_coll | bound | bottleneck | 6ND/HLO | frac |")
    rows = []
    for r in recs:
        if r.get("mesh") != mesh or not r.get("ok") or "roofline" not in r:
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['flops_per_device']:.2e} | "
            f"{rl['hbm_bytes_per_device']:.2e} | {rl['collective_bytes_per_device']:.2e} | "
            f"{rl['t_compute'] * 1e3:.1f}ms | {rl['t_memory'] * 1e3:.1f}ms | "
            f"{rl['t_collective'] * 1e3:.1f}ms | {rl['step_time_bound'] * 1e3:.1f}ms | "
            f"{rl['bottleneck']} | {rl['useful_ratio']:.3f} | {rl['roofline_fraction']:.3f} |")
    out = [head, "|" + "---|" * 12] + rows
    skips = [r for r in recs if r.get("mesh") == mesh and "skipped" in r]
    if skips:
        out.append("")
        out += [f"- SKIP {r['arch']} x {r['shape']}: {r['skipped']}" for r in skips]
    fails = [r for r in recs if r.get("mesh") == mesh and not r.get("ok")]
    out += [f"- FAIL {r['arch']} x {r['shape']}: {r.get('error')}" for r in fails]
    return "\n".join(out)


def memory_table(recs: List[dict], mesh: str) -> str:
    gb = roofline.H100_SXM.memory_bytes / 1e9
    head = f"| arch | shape | args/dev | temp/dev | fits {gb:.0f} GB H100? | trace_s |"
    rows = []
    for r in recs:
        if r.get("mesh") != mesh or not r.get("ok") or "memory" not in r:
            continue
        m = r["memory"]
        args = m.get("argument_size_in_bytes") or 0
        temp = m.get("temp_size_in_bytes") or 0
        rows.append(f"| {r['arch']} | {r['shape']} | {fmt_bytes(args)} | {fmt_bytes(temp)} | "
                    f"{'yes' if roofline.fits(args + temp) else 'NO'} | "
                    f"{r.get('trace_seconds', 0):.1f} |")
    return "\n".join([head, "|" + "---|" * 6] + rows)


def pick_hillclimb(recs: List[dict]) -> List[str]:
    singles = [r for r in recs if r.get("mesh") == "single" and r.get("ok") and "roofline" in r
               and r["arch"] != "bitmap-join"]
    if not singles:
        return []
    worst = min(singles, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(singles, key=lambda r: r["roofline"]["t_collective"]
               / max(r["roofline"]["step_time_bound"], 1e-12))
    share = coll["roofline"]["t_collective"] / max(coll["roofline"]["step_time_bound"], 1e-12)
    return [f"worst roofline fraction: {worst['arch']} x {worst['shape']} "
            f"(frac={worst['roofline']['roofline_fraction']:.4f})",
            f"most collective-bound: {coll['arch']} x {coll['shape']} "
            f"(t_coll share={share:.2f})",
            "paper-representative: bitmap-join x join_1m (the paper's own workload)"]


def render(recs: List[dict]) -> str:
    out = []
    for mesh in ("single", "multi"):
        n_ok = sum(1 for r in recs if r.get("mesh") == mesh and r.get("ok"))
        out += [f"\n### Roofline — {mesh} mesh ({n_ok} cells)\n", roofline_table(recs, mesh),
                f"\n### Memory — {mesh} mesh\n", memory_table(recs, mesh)]
    out.append("\n### Hillclimb candidates\n")
    out += [f"- {line}" for line in pick_hillclimb(recs)]
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(render(load(argv[0] if argv else RESULTS_DIR)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
