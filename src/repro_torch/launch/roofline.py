"""Roofline analysis over the dry-run records, against an NVIDIA H100.

Reads the dry run's ``<arch>__<shape>__<mesh>[__tag].json`` records
(``launch/dryrun.py``) and derives, per (arch x shape x mesh):

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

The counts are one rank's (``launch/cost.py``: the rank's program traced
on the ``meta`` device, its collectives recorded), so each term divides
by one card's peak rate.

Hardware model: the H100 SXM5 (80 GB HBM3) at its published figures.
The dominant term approximates the step time; MODEL_FLOPS / FLOPs shows
how much counted compute is "useful" (remat and estimator overhead show
up here).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

# NVIDIA H100 Tensor Core GPU datasheet (SXM5): 989.4 TFLOP/s dense BF16
# tensor-core throughput (1,979 with 2:4 sparsity)
PEAK_FLOPS = 989.4e12        # bf16 / card
# the same datasheet: 3.35 TB/s of HBM3 bandwidth
HBM_BW = 3.35e12             # bytes/s / card
# NVLink 4: 900 GB/s a card in total, 450 GB/s in each direction
LINK_BW = 450e9              # bytes/s / card, one direction

CHIPS = {"single": 256, "multi": 512}


def load_records(dryrun_dir: str, tag: Optional[str] = None) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        stem = os.path.basename(path)[:-5]
        parts = stem.split("__")
        rec_tag = parts[3] if len(parts) > 3 else ""
        if (tag or "") != rec_tag:
            continue
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def model_flops(rec: Dict) -> float:
    """6*N*D for training (N = active params, D = tokens); forward-only
    (prefill) is 2*N*D; decode is 2*N per token * batch."""
    n = rec.get("n_active_params", 0)
    kind = rec.get("kind")
    if kind == "train":
        d = rec["seq_len"] * rec["global_batch"]
        return 6.0 * n * d
    if kind == "prefill":
        d = rec["seq_len"] * rec["global_batch"]
        return 2.0 * n * d
    return 2.0 * n * rec["global_batch"]      # one decoded token / sample


def roofline_terms(rec: Dict) -> Dict:
    chips = CHIPS[rec["mesh"]]
    flops = rec["cost"]["flops"]
    # the counts are one rank's program: flops and bytes_accessed per
    # card, collective bytes the rank's payloads (≈ bytes over the wire
    # per card, the right quantity for a ring schedule), so the terms
    # divide by one card's peak rates
    t_compute = flops / PEAK_FLOPS
    t_memory = rec["cost"]["bytes_accessed"] / HBM_BW
    t_coll = rec["collectives"]["total_bytes"] / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec)
    useful = mf / (flops * chips) if flops else 0.0
    bound = max(terms.values())
    ideal = mf / (chips * PEAK_FLOPS)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "model_flops": mf,
        "useful_flops_ratio": useful,
        "roofline_fraction": (ideal / bound) if bound else 0.0,
        "step_time_bound_s": bound,
    }


def summarize(dryrun_dir: str, tag: Optional[str] = None) -> List[Dict]:
    out = []
    for rec in load_records(dryrun_dir, tag):
        if rec.get("status") != "ok":
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "status": rec["status"],
                        "reason": rec.get("reason", rec.get("error",
                                                            ""))[:90]})
            continue
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec["mesh"], "status": "ok",
               "mem_gib": rec["memory"]["peak_per_device_bytes"] / 2 ** 30}
        row.update(roofline_terms(rec))
        out.append(row)
    return out


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful FLOPs | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    body = []
    for r in rows:
        if r["status"] != "ok":
            body.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"SKIPPED ({r['reason'][:60]}) | | | | | |")
            continue
        body.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['dominant']} "
            f"| {r['useful_flops_ratio'] * 100:.1f}% "
            f"| {r['roofline_fraction'] * 100:.1f}% |")
    return hdr + "\n".join(body) + "\n"


def pick_hillclimb_cells(rows: List[Dict]) -> List[Dict]:
    """worst roofline fraction / most collective-bound / most
    representative of the paper (largest train cell)."""
    ok = [r for r in rows if r["status"] == "ok" and r["mesh"] == "single"]
    worst = min(ok, key=lambda r: r["roofline_fraction"])
    coll = max(ok, key=lambda r: r["collective_s"]
               / max(r["step_time_bound_s"], 1e-12))
    train = [r for r in ok if r["shape"] == "train_4k"]
    rep = max(train, key=lambda r: r["model_flops"])
    uniq, out = set(), []
    for r, why in ((worst, "worst roofline fraction"),
                   (coll, "most collective-bound"),
                   (rep, "paper-representative (largest train cell)")):
        key = (r["arch"], r["shape"])
        if key not in uniq:
            uniq.add(key)
            out.append({**r, "why": why})
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    rows = summarize(args.dir, args.tag)
    print(to_markdown(rows))
    print("\nHillclimb candidates:")
    for c in pick_hillclimb_cells(rows):
        print(f"  {c['arch']} x {c['shape']} ({c['why']}), "
              f"dominant={c['dominant']}, "
              f"frac={c['roofline_fraction'] * 100:.1f}%")
