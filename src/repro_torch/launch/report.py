"""Markdown report sections of the port: §Run, §Budgets, §Optimizer
memory and §Roofline for ``repro_torch.api.Run.report``, §Serving for
``ServeSession.report``, and the §Dry-run + §Roofline sections over the
dry-run records (``generate``).  Pure string formatting, the reference's
text character for character, but for the hardware (the H100's peak
rates, ``launch/roofline.py``) and the dry run's ``trace s`` where the
reference's has ``compile s``."""
from __future__ import annotations

from typing import List

from repro_torch.launch import roofline


def dryrun_table(rows: List[dict]) -> str:
    hdr = ("| arch | shape | mesh | status | mem/dev GiB | FLOPs/dev | "
           "coll bytes/dev | AG/AR/RS/A2A/CP | trace s |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = []
    for r in rows:
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:70]
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']}: {reason} | | | | | |")
            continue
        c = r["collectives"]["counts"]
        cc = "/".join(str(c.get(k, 0)) for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all", "collective-permute"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r['memory']['peak_per_device_bytes'] / 2**30:.2f} "
            f"| {r['cost']['flops']:.3g} "
            f"| {r['collectives']['total_bytes']:.3g} "
            f"| {cc} | {r.get('trace_s', r.get('compile_s'))} |")
    return hdr + "\n".join(out) + "\n"


def budget_trajectory_table(records: List[dict]) -> str:
    """Markdown table over ``step_fn.budget_trajectory`` records.  Initial
    pins (``prev is None``) render as `init`."""
    hdr = ("| step | rule | pattern | budget | prev |\n"
           "|---|---|---|---|---|\n")
    out = []
    for r in records:
        prev = "init" if r.get("prev") is None else f"{r['prev']:.3g}"
        out.append(f"| {r['step']} | {r['rule']} | `{r['pattern']}` "
                   f"| {r['budget']:.3g} | {prev} |")
    return hdr + "\n".join(out) + ("\n" if out else "")


def budget_report(records: List[dict], n_steps: int,
                  n_compiles: int) -> str:
    """§Budgets section: the controller trajectory of one training run
    plus the re-plan economy (changes vs. steps vs. step functions —
    steady-state steps must reuse a built step)."""
    changes = [r for r in records if r.get("prev") is not None]
    parts = ["## §Budgets\n"]
    parts.append(
        f"{len(changes)} controller re-plans over {n_steps} steps "
        f"({n_compiles} compiled step variants; "
        f"{n_steps - len(changes)} steps reused a cached step).\n")
    if records:
        parts.append(budget_trajectory_table(records))
    else:
        parts.append("No controller-carrying rules (static budgets).\n")
    return "\n".join(parts)


def budget_report_from_step_fn(step_fn, n_steps: int) -> str:
    """Convenience wrapper over a ``make_scheduled_train_step`` result."""
    return budget_report(step_fn.budget_trajectory, n_steps,
                         len(step_fn.compiled))


def rank_trajectory_table(records: List[dict]) -> str:
    """Markdown table over an optimizer-rank trajectory
    (``ScheduleState.rank_trajectory``); initial pins render as `init`."""
    hdr = ("| step | rule | pattern | rank | prev |\n"
           "|---|---|---|---|---|\n")
    out = []
    for r in records:
        prev = "init" if r.get("prev") is None else str(r["prev"])
        out.append(f"| {r['step']} | {r['rule']} | `{r['pattern']}` "
                   f"| {r['rank']} | {prev} |")
    return hdr + "\n".join(out) + ("\n" if out else "")


def optimizer_memory_report(optim_rec: dict,
                            rank_records: List[dict] = None) -> str:
    """§Optimizer memory section: the per-layout state-byte table of an
    optimizer memory record plus the rank trajectory when the run drives
    ranks dynamically."""
    parts = ["## §Optimizer memory\n"]
    parts.append(
        f"{optim_rec['state_bytes'] / 2**20:.2f} MiB optimizer state "
        f"vs {optim_rec['dense_bytes'] / 2**20:.2f} MiB dense AdamW "
        f"(**{optim_rec['ratio']:.2f}x** reduction).\n")
    hdr = ("| layout | leaves | params | state bytes | dense bytes | "
           "ratio |\n|---|---|---|---|---|---|\n")
    rows = []
    for r in optim_rec["rows"]:
        ratio = r["dense_bytes"] / max(r["state_bytes"], 1)
        rows.append(f"| {r['layout']} | {r['leaves']} | {r['params']} "
                    f"| {r['state_bytes']} | {r['dense_bytes']} "
                    f"| {ratio:.2f}x |")
    parts.append(hdr + "\n".join(rows) + "\n")
    if rank_records:
        parts.append(rank_trajectory_table(rank_records))
    return "\n".join(parts)


def run_report(*, n_steps: int, budget_records: List[dict],
               n_compiles: int, history: List[dict] = None,
               roofline_rec: dict = None, optim_rec: dict = None,
               rank_records: List[dict] = None) -> str:
    """One markdown report for a façade run (``repro_torch.api.Run.report``):
    a §Run summary over the metrics history, the §Budgets controller
    trajectory, §Optimizer memory when given an optimizer memory record,
    and — when the run did a dry run — the §Roofline terms of its cell."""
    parts = ["## §Run\n"]
    if history:
        losses = [h["loss"] for h in history if "loss" in h]
        line = f"{n_steps} steps"
        if losses:
            line += (f"; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                     f"(min {min(losses):.4f})")
        parts.append(line + ".\n")
    else:
        parts.append(f"{n_steps} steps (no metrics recorded).\n")
    parts.append(budget_report(budget_records, n_steps, n_compiles))
    if optim_rec is not None:
        parts.append("")
        parts.append(optimizer_memory_report(optim_rec,
                                             rank_records=rank_records))
    if roofline_rec is not None and roofline_rec.get("status") == "ok":
        rt = roofline.roofline_terms(roofline_rec)
        parts.append(
            f"\n## §Roofline\n\n"
            f"{roofline_rec['arch']} x {roofline_rec['shape']} x "
            f"{roofline_rec['mesh']}: compute {rt['compute_s']:.4f}s | "
            f"memory {rt['memory_s']:.4f}s | collective "
            f"{rt['collective_s']:.4f}s; dominant {rt['dominant']}, "
            f"useful-FLOPs {rt['useful_flops_ratio'] * 100:.1f}%, "
            f"roofline fraction {rt['roofline_fraction'] * 100:.1f}%.\n")
    return "\n".join(parts)


def serve_report(spec, stats: dict, pool_bytes: int = None) -> str:
    """§Serving section for one serving session: pool geometry, device
    bytes, and the scheduler counters (``ServeSession.stats``) — the
    occupancy line is the continuous-batching economy at a glance (mean
    fraction of slots doing useful work per decode step)."""
    parts = ["## §Serving\n"]
    parts.append(
        f"{spec.arch}: {spec.max_slots} slots x {spec.pages_per_slot} "
        f"pages x {spec.page_size} tok/page (max_len {spec.max_len}, "
        f"{spec.total_pages - 1} usable pages + scratch, prefill chunk "
        f"{spec.prefill_chunk})"
        + (f"; pool {pool_bytes / 2**20:.1f} MiB on device.\n"
           if pool_bytes is not None else ".\n"))
    n_dec = int(stats.get("decode_steps", 0))
    occ = stats.get("occupancy", 0.0)
    parts.append(
        f"{int(stats.get('admitted', 0))} admitted / "
        f"{int(stats.get('evicted', 0))} completed; "
        f"{int(stats.get('tokens_generated', 0))} tokens over "
        f"{n_dec} decode steps + "
        f"{int(stats.get('prefill_chunks', 0))} prefill chunks; "
        f"mean slot occupancy {occ * 100:.0f}%.\n")
    return "\n".join(parts)


def generate(dryrun_dir: str = "experiments/dryrun") -> str:
    recs = roofline.load_records(dryrun_dir)
    rows = roofline.summarize(dryrun_dir)
    picks = roofline.pick_hillclimb_cells(rows)
    parts = []
    parts.append("## §Dry-run\n")
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    n_err = sum(r["status"] == "error" for r in recs)
    parts.append(
        f"{len(recs)} cells traced, one rank each, on the production meshes "
        f"(16x16 single-pod, 2x16x16 multi-pod): **{n_ok} ok, "
        f"{n_skip} skipped** (long_500k on pure full-attention archs, "
        f"per DESIGN.md §Arch-applicability), {n_err} errors.\n")
    parts.append(dryrun_table(recs))
    parts.append("\n## §Roofline\n")
    parts.append(
        f"Terms per cell (single-pod shown; see JSON for multi-pod): "
        f"compute = FLOPs/dev / {roofline.PEAK_FLOPS:g}, memory = "
        f"bytes/dev / {roofline.HBM_BW:g}, collective = payload-bytes/dev "
        f"/ {roofline.LINK_BW:g}.  FLOPs/bytes are trip-count-aware "
        f"(repro_torch.launch.cost); 'useful FLOPs' = 6·N_active·D / "
        f"counted FLOPs; 'roofline frac' = ideal compute time / "
        f"dominant-term time.\n")
    parts.append(roofline.to_markdown(
        [r for r in rows if r["mesh"] == "single"]))
    parts.append("\nHillclimb cells (per assignment: worst fraction, "
                 "most collective-bound, paper-representative):\n")
    for c in picks:
        parts.append(f"* **{c['arch']} x {c['shape']}** — {c['why']}; "
                     f"dominant={c['dominant']}, "
                     f"fraction={c['roofline_fraction'] * 100:.1f}%")
    return "\n".join(parts)
