"""Markdown report sections of the port: §Run, §Budgets and §Optimizer
memory for ``repro_torch.api.Run.report``, §Serving for
``ServeSession.report``.  Pure string formatting, the reference's text
character for character.  The dry-run tables and the §Roofline section
wait for the port's dry run (ROADMAP Queue A.9)."""
from __future__ import annotations

from typing import List


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
    trajectory, and §Optimizer memory when given an optimizer memory
    record.  ``roofline_rec`` must be ``None``: the port has no dry-run
    lowering yet (ROADMAP Queue A.9)."""
    if roofline_rec is not None:
        raise NotImplementedError(
            "the §Roofline section needs the dry-run surface, which is not "
            "ported yet (ROADMAP Queue A.9)")
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
