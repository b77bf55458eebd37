"""Markdown report sections of the port (so far the §Serving section of
``ServeSession.report``)."""
from __future__ import annotations


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
