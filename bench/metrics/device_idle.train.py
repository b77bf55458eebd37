"""The card's idle share in a train cell's traced window: one less the
union of the intervals in which a kernel, copy or set ran on the card,
over the window's length, in %."""


def read(rec):
    if rec.get("mode") != "train" or "trace" not in rec:
        return None
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
