"""Training tokens a second: B·S tokens of every step completed in the
window over the window's seconds (host clock, from the first timed
step's issue to the synchronise that ends the window)."""


def read(rec):
    if rec.get("mode") != "train":
        return None
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
