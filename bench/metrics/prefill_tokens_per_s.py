"""Prompt tokens prefilled a second: B·S tokens of every call completed
in the window over the window's seconds (host clock)."""


def read(rec):
    if rec.get("mode") != "prefill":
        return None
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
