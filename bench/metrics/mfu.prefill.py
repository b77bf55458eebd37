"""The prefill call's share of the card's bf16 peak: the flops a call
requires (``costs.prefill_flops``) times the calls of the traced window,
over the traced window's seconds and 989.4 TFLOP/s."""
import costs


def read(rec):
    if rec.get("mode") != "prefill" or "trace" not in rec:
        return None
    flops = rec["flops_per_step"] * rec["steps"]
    return 100.0 * flops / rec["trace"]["window_s"] / costs.PEAK_FLOPS
