"""The training step's share of the card's bf16 peak: the flops the
step requires (``costs.train_step_flops``) times the steps of the traced
window, over the traced window's seconds and 989.4 TFLOP/s."""
import costs


def read(rec):
    if rec.get("mode") != "train" or "trace" not in rec:
        return None
    flops = rec["flops_per_step"] * rec["steps"]
    return 100.0 * flops / rec["trace"]["window_s"] / costs.PEAK_FLOPS
