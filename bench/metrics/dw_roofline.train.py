"""The sampled weight gradients' share of their roofline: the least
seconds of every sampled dW product the traced window's steps require
(``costs.step_dw_bound``, from the cell's shapes and k), over the device
seconds of the kernels named ``fused_dw_*`` (the CUDA kernels of
``fused_sampled_dw``), in %.  Nothing where no such kernel ran."""
import re

_KERNEL = re.compile(r"\bfused_dw_\w*kernel")


def read(rec):
    if rec.get("mode") != "train" or "trace" not in rec:
        return None
    spent = sum(s for n, s in rec["trace"]["kernel_s"].items()
                if _KERNEL.search(n))
    if spent <= 0 or not rec.get("dw_bound_per_step"):
        return None
    return 100.0 * rec["dw_bound_per_step"] * rec["steps"] / spent
