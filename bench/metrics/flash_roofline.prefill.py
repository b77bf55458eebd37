"""The attention kernel's share of its roofline: the least seconds of
every attention forward the traced window's calls require
(``costs.prefill_flash_bound``), over the device seconds of the kernels
named ``flash_fwd_*`` (the CUDA kernels of ``flash_attention_fwd``), in
%.  Nothing where no such kernel ran."""
import re

_KERNEL = re.compile(r"\bflash_fwd_\w*kernel")


def read(rec):
    if rec.get("mode") != "prefill" or "trace" not in rec:
        return None
    spent = sum(s for n, s in rec["trace"]["kernel_s"].items()
                if _KERNEL.search(n))
    if spent <= 0:
        return None
    return 100.0 * rec["flash_bound_per_step"] * rec["steps"] / spent
