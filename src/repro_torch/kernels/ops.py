"""The public kernel entry points of the port.

Five functions, one per ported kernel, and the flash attention's
backward (the TPU side differentiates jnp code there).  Each takes its
kernel for a CUDA tensor (or raises) and its plain version only for a
tensor that lies on the CPU; there is no backend switch.  ``<fn>.launches`` counts kernel
launches.
"""
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                flash_attention_fwd)
from repro_torch.kernels.fused_sampling import fused_sampled_dw
from repro_torch.kernels.gather_scale import gather_scale
from repro_torch.kernels.row_norms import row_norms
from repro_torch.kernels.sampled_matmul import sampled_matmul

__all__ = ["row_norms", "gather_scale", "sampled_matmul", "fused_sampled_dw",
           "flash_attention_fwd", "flash_attention_bwd"]
