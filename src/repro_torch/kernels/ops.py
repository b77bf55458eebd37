"""The public kernel entry points of the port.

Three functions, one per ported kernel.  Each takes its kernel for a CUDA
tensor (or raises) and its plain version only for a tensor that lies on
the CPU; there is no backend switch.  ``<fn>.launches`` counts kernel
launches.
"""
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.fused_sampling import fused_sampled_dw
from repro_torch.kernels.row_norms import row_norms

__all__ = ["row_norms", "fused_sampled_dw", "flash_attention_fwd"]
