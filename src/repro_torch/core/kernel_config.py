"""Kernel configuration of the port.

The port has no backend switch: a CUDA tensor always goes through the
hand-written kernel and a CPU tensor through its plain version (see
``repro_torch.kernels.ops``), so the reference's ``backend`` /
``interpret`` fields have no meaning here.  What remains is the tiling
of the sampled-dW kernel: a tile a caller pins, and the reference's
``table_path``, the tuning table measured on the card that chooses an
unpinned one (``repro_torch.kernels.autotune``).  The reference's
``autotune`` switch is absent: the port's table is always read, and a pin
or another ``table_path`` is how a caller steers the tile.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_DW_TILES = (64, 128)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Attributes:
      dw_tile: output tile (64 or 128) of the bf16/f16 ``fused_sampled_dw``
        kernel; beats the tuning table.  ``None`` takes the table's tile
        for the shape, else the shape rule's (128 when that still gives
        every SM a tile, else 64).
      table_path: tuning-table JSON (``None`` = the packaged table,
        ``repro_torch/kernels/tuning_table.json``).
    """

    dw_tile: Optional[int] = None
    table_path: Optional[str] = None

    def __post_init__(self):
        if self.dw_tile is not None and self.dw_tile not in _DW_TILES:
            raise ValueError(f"KernelConfig.dw_tile must be one of "
                             f"{_DW_TILES} or None, got {self.dw_tile!r}")


DEFAULT_KERNEL_CONFIG = KernelConfig()
