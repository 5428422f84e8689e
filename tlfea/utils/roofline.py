"""Published peak rates of the accelerators this repo measures on.

A roofline share is a time over the least time the device could take, so it
is only as right as the peak it divides by. The table is keyed by the exact
`device_kind` string JAX reports; a device that is not in it is an error,
never a default.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
without sparsity, at the full 700 W power limit. A card set below that limit
cannot hold its top clock under load, so report the card's power limit
(`nvidia-smi --query-gpu=power.limit`) beside any share computed from these.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["ChipPeaks", "CHIP_PEAKS", "chip_peaks"]


class ChipPeaks(NamedTuple):
    hbm_bytes_per_s: float
    bf16_flops: float  # tensor cores
    tf32_flops: float  # tensor cores
    fp32_flops: float  # CUDA cores, outside the tensor cores
    fp64_flops: float  # CUDA cores, outside the tensor cores
    source: str


_H100_SXM = ChipPeaks(
    hbm_bytes_per_s=3.35e12,
    bf16_flops=989e12,
    tf32_flops=495e12,
    fp32_flops=67e12,
    fp64_flops=34e12,
    source="NVIDIA H100 data sheet, SXM5, dense",
)

CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def chip_peaks(device_kind: str | None = None) -> ChipPeaks:
    """Peaks of `device_kind` (default: JAX's first device)."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return CHIP_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add them to "
            f"tlfea.utils.roofline.CHIP_PEAKS with their source"
        ) from None
