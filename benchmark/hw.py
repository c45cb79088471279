"""The table of peaks: NVIDIA's data sheet for the H100 SXM, dense rates
without sparsity, at the card's full 700 W limit. A card set below that
limit reads lower shares; the harness prints the limit beside them."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peak(kind: str, what: str) -> float:
    """``what`` of card ``kind``; an unknown card is taken for an H100."""
    return PEAKS.get(kind, PEAKS[DEFAULT])[what]


def roofline_seconds(flops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak(kind, "bf16_flops"),
               nbytes / peak(kind, "hbm_bytes_per_s"))
