"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name`` gives.  NVIDIA's H100 SXM data sheet,
dense rates, at the full 700 W power limit: 3.35 TB/s of HBM3, 67 TFLOP/s
float32 outside the tensor cores.  A roofline share is stated against
these, with the card's power limit beside it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    """The card's peak memory bandwidth, None for a card not in the table."""
    return PEAKS.get(kind, {}).get("hbm_bytes_per_s")
