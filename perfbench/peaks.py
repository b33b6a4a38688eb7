"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), against which a roofline share is stated."""

PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_F32_FLOP_S = 67e12  # float32 outside the tensor cores
