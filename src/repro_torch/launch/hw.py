"""Target hardware model: one NVIDIA H100 SXM5 80 GB (per card).

The port's counterpart of ``repro.launch.hw`` (a TPU v5e there).  The
card the records name is ``NVIDIA H100 80GB HBM3, 700.00 W`` (the name and
power limit ``nvidia-smi`` reports).  Every figure below is NVIDIA's
datasheet peak for that card at its 700 W limit, not a measurement: a card
set to a lower power limit runs slower under load, and no kernel reaches
these rates.
"""
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, dense tf32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
HBM_BYTES = 80e9              # bytes of device memory
NVLINK_BW = 450e9             # bytes/s per direction (NVLink 4, 900 GB/s both ways)
