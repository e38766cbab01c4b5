"""The yardstick's work counts: peaks, model FLOPs, kernels' bounds.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense:
989 TFLOP/s in bf16 (the MFU denominator, as the port's utils/mfu.py has
it) and 3.35 TB/s of HBM3.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
