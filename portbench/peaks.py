#
# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W,
# dense rates): the yardstick of every utilization and roofline share.
#

FP32_FLOPS = 67e12       # float32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
