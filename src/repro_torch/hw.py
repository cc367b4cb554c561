"""Target-hardware constants (NVIDIA H100 SXM, 80 GB HBM3) for the
bounds the port reports: ``obs.scorecard``'s decode roofline,
``roofline``'s analytic model, ``kernels.plan``'s launch plans and
``chip_smoke.py``'s kernel bounds.

The reference's ``repro/hw.py`` describes a TPU v5e under the same names
where a counterpart exists. ``VMEM_BYTES`` becomes ``SMEM_PER_BLOCK``,
the shared memory one thread block may opt into. The TPU's ``MXU_TILE``
(systolic array width), ``LANE`` / ``SUBLANE`` (vector lanes, float32
sublanes) and ``ICI_BW`` (inter-chip link) have no counterpart on one card
and are left out.
The rates are the card's published peaks (dense, no sparsity); a card
set below its 700 W power limit runs slower under load.
"""
NAME = "NVIDIA H100 SXM"        # the card these constants describe
HBM_BW = 3.35e12                # bytes/s of device memory
PEAK_BF16_FLOPS = 989e12        # bf16 on the tensor cores, dense
PEAK_INT8_OPS = 1979e12         # int8 on the tensor cores, dense
PEAK_FP32_FLOPS = 67e12         # float32 outside the tensor cores
HBM_PER_CHIP = 80 * 10**9       # 80 GB of HBM3
SMEM_PER_BLOCK = 227 * 1024     # shared memory one block may opt into
SMS = 132                       # streaming multiprocessors
