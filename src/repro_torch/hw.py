"""Target-hardware constants (NVIDIA H100 SXM, 80 GB HBM3) for the
bounds the port reports: ``obs.scorecard``'s decode roofline,
``roofline``'s analytic model, ``kernels.plan``'s launch plans and
``chip_smoke.py``'s kernel bounds.

The reference's ``repro/hw.py`` describes a TPU v5e under the same names
where a counterpart exists. ``VMEM_BYTES`` becomes ``SMEM_PER_BLOCK``,
the shared memory one thread block may opt into. The TPU's ``MXU_TILE``
(systolic array width) and ``LANE`` / ``SUBLANE`` (vector lanes, float32
sublanes) have no counterpart and are left out. Its ``ICI_BW`` (one
inter-chip link) becomes two rates, by the links a collective's group
spans (``launch.dryrun``'s collective term):

* ``NVLINK_BW``: NVLink 4 inside one node of ``GPUS_PER_NODE`` H100 SXM
  cards, 450 GB/s a direction per GPU (18 links of 25 GB/s; NVIDIA's
  H100 datasheet gives 900 GB/s bidirectional);
* ``IB_BW``: NDR InfiniBand across nodes, 50 GB/s per GPU (one 400 Gb/s
  ConnectX-7 port a GPU, as a DGX H100 has).

The mapping of mesh ranks to cards (``node_of``): ranks in row-major
order over the mesh's axes ((data, model), or (pod, data, model)), eight
consecutive ranks a node. A ``model`` group of 16 ranks therefore spans
two nodes, and a ``data`` group one rank in each of 16 nodes.

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
NVLINK_BW = 450e9               # bytes/s a direction per GPU, in a node
IB_BW = 50e9                    # bytes/s per GPU across nodes (NDR)
GPUS_PER_NODE = 8               # H100 SXM cards a node (NVLink domain)


def node_of(rank: int) -> int:
    """The node of mesh rank ``rank`` (row-major ranks, eight a node)."""
    return rank // GPUS_PER_NODE


def link_bw(ranks) -> float:
    """The slowest link rate a collective over the global ``ranks`` meets:
    ``NVLINK_BW`` when they share one node, else ``IB_BW``."""
    return NVLINK_BW if len({node_of(r) for r in ranks}) <= 1 else IB_BW
