"""Production mesh construction for an H100 cluster.

The reference's axis names, laid out for HGX nodes of 8 GPUs joined by
NVLink, the nodes joined by InfiniBand.  Single pod: 32 x 8 = 256 GPUs
(``data`` x ``model``, mesh ``h100x32x8``), the reference's 256 chips.
Multi-pod: 2 x 16 x 8 = 256 GPUs with a leading ``pod`` axis
(``h100x2x16x8``); the reference's 2 x 16 x 16 holds 512 v5e chips, and
with its ``data`` axis of 16 kept, the 8-wide ``model`` axis halves that.
The ``model`` axis is the innermost: its groups are the 8 consecutive ranks
of one node, so every tensor-parallel collective stays on NVLink.  The
reference's 16-wide ``model`` axis is a ring of the TPU v5e torus; here it
would span two nodes, and every tensor-parallel collective would cross
InfiniBand.

Functions, not module constants, so that importing this module starts no
process group: the meshes span the started world (``torch.distributed``'s
default group, one rank per GPU; the dry run starts a fake one).
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (80 GB HBM3) data sheet: the roofline's denominators
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per GPU, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s per GPU, HBM3
NVLINK_BW = 450e9               # bytes/s per GPU per direction, NVLink 4 (900 GB/s both ways)
IB_BW = 50e9                    # bytes/s per GPU across nodes, one NDR 400 Gb/s port
GPUS_PER_NODE = 8               # an HGX H100 node: 8 GPUs on NVLink switches

PRODUCTION_MESHES = {
    False: ("h100x32x8", (32, 8), ("data", "model")),
    True: ("h100x2x16x8", (2, 16, 8), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production ``DeviceMesh`` over the started world of 256 ranks;
    ``device`` is the ranks' device type."""
    _, shape, axes = PRODUCTION_MESHES[multi_pod]
    return make_test_mesh(shape=shape, axes=axes, device=device)


def make_test_mesh(*, shape=(2, 2), axes=("data", "model"), device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the started world (whose size must
    be the product of ``shape``), axes named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(str(device), tuple(shape), mesh_dim_names=tuple(axes))
