"""Production mesh construction, as in the reference
``repro/launch/mesh.py``, over ``torch.distributed.device_mesh``.

Meshes are built by FUNCTIONS (never at import), and a ``DeviceMesh``
has one rank per device: a mesh of N devices needs a process group of N
ranks, which the caller starts (``torch.distributed.init_process_group``
with its address, world size and rank). :func:`make_local_mesh` is the
exception: with no group in the process it starts a single-rank one in
process (a ``HashStore``: no ``MASTER_ADDR``, no ``torchrun``).
"""
from __future__ import annotations

import math

from repro_torch import resolve_device

# NVIDIA H100 SXM constants (per chip) for the roofline analysis, from
# NVIDIA's "H100 Tensor Core GPU" data sheet (dense, no sparsity).
PEAK_FLOPS_BF16 = 989e12       # FLOP/s
HBM_BW = 3.35e12               # B/s
# NVLink 4: 900 GB/s per GPU over 18 links, i.e. 50 GB/s per link counting
# both directions (25 GB/s each way).
NVLINK_BW = 50e9               # B/s per link, both directions
ICI_BW = NVLINK_BW             # the reference's name for the per-link rate

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16 x 16 (``data``, ``model``) mesh, or 2 x 16 x 16 (``pod``,
    ``data``, ``model``), over the process group the caller started (256
    or 512 ranks, one device each)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of "
                           f"{math.prod(shape)} ranks: start it first")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(device="cuda"):
    """(n, 1) mesh over the local devices, axes (``data``, ``model``): n
    is the process group's world size (one device a rank). With no group
    in the process, a single-rank one is started here (NCCL on the card,
    gloo on the CPU), so n = 1 on one card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (n, 1),
                            mesh_dim_names=("data", "model"))


def num_chips(mesh) -> int:
    """Devices in a ``DeviceMesh`` or an ``AbstractMesh``."""
    from repro_torch.sharding.rules import mesh_shape
    return math.prod(mesh_shape(mesh).values())
