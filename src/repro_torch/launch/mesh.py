"""Production mesh definition (the multi-pod dry run's contract) and the
hardware constants of the roofline: the port's copy of
``repro.launch.mesh``.

FUNCTIONS, not module constants, so importing this module never touches
the process group.  Single pod: (data=16, model=16) = 256 ranks; multi-pod:
(pod=2, data=16, model=16) = 512 ranks.  A mesh needs a process group of
its size: the dry run starts a fake one (``launch.dryrun``), training a
real one (gloo or NCCL).

The roofline's denominators are one NVIDIA H100 SXM 80GB's
(:class:`Hardware`), where the reference's were a TPU's.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-rank roofline denominators.  The defaults are one H100 SXM 80GB
    at its 700 W limit, from NVIDIA's data sheets."""
    name: str = "H100 SXM 80GB"
    #: dense bf16 tensor-core FLOP/s without sparsity (H100 data sheet:
    #: 1,979 TFLOPS with sparsity, half of it dense)
    peak_flops_bf16: float = 989.4e12
    #: HBM3 bandwidth, B/s (H100 data sheet: 3.35 TB/s)
    hbm_bw: float = 3.35e12
    #: HBM capacity, bytes (H100 data sheet: 80 GB)
    hbm_bytes: float = 80e9
    #: the slowest link the 16-wide model axis crosses, B/s a rank: 8 ranks
    #: share an NVLink node (900 GB/s, H100 data sheet), the other 8 sit
    #: across InfiniBand, one ConnectX-7 400 Gb/s port a GPU (DGX H100 data
    #: sheet)
    link_bw: float = 50e9


H100 = Hardware()


def _device_type() -> str:
    """The mesh's device type: cuda under NCCL, else cpu (gloo, fake)."""
    return "cuda" if dist.is_initialized() and \
        dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh over the default process group, whose world size must
    be the product of ``shape``."""
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)
