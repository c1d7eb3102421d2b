"""Production meshes, the devices a cell runs on, and the card's
constants for the roofline (the counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's
shapes and axis names: ``single_pod`` (16, 16) as ("data", "model"),
``multi_pod`` (2, 16, 16) as ("pod", "data", "model") and ``host``
(1, 1).  Ranks are laid out row-major, the model axis innermost: rank
``r`` of ``single_pod`` is data ``r // 16``, model ``r % 16``.  On H100
nodes of 8 cards joined by NVLink, a model group (16 consecutive ranks)
spans two nodes, and a data or pod group one card of each of 16 (or 2)
nodes, so on both production meshes every axis crosses a node; only a
group of at most 8 consecutive ranks inside one node (the card meshes
of the tests and the smoke run) stays on NVLink.  ``link_bw`` gives a
group's rate by that rule.

A mesh needs a process group of its size first: ``process_group`` brings
one up and tears it down, over the in-process ``fake`` backend (the dry
run: one process stands for every rank, collectives move nothing, and
tensors live on ``meta``), ``gloo`` (CPU ranks, through a ``FileStore``,
never a fixed TCP port) or ``nccl`` (the card).  ``device_by_name``
names the one-device placements the port also runs on.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, without sparsity, at the 700 W power limit; a card set below it
runs slower under load).
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores, bf16 and fp16
PEAK_FLOPS_TF32 = 495e12          # FLOP/s, tensor cores, TF32
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, CUDA cores, float32
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # B of device memory
# the link rates a collective's group moves its bytes at, per card and
# direction (the reference's ICI_BW_PER_LINK): NVLink 4 inside one
# 8-card HGX H100 node (18 links, 900 GB/s both ways), and one 400 Gb/s
# ConnectX-7 NDR InfiniBand NIC per GPU across nodes (NVIDIA DGX H100
# data sheet)
NVLINK_BW = 450e9                 # B/s
NIC_BW = 50e9                     # B/s
CARDS_PER_NODE = 8

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model"))}


def link_bw(ranks) -> float:
    """The rate a collective over ``ranks`` moves at: NVLink when all of
    them sit in one node of ``CARDS_PER_NODE`` consecutive ranks, else
    the NIC."""
    return NVLINK_BW if len({r // CARDS_PER_NODE for r in ranks}) <= 1 \
        else NIC_BW


def _fake_store():
    # the one import of PyTorch's private in-process backend: it
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0,
                  store_file: Optional[str] = None):
    """Bring up this process's group and tear it down on exit.

    ``fake``: one process stands for all ``world_size`` ranks (as rank
    ``rank``), for meshes traced on ``meta``.  ``gloo``/``nccl``: real
    ranks meeting at ``store_file`` (a path every rank of the group is
    given; without one, a fresh file in a temporary directory, which
    suits a group of one).  ``nccl`` needs a card per rank and raises
    without one."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device")
    with contextlib.ExitStack() as stack:
        if backend == "fake":
            store = _fake_store()
        elif backend in ("gloo", "nccl"):
            if store_file is None:
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                store_file = os.path.join(tmp, "store")
            store = dist.FileStore(store_file, world_size)
            if backend == "nccl":
                torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            raise ValueError(f"unknown backend {backend!r}")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
        try:
            yield
        finally:
            dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cpu") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the process group that is up
    (its size must be ``prod(shape)``), named ``axes``."""
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    return make_mesh(*MESHES["multi_pod" if multi_pod else "single_pod"],
                     device_type=device_type)


def make_host_mesh(device_type: str = "cpu") -> DeviceMesh:
    """Single-device mesh for smoke tests and benchmarks."""
    return make_mesh(*MESHES["host"], device_type=device_type)


def make_mesh_by_name(name: str, device_type: str = "cpu") -> DeviceMesh:
    if name in ("single_pod", "multi_pod"):
        return make_production_mesh(multi_pod=name == "multi_pod",
                                    device_type=device_type)
    if name == "host":
        return make_host_mesh(device_type)
    raise ValueError(f"unknown mesh {name!r}")


def tensor_device(mesh: DeviceMesh) -> torch.device:
    """Where a mesh's tensors live: ``meta`` over the ``fake`` backend
    (nothing is stored, collectives move nothing), else the mesh's own
    device type (this rank's card for ``cuda``)."""
    if dist.get_backend() == "fake":
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def chips(mesh) -> int:
    return mesh.size()


def mesh_desc(mesh) -> str:
    """"2x2:data,model": the reference's ``mesh_desc``."""
    return "x".join(str(s) for s in mesh.shape) + ":" \
        + ",".join(mesh.mesh_dim_names)


def device_by_name(name: str) -> torch.device:
    """"card" (the first CUDA device; raises without one), "host" (the
    CPU) or "meta" (shapes and dtypes only: the dry run)."""
    if name == "card":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; use the host or "
                               "meta device")
        return torch.device("cuda", 0)
    if name == "host":
        return torch.device("cpu")
    if name == "meta":
        return torch.device("meta")
    raise ValueError(f"unknown device {name!r}")
