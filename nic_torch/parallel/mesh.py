"""The ('data', 'pixel') device mesh over ``torch.distributed`` (port of
``nic.parallel.mesh``).

The JAX package builds the mesh over the devices of one process and lets
the SPMD partitioner insert the collectives. Here each rank is a process
of its own, started by ``torchrun`` or by :func:`run_ranks`: every rank
holds the replicated params, computes its shard of the step and calls the
collectives itself (one all-reduce of the gradients a step).

- Ranks lie on the mesh row-major, as JAX's devices: rank r is data index
  r // pixel and pixel index r % pixel.
- Rank → device: rank r runs on ``cuda:(LOCAL_RANK mod device_count)``
  on a card and on the CPU otherwise.
- Backend: ``nccl`` when every rank of the host has a card of its own
  (LOCAL_WORLD_SIZE ≤ device_count); ``gloo`` when ranks share a card, as
  two ranks on one H100 do (NCCL refuses two ranks on one device), and on
  the CPU. The rule decides; nothing falls back after a failed init.

``init_from_env`` returns no mesh without a launcher, as ``make_mesh()``
over one visible device gives the JAX trainers a one-device program.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "init_from_env", "backend_for",
           "rank_device", "shard_rows", "replicate_", "pmean_", "psum_",
           "all_gather_rows", "load_kernels", "params_digest",
           "check_replicated", "run_ranks"]


def backend_for(device_type: str, local_world_size: int,
                device_count: int) -> str:
    """The process group's backend: ``nccl`` when each rank of the host
    has a card of its own, else ``gloo`` (ranks sharing a card, or the
    CPU)."""
    if device_type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int,
                device_count: int) -> torch.device:
    """``cuda:(local_rank mod device_count)`` on a card, else the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_count < 1:
        raise RuntimeError("device cuda: no CUDA device is available")
    return torch.device("cuda", local_rank % device_count)


@dataclass
class Mesh:
    """This rank's place on a ('data', 'pixel') mesh of ``data·pixel``
    ranks, its device, and the process group of its 'data' axis."""

    data: int
    pixel: int
    rank: int
    device: torch.device
    backend: str
    data_group: object = field(default=None, repr=False)

    @property
    def world_size(self) -> int:
        return self.data * self.pixel

    @property
    def data_index(self) -> int:
        return self.rank // self.pixel

    @property
    def pixel_index(self) -> int:
        return self.rank % self.pixel

    @property
    def shape(self) -> dict:
        return {"data": self.data, "pixel": self.pixel}

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes files."""
        return self.rank == 0

    def group(self, axis: str | None):
        """The process group that reduces over ``axis`` ("data": the ranks
        of this pixel index; None: every rank)."""
        if axis not in ("data", None):
            raise ValueError(f"reduce over data or every rank, not {axis!r}")
        return self.data_group if axis == "data" else None

    def axis_size(self, axis: str | None) -> int:
        return self.data if axis == "data" else self.world_size

    def barrier(self) -> None:
        dist.barrier()

    def __str__(self) -> str:
        return (f"rank {self.rank} of {self.world_size} on {self.device} "
                f"(data {self.data_index} of {self.data}, pixel "
                f"{self.pixel_index} of {self.pixel}), backend "
                f"{self.backend}")


def make_mesh(n_devices: int | None = None, data_axis: int | None = None, *,
              device=None) -> Mesh:
    """This rank's place on a (data, pixel) mesh over the initialized
    process group: one rank a device, so ``n_devices`` (default all) must
    be the world size. ``data_axis`` (default all) must divide it; the
    pixel axis takes the rest. ``device`` defaults to the current CUDA
    device and raises without a card: the CPU is asked for by name.
    Every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_from_env, run_ranks or torchrun)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices over {n} ranks: "
                         "one rank runs one device")
    d = data_axis if data_axis is not None else n
    if d < 1 or n % d:
        raise ValueError(f"data axis {d} does not divide device count {n}")
    p = n // d
    rank = dist.get_rank()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
    data_group = None
    # every rank creates every data group, in one order (torch.distributed's
    # rule for new_group)
    for j in range(p):
        ranks = [i * p + j for i in range(d)]
        g = dist.new_group(ranks)
        if rank in ranks:
            data_group = g
    return Mesh(data=d, pixel=p, rank=rank, device=torch.device(device),
                backend=dist.get_backend(), data_group=data_group)


def init_from_env(device="cuda", *, rank: int | None = None,
                  world_size: int | None = None,
                  local_rank: int | None = None,
                  local_world_size: int | None = None,
                  init_method: str | None = None,
                  data_axis: int | None = None, log=print) -> Mesh | None:
    """Join the process group and return this rank's :class:`Mesh`. The
    ranks come from the arguments (a spawn) or from torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; without them
    there is no mesh (None). Sets the rank's CUDA device before any
    launch (the kernels launch on the current stream) and prints the rank
    → device mapping and the backend."""
    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device}")
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return None
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size))
        init_method = init_method or "env://"
    if world_size is None or init_method is None:
        raise ValueError("a spawned rank needs world_size and init_method")
    local_rank = rank if local_rank is None else local_rank
    local_world_size = (world_size if local_world_size is None
                        else local_world_size)
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available (pass "
                           "the CPU device to run the ranks on the CPU)")
    dev = rank_device(device_type, local_rank, count)
    backend = backend_for(device_type, local_world_size, count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size, **kw)
    mesh = make_mesh(data_axis=data_axis, device=dev)
    share = (f", {local_world_size} ranks share {count} card(s)"
             if dev.type == "cuda" and local_world_size > count else "")
    log(f"mesh: {mesh}{share}")
    return mesh


# ---- sharding and collectives --------------------------------------------

def shard_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis over 'data'
    (the whole of ``x`` without a mesh)."""
    if mesh is None:
        return x
    if x.shape[0] % mesh.data:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.data} "
                         "data ranks")
    rows = x.shape[0] // mesh.data
    return x[mesh.data_index * rows:(mesh.data_index + 1) * rows]


def _reduce_(tensors, mesh: Mesh, axis, scale) -> None:
    """One all-reduce (sum) of ``tensors`` over the axis's group, in place,
    each then multiplied by ``scale``; one flat buffer per dtype."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    tensors = [t for t in tensors if t is not None]
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.all_reduce(flat, group=mesh.group(axis))
        if scale != 1:
            flat.mul_(scale)
        for t, r in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(r)


def psum_(tensors, mesh: Mesh, axis: str | None = None) -> None:
    """Sum ``tensors`` over the mesh ``axis`` (None: every rank), in
    place."""
    _reduce_(tensors, mesh, axis, 1)


def pmean_(tensors, mesh: Mesh, axis: str | None = "data") -> None:
    """Mean of ``tensors`` over the mesh ``axis`` (JAX's ``pmean``; None:
    every rank), in place: every rank gets the same reduced bytes."""
    _reduce_(tensors, mesh, axis, 1.0 / mesh.axis_size(axis))


def replicate_(params, mesh: Mesh | None) -> None:
    """Broadcast a module's parameters (or a list of tensors) from rank 0
    to every rank, in place: the replicated state JAX's ``replicate``
    places."""
    if mesh is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    with torch.no_grad():
        flat = _flatten_dense_tensors([t.detach() for t in params])
        dist.broadcast(flat, src=0)
        for t, r in zip(params, _unflatten_dense_tensors(flat, params)):
            t.copy_(r)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal-sized ``x``, concatenated along the leading axis
    in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def load_kernels(mesh: Mesh | None, rans: bool = False) -> None:
    """Build the CUDA kernel library (on a card) and, with ``rans``, the
    host rANS coder once: rank 0 builds them (one nvcc a source, g++),
    the others wait at a barrier and then load the files."""
    from nic_torch import native
    from nic_torch.kernels import _build

    loads = ([_build.load] if mesh and mesh.device.type == "cuda" else []
             ) + ([native.load] if mesh and rans else [])
    if not loads:
        return
    if mesh.is_main:
        for load in loads:
            load()
    mesh.barrier()
    for load in loads:
        load()


def params_digest(tensors) -> str:
    """SHA-256 (16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def check_replicated(tensors, mesh: Mesh | None) -> str:
    """The tensors' digest; raises unless every rank holds the same
    bytes."""
    digest = params_digest(tensors)
    if mesh is None:
        return digest
    digests = [None] * mesh.world_size
    dist.all_gather_object(digests, digest)
    if len(set(digests)) != 1:
        raise RuntimeError(f"replicated params differ across ranks: "
                           f"{digests}")
    return digest


# ---- spawning the ranks of one program -----------------------------------

def _rank_main(rank: int, fn, world_size: int, device: str, workdir: str,
               data_axis, threads, args) -> None:
    if threads:
        torch.set_num_threads(threads)
    mesh = init_from_env(device, rank=rank, world_size=world_size,
                         init_method=f"file://{workdir}/rdv",
                         data_axis=data_axis)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device: str,
              data_axis: int | None = None, workdir: str | None = None,
              threads: int | None = None) -> list:
    """``fn(mesh, *args)`` on ``world_size`` spawned ranks of one process
    group (rendezvous through a file in ``workdir``, a new temporary
    directory by default); returns each rank's result, in rank order.
    ``device`` (``cuda`` or ``cpu``, named by every caller) is the ranks'
    device type; ``cuda`` without a card raises before any rank starts.
    ``fn`` is a module-level function (it is pickled by name); its result
    travels through ``torch.save``. ``threads`` sets each rank's torch
    threads (CPU ranks)."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available (pass "
                           "device='cpu' to run the ranks on the CPU)")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(_rank_main, args=(fn, world_size, device, tmp,
                                             data_axis, threads, args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
