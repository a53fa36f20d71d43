"""Device meshes, block shardings and a launcher of ranks (port of
``occlusionfusion_tpu/parallel/mesh.py``).

The JAX package builds a ``('data',)`` or ``('data', 'space')`` mesh over
its devices and lets XLA insert the collectives from sharding
annotations. Here every rank is a process: ``make_fusion_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` with the same dimension
names over the initialised process group, and a sharding is the rank's
block of a tensor's leading axis (``data_sharding``, ``volume_sharding``)
or the whole tensor (``replicated``). Blocks follow JAX's
``NamedSharding(P(axis))`` order: the rank at coordinate d of the axis
holds rows ``[d P / n, (d + 1) P / n)``.

``launch(fn, world_size, ...)`` runs a module-level function on
``world_size`` ranks (spawned processes, one process group over TCP on
127.0.0.1) and returns each rank's result. Backends: ``nccl`` for
``cuda`` and ``gloo`` for ``cpu`` unless the caller names one; gloo
with CUDA tensors puts several ranks on one card (its all-reduce takes
CUDA tensors, its send, receive and all-gather do not: ``gather_blocks``
and the time ring stage through the host there).
"""

from __future__ import annotations

import datetime
import pickle
import queue
import socket
import time

import torch
import torch.distributed as dist

DEFAULT_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def default_backend(device) -> str:
    return DEFAULT_BACKENDS[torch.device(device).type]


def _check_backend(backend: str) -> None:
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the nccl backend is not available in this torch")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("the gloo backend is not available in this torch")


def make_fusion_mesh(n_devices: int | None = None, space: int = 1,
                     device=None, backend: str | None = None):
    """A ``("data",)`` mesh, or ``("data", "space")`` with ``space`` > 1,
    over the first ``n_devices`` ranks (all by default) of the
    initialised process group, on ``device``'s type (the card unless
    ``cpu``). Where no group is initialised yet, one is initialised from
    the ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``
    environment with ``backend`` (``default_backend(device)`` if None);
    a named backend that differs from the group's raises."""
    from torch.distributed.device_mesh import DeviceMesh

    from occlusionfusion_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    want = backend or default_backend(dev)
    _check_backend(want)
    if not dist.is_initialized():
        dist.init_process_group(want)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f"{n} devices asked of a group of "
                         f"{dist.get_world_size()} ranks")
    ranks = torch.arange(n)
    if space > 1:
        if n % space:
            raise ValueError(f"{n} ranks do not split into space {space}")
        return DeviceMesh(dev.type, ranks.reshape(n // space, space),
                          mesh_dim_names=("data", "space"))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data",))


def axis_size(mesh, axis: str = "data") -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str = "data") -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def shard_rows(mesh, x: torch.Tensor, axis: str = "data",
               dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the mesh axis (a
    view). Raises ``ValueError`` when the extent does not divide by the
    axis size (JAX's ``shard_map`` fails there too)."""
    n = axis_size(mesh, axis)
    extent = x.shape[dim]
    if extent % n:
        raise ValueError(f"extent {extent} of dim {dim} does not divide "
                         f"by the {n} ranks of axis {axis!r}")
    step = extent // n
    return x.narrow(dim, axis_index(mesh, axis) * step, step)


def data_sharding(mesh, x: torch.Tensor) -> torch.Tensor:
    """The leading axis over ``data``: this rank's block."""
    return shard_rows(mesh, x, "data")


def replicated(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank holds the whole tensor."""
    return x


def volume_sharding(mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """A TSDF volume (or its raveled voxel rows) along its leading x axis:
    this rank's slab. Per-voxel integrate and warp have no cross-voxel
    term, so the slabs need no communication."""
    return shard_rows(mesh, x, axis)


def _staged(group, x: torch.Tensor) -> bool:
    """Whether a point-to-point or gather of ``x`` on ``group`` must pass
    through the host (gloo takes no CUDA tensors there)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def gather_blocks(mesh, x: torch.Tensor, axis: str = "data",
                  dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along ``axis`` concatenated on ``dim``, on
    every rank (the inverse of ``shard_rows``)."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    src = x.contiguous()
    if _staged(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_gather_rows(mesh, tensors, axis: str = "data") -> list:
    """Every rank's row shards of ``tensors`` (each [rows, ...], all with
    this rank's ``rows``) concatenated in rank order, on every rank: the
    whole arrays, bit for bit. One collective for all of them: each is
    packed by its bits into a column block of one int32 buffer (bool as
    int32 0/1), gathered by ``gather_blocks`` (through the host under
    gloo with CUDA tensors) and unpacked."""
    rows = tensors[0].shape[0]
    cols = []
    for x in tensors:
        if x.shape[0] != rows:
            raise ValueError(f"rows {x.shape[0]} and {rows} differ")
        y = x.reshape(rows, -1)
        if y.dtype == torch.bool:
            y = y.to(torch.int32)
        if y.element_size() % 4:
            raise ValueError(f"cannot pack {y.dtype} into 4-byte words")
        cols.append(y.contiguous().view(torch.int32))
    full = gather_blocks(mesh, torch.cat(cols, dim=1), axis)
    out, c = [], 0
    for x, y in zip(tensors, cols):
        part = full[:, c:c + y.shape[1]].contiguous()
        c += y.shape[1]
        part = part != 0 if x.dtype == torch.bool else part.view(x.dtype)
        out.append(part.reshape((-1,) + tuple(x.shape[1:])))
    return out


# ---------------------------------------------------------------------------
# launcher


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(obj):
    """Tensors in a rank's result -> CPU tensors (nested tuples, lists and
    dicts kept), so the parent never maps another process's CUDA memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, tuple):  # a NamedTuple
        return type(obj)(*(_to_host(v) for v in obj))
    return obj


def _rank_main(rank, fn, world_size, port, device, backend, args, results):
    dev = torch.device(device)
    if dev.type == "cuda":
        # ranks share the cards round robin (several on one card with gloo)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=300),
    )
    try:
        out = fn(rank, world_size, *args)
        # pickled here by value: the queue's own pickler would pass
        # tensors as shared-memory handles that die with this process
        results.put((rank, pickle.dumps(_to_host(out))))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, *args, device=None, backend: str | None = None,
           timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    with a process group of ``backend`` (``default_backend(device)`` if
    None) over TCP on 127.0.0.1, on ``device``'s type (the card unless
    ``cpu``; each rank takes card ``rank % device_count``). ``fn`` must be
    a module-level function, its arguments and result picklable; tensors
    in a result come back on the CPU. Returns the results in rank order.
    A rank that raises or dies fails the launch (the others are
    stopped), as does one still running after ``timeout`` seconds."""
    from occlusionfusion_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch on cuda: no CUDA device")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = torch.multiprocessing.start_processes(
        _rank_main,
        args=(fn, world_size, free_port(), str(dev), backend, args, results),
        nprocs=world_size, join=False, start_method="spawn",
    )
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            # drain before joining: a rank blocks on a full queue
            try:
                while True:
                    rank, out = results.get_nowait()
                    got[rank] = pickle.loads(out)
            except queue.Empty:
                pass
            if procs.join(timeout=0.05):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    while len(got) < world_size:
        rank, out = results.get(timeout=30)
        got[rank] = pickle.loads(out)
    return [got[r] for r in range(world_size)]
