"""Ranks, meshes and the RNS-channel layout.

The JAX package lays one logical array over a GSPMD mesh and lets XLA
insert the collectives. The port runs SPMD instead: every rank runs the
same program on its own slice of the data, and the few collectives are
explicit calls (``comm``). A rank is a thread of this process (``run_ranks``:
the tests, and R ranks sharing one card) or a process of a
``torch.distributed`` job (one card each).

Channel layout (as the JAX package's): a channel axis of C real channels is
padded to W, the next multiple of the ``rns`` axis size, by repeating the
last real channel ("edge" padding), and rank i holds rows
[i W / R, (i + 1) W / R). Padded rows are computed with the constants of the
channel they repeat, so they hold that channel's words and are never read
back.
"""

import contextlib
import datetime
import math
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..fhe.data_struct import DataStruct

# How long a rank waits in a collective for its peers.
TIMEOUT = datetime.timedelta(seconds=300)

_local = threading.local()


class _Threads:
    """The ranks of one ``run_ranks`` call: their store, their device, what
    they share (one host context for all of them) and their turn.

    The ranks take turns on the interpreter: one runs its host code at a
    time, and a rank that waits for its peers (a collective, a group's
    rendezvous) hands the turn on. Free-running threads of small PyTorch
    ops fight over the interpreter lock at every op (at 8 ranks on the CPU
    the same work took six times as long)."""

    def __init__(self, size, device, timeout):
        self.size = size
        self.device = device
        self.timeout = timeout
        self.store = dist.HashStore()
        self.shared = {}
        self.lock = threading.Lock()
        self.turn = threading.Lock()


@contextlib.contextmanager
def waiting(turn):
    """Hand the turn on while this rank waits (no-op for processes)."""
    if turn is None:
        yield
        return
    turn.release()
    try:
        yield
    finally:
        turn.acquire()


class Mesh:
    """One rank's view of a mesh: the axis names and sizes (``shape``), its
    coordinates, one process group per axis (ranks numbered along the
    axis), its ``torch.device``, whether a collective stages CUDA tensors
    through host buffers (``stage``: gloo groups) and, for ranks of
    ``run_ranks``, their ``turn``."""

    def __init__(self, axis_names, shape, coords, groups, device, stage,
                 shared=None, lock=None, turn=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coords))
        self.groups = dict(zip(self.axis_names, groups))
        self.device = torch.device(device)
        self.stage = stage
        self._shared = {} if shared is None else shared
        self._lock = threading.Lock() if lock is None else lock
        self.turn = turn

    @property
    def size(self):
        return math.prod(self.shape.values())

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_index(self, axis):
        return self.coords.get(axis, 0)

    def shared(self, key, build):
        """``build()``'s result, built once for the ranks of this process
        (threads of one ``run_ranks`` call share it)."""
        with self._lock:
            if key not in self._shared:
                self._shared[key] = build()
            return self._shared[key]

    def __repr__(self):
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"device={self.device})")


def run_ranks(n, fn, device=None, timeout=TIMEOUT):
    """Run ``fn()`` on ``n`` ranks, each a thread of this process, and
    return their results in rank order; a rank's exception is raised here
    once every rank has ended. Inside ``fn``, ``make_mesh`` and
    ``make_mesh2d`` build the calling rank's mesh. Every rank's tensors
    live on ``device`` (``cuda:0`` unless the caller names another; R
    ranks may share one card)."""
    world = _Threads(n, resolve_device(device), timeout)
    results, errors = [None] * n, [None] * n

    def body(r):
        _local.world = (world, r)
        _local.meshes = 0
        world.turn.acquire()
        try:
            results[r] = fn()
        except BaseException as e:      # noqa: BLE001 - raised below
            errors[r] = e
        finally:
            _local.world = None
            world.turn.release()

    threads = [threading.Thread(target=body, args=(r,), name=f"rank {r}")
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _rank():
    """(the run_ranks world or None, this rank, the number of ranks)."""
    threads = getattr(_local, "world", None)
    if threads is not None:
        return threads[0], threads[1], threads[0].size
    if dist.is_available() and dist.is_initialized():
        return None, dist.get_rank(), dist.get_world_size()
    raise RuntimeError("a mesh needs ranks: build it inside run_ranks(), or "
                       "after torch.distributed.init_process_group")


def _mesh(names, shape, devices):
    """The calling rank's mesh of ``shape`` over the ranks 0 .. prod - 1
    (row-major: the last axis is the minor one)."""
    n = math.prod(shape)
    world, rank, size = _rank()
    if n > size or rank >= n:
        raise ValueError(f"a mesh of {n} ranks from rank {rank} of {size}")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    if world is not None:
        _local.meshes += 1
        tag = f"mesh{_local.meshes}"
    groups = []
    for ax, name in enumerate(names):
        # The ranks that differ from this one only along ``ax``; over
        # torch.distributed every process creates every group, in order.
        def members(c):
            return [int(np.ravel_multi_index(
                tuple(c[:ax]) + (j,) + tuple(c[ax + 1:]), shape))
                for j in range(shape[ax])]

        mine = members(coords)
        if world is not None:
            with waiting(world.turn):
                groups.append(dist.ProcessGroupGloo(
                    dist.PrefixStore(f"{tag}/{name}/{mine}", world.store),
                    mine.index(rank), len(mine), world.timeout))
            continue
        for c in np.ndindex(*shape):
            if c[ax] == 0:
                g = dist.new_group(members(c))
                if c[:ax] + c[ax + 1:] == coords[:ax] + coords[ax + 1:]:
                    groups.append(g)
    if world is not None:
        device = world.device if devices is None else devices[rank]
        return Mesh(names, shape, coords, groups, resolve_device(device),
                    True, world.shared, world.lock, world.turn)
    device = resolve_device(None if devices is None else devices[rank])
    return Mesh(names, shape, coords, groups, device,
                dist.get_backend() != "nccl")


def make_mesh(num_devices=None, axis_name="rns", devices=None) -> Mesh:
    """The calling rank's 1-D mesh over the RNS channel axis, of
    ``num_devices`` ranks (all of them by default). ``devices``: one device
    per rank (by default the ranks' device of ``run_ranks``, or ``cuda:0``
    for a process of a ``torch.distributed`` job)."""
    if num_devices is None:
        num_devices = _rank()[2]
    return _mesh((axis_name,), (num_devices,), devices)


def make_mesh2d(n_rns: int, n_coef: int, rns_axis="rns", coef_axis="coef",
                devices=None) -> Mesh:
    """The calling rank's 2-D (``rns``, ``coef``) mesh: channels over one
    axis, coefficients over the other (``coef_shard``). The coef axis is
    the minor one, so a shard's cross-stage partners are neighbouring
    ranks."""
    return _mesh((rns_axis, coef_axis), (n_rns, n_coef), devices)


def padded_width(channels, quantum):
    return -(-channels // quantum) * quantum


def rns_sharding(mesh: Mesh, channels: int, axis_name="rns") -> slice:
    """The rows of this rank in a channel axis of ``channels`` real rows
    padded to a multiple of the axis size."""
    n = mesh.axis_size(axis_name)
    w = padded_width(channels, n) // n
    i = mesh.axis_index(axis_name)
    return slice(i * w, (i + 1) * w)


def shard_rows(i: int, n: int, channels: int):
    """The rows of rank i of n in a channel axis of ``channels`` real rows
    padded to a multiple of n, as indices of the real rows (a padded row is
    the index of the last real one)."""
    w = padded_width(channels, n) // n
    return [min(j, channels - 1) for j in range(i * w, (i + 1) * w)]


def local_rows(mesh: Mesh, channels: int, axis_name="rns"):
    """This rank's rows as indices of the real rows (``shard_rows``)."""
    return shard_rows(mesh.axis_index(axis_name), mesh.axis_size(axis_name),
                      channels)


def pad_channels_to(x, quantum: int):
    """Pad the channel axis (-2) of ``x`` [..., C, N] up to a multiple of
    ``quantum``, repeating the last channel (edge padding)."""
    C = x.shape[-2]
    W = padded_width(C, quantum)
    if W == C:
        return x
    edge = x[..., C - 1:C, :]
    return torch.cat([x, edge.expand(*x.shape[:-2], W - C, x.shape[-1])],
                     dim=-2)


def shard_poly(x, mesh: Mesh, axis_name="rns"):
    """This rank's rows of a full-width polynomial x [..., C, N], padded,
    on the mesh's device."""
    rows = rns_sharding(mesh, x.shape[-2], axis_name)
    x = pad_channels_to(x, mesh.axis_size(axis_name))
    return x[..., rows, :].contiguous().to(mesh.device)


def _map(ds, fn):
    if isinstance(ds, DataStruct):
        return ds._replace(data=_map(ds.data, fn))
    if isinstance(ds, (tuple, list)):
        return type(ds)(_map(d, fn) for d in ds)
    return fn(ds)


def shard_datastruct(ds: DataStruct, mesh: Mesh,
                     axis_name="rns") -> DataStruct:
    """A full-width (host or single-device) DataStruct as this rank's
    padded rows: what an engine on the mesh holds of it."""
    return _map(ds, lambda x: (shard_poly(x, mesh, axis_name) if x.dim() >= 2
                               else x.to(mesh.device)))


def replicate_datastruct(ds: DataStruct, mesh: Mesh) -> DataStruct:
    """Every rank holds all of ``ds`` (small structures: plaintexts)."""
    return _map(ds, lambda x: x.to(mesh.device))
