"""The collectives of the sharded paths, on one axis of a ``Mesh``.

GSPMD inserts the JAX package's collectives itself; the port calls these
where a step needs another rank's words:

- ``all_gather``: the ranks' slices of a channel axis, concatenated;
- ``broadcast``: a tensor from one rank of the axis to all of them;
- ``exchange``: the paired swap with the rank ``i XOR d`` (the
  coefficient-sharded transforms' cross-shard stages);
- ``all_sum``: an elementwise sum over the axis.

Each calls the axis's process group directly. A gloo group moves host
tensors, so a CUDA tensor goes through a host buffer and back (the
reference's own staging through pinned host memory); NCCL takes it as it
is. No compute moves to the host.
"""

import torch
import torch.distributed as dist

from .sharding import waiting


def _out(x, mesh):
    """x as the group takes it: contiguous, on the host for gloo."""
    x = x.contiguous()
    return x.cpu() if mesh.stage and x.is_cuda else x


def all_gather(x, mesh, axis="rns", dim=-2):
    """The ranks' x (equal shapes), concatenated along ``dim`` in rank
    order, on x's device."""
    g = mesh.groups[axis]
    buf = _out(x, mesh)
    outs = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    work = g.allgather([outs], [buf])
    with waiting(mesh.turn):
        work.wait()
    return torch.cat(outs, dim=dim).to(x.device)


def broadcast(x, root, mesh, axis="rns"):
    """Rank ``root``'s x (every rank passes a tensor of its shape and
    dtype), on x's device."""
    buf = _out(x, mesh).clone()
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    work = mesh.groups[axis].broadcast([buf], opts)
    with waiting(mesh.turn):
        work.wait()
    return buf.to(x.device)


def exchange(x, partner, mesh, axis):
    """The partner's x for this rank's: each of the pair sends its own and
    receives the other's."""
    g = mesh.groups[axis]
    buf = _out(x, mesh)
    got = torch.empty_like(buf)
    sent = g.send([buf], partner, 0)
    received = g.recv([got], partner, 0)
    with waiting(mesh.turn):
        received.wait()
        sent.wait()
    return got.to(x.device)


def all_sum(x, mesh, axis="rns"):
    """The elementwise sum of the ranks' x (integers wrap as int64)."""
    buf = _out(x, mesh).clone()
    work = mesh.groups[axis].allreduce([buf])
    with waiting(mesh.turn):
        work.wait()
    return buf.to(x.device)
