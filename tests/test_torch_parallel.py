"""The port's mesh and collectives (``liberate_tpu_torch.parallel``) on the
CPU, ranks as gloo threads of this process: the collectives' results, the
2-D mesh's coordinates and groups, and the channel layout (edge padding,
each rank's rows) against the JAX package's ``pad_channels_to``,
``shard_datastruct`` and ``replicate_datastruct`` on its virtual CPU mesh
(numpy-level and device placement only: no JAX program is compiled)."""

import numpy as np
import pytest
import torch

import liberate_tpu.parallel as jax_parallel
from liberate_tpu.fhe.data_struct import DataStruct as JaxDataStruct
from liberate_tpu.ntt import u64
from liberate_tpu_torch.fhe.context.ckks_context import CkksContext
from liberate_tpu_torch.fhe.data_struct import DataStruct
from liberate_tpu_torch.ntt.ntt_context import NttContext
from liberate_tpu_torch.parallel import (comm, local_rows, make_mesh,
                                         make_mesh2d, pad_channels_to,
                                         replicate_datastruct,
                                         rns_sharding, run_ranks,
                                         shard_datastruct)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranks(n, fn):
    return run_ranks(n, fn, device="cpu")


def test_collectives_at_four_ranks():
    """all_gather, broadcast from rank 2, the paired exchange with rank
    i XOR 1 and i XOR 2, and the sum, on int64 words of each rank."""
    def body():
        mesh = make_mesh(4)
        r = mesh.axis_index("rns")
        x = torch.arange(6, dtype=torch.int64).reshape(2, 3) + 100 * r
        return (comm.all_gather(x, mesh), comm.broadcast(x, 2, mesh),
                comm.exchange(x, r ^ 1, mesh, "rns"),
                comm.exchange(x, r ^ 2, mesh, "rns"), comm.all_sum(x, mesh))

    out = _ranks(4, body)
    xs = [torch.arange(6, dtype=torch.int64).reshape(2, 3) + 100 * r
          for r in range(4)]
    for r, (gathered, bc, ex1, ex2, total) in enumerate(out):
        assert torch.equal(gathered, torch.cat(xs, dim=-2))
        assert torch.equal(bc, xs[2])
        assert torch.equal(ex1, xs[r ^ 1])
        assert torch.equal(ex2, xs[r ^ 2])
        assert torch.equal(total, sum(xs))


def test_mesh2d_coordinates_and_groups():
    """(rns, coef) = (2, 4): coef is the minor axis, and each axis's group
    holds the ranks that differ only along it, numbered along it."""
    def body():
        mesh = make_mesh2d(2, 4)
        me = torch.tensor([[mesh.axis_index("rns"),
                            mesh.axis_index("coef")]])
        return (mesh.shape, me, comm.all_gather(me, mesh, "coef"),
                comm.all_gather(me, mesh, "rns"))

    for rank, (shape, me, along_coef, along_rns) in enumerate(_ranks(8,
                                                                     body)):
        assert shape == {"rns": 2, "coef": 4}
        assert me.tolist() == [[rank // 4, rank % 4]]
        assert along_coef.tolist() == [[rank // 4, j] for j in range(4)]
        assert along_rns.tolist() == [[i, rank % 4] for i in range(2)]


def test_rank_exception_is_raised():
    # Each rank keeps its mesh to the end of the test: a rank that dropped
    # its groups at once could close them while its peer still connected
    # (gloo: "Connection closed by peer"), a failure of the peer's instead
    # of rank 1's exception.
    meshes = []

    def body():
        mesh = make_mesh(2)
        meshes.append(mesh)
        if mesh.axis_index("rns") == 1:
            raise KeyError("rank 1")
        return 0

    with pytest.raises(KeyError, match="rank 1"):
        _ranks(2, body)


def test_mesh_needs_ranks():
    with pytest.raises(RuntimeError, match="needs ranks"):
        make_mesh(2)


@pytest.mark.parametrize("C,quantum", [(6, 4), (6, 8), (8, 4), (3, 1)])
def test_pad_channels_to_equals_jax(C, quantum):
    x = np.random.default_rng(C).integers(0, 1 << 62, size=(2, C, 16))
    got = pad_channels_to(torch.from_numpy(x), quantum)
    assert np.array_equal(got.numpy(), jax_parallel.pad_channels_to(
        x, quantum))


@pytest.mark.parametrize("C,n", [(6, 4), (2, 8), (8, 8)])
def test_rows_and_shard_datastruct_equal_jax(C, n):
    """Each rank's rows of a [C, N] polynomial pair (a ciphertext of C
    channels) are the JAX shard_datastruct's addressable shard on the
    rank's device; ``local_rows`` and ``rns_sharding`` name them, as the
    port's NttContext does."""
    N = 16
    words = np.random.default_rng(n).integers(0, 1 << 62, size=(2, C, N))
    ct = DataStruct(tuple(torch.from_numpy(w) for w in words), False, False,
                    False, "ct", 0)
    jct = JaxDataStruct(tuple(u64.from_int64_np(w) for w in words), False,
                        False, False, "ct", 0)
    shards = jax_parallel.shard_datastruct(jct, jax_parallel.make_mesh(n))

    def body():
        mesh = make_mesh(n)
        return (shard_datastruct(ct, mesh), local_rows(mesh, C),
                rns_sharding(mesh, C))

    for r, (mine, rows, sl) in enumerate(_ranks(n, body)):
        for w, part, jpart in zip(words, mine.data, shards.data):
            want = next(s.data for s in jpart.addressable_shards
                        if s.device.id == r)
            assert np.array_equal(part.numpy(),
                                  u64.to_int64_np(np.asarray(want)))
            assert np.array_equal(part.numpy(), w[rows])
        assert sl.stop - sl.start == len(rows)


def test_replicate_datastruct_equals_jax():
    """Every rank holds all of a plaintext-sized structure, on its device:
    the JAX replicate_datastruct's addressable shard on that rank's
    device."""
    n, words = 4, np.random.default_rng(1).integers(0, 1 << 62, size=(3, 16))
    pt = DataStruct(torch.from_numpy(words), False, False, False, "pt", 1)
    jpt = JaxDataStruct(u64.from_int64_np(words), False, False, False, "pt",
                        1)
    shards = jax_parallel.replicate_datastruct(jpt, jax_parallel.make_mesh(n))
    got = _ranks(n, lambda: replicate_datastruct(pt, make_mesh(n)))
    for r, mine in enumerate(got):
        want = next(s.data for s in shards.data.addressable_shards
                    if s.device.id == r)
        assert (mine.origin, mine.level) == ("pt", 1)
        assert mine.data.device == torch.device("cpu")
        assert np.array_equal(mine.data.numpy(),
                              u64.to_int64_np(np.asarray(want)))


def test_ntt_context_rows_equal_local_rows():
    """The engine's packs hold the rows ``local_rows`` names, with the
    padded rows' constants those of the channel they repeat."""
    ctx = CkksContext(logN=8, scale_bits=30, num_scales=3,
                      num_special_primes=2, is_secured=False)
    full = NttContext(ctx, "cpu")
    C = full.num_channels(1, -2)

    def body():
        mesh = make_mesh(4)
        nc = NttContext(ctx, "cpu", mesh=mesh)
        return nc.rows(1, -2), local_rows(mesh, C), nc.level_pack(1, -2)

    for rows, want, pack in _ranks(4, body):
        assert rows == [1 + r for r in want]
        idx = torch.tensor(want)
        assert torch.equal(pack.q, full.level_pack(1, -2).q[idx])
        assert torch.equal(pack.plan.w, full.level_pack(1, -2).plan.w[idx])
