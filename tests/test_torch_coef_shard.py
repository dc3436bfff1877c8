"""The port's coefficient-sharded transforms (``parallel.coef_shard``) on the
CPU, ranks as gloo threads: word for word the port's single-device
transforms at S = 2, 4 and 8 shards (logN 8: the locals at logL 7, 6 and 5
run the kernels' twins, #2 in its no-normalise mode), batched part stacks
with the fused enter and exit chains, the 2-D (2 rns x 4 coef) layout; and
equal mod q to the JAX package's ``ntt_coef_sharded``/``intt_coef_sharded``
on its 4-device coef CPU mesh (XLA locals, Montgomery twiddles: other
[0, 2q) representatives)."""

import numpy as np
import pytest
import torch

from liberate_tpu_torch.fhe.context.ckks_context import CkksContext
from liberate_tpu_torch.ntt import cuda_ntt, ops
from liberate_tpu_torch.ntt.ntt_context import NttContext
from liberate_tpu_torch.parallel import make_mesh, make_mesh2d, run_ranks
from liberate_tpu_torch.parallel.coef_shard import (
    _rearranged_index, intt_coef_sharded, make_coef_plan, ntt_coef_sharded)

PARAMS = dict(logN=8, scale_bits=30, num_scales=3, num_special_primes=2,
              is_secured=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Level-0 with-special words, [C, N] and a [P=3, C, N] stack, their
    single-device transforms."""
    ctx = CkksContext(**PARAMS)
    nc = NttContext(ctx, "cpu")
    pack = nc.level_pack(0, -2)
    q = pack.q.numpy()[:, None]
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(0, 1 << 62, size=(3, len(q), ctx.N))
                         % q)
    f = ops.ntt(a, pack)
    return dict(ctx=ctx, nc=nc, pack=pack, a=a, f=f,
                fe=ops.enter_ntt(a, pack), inv=ops.intt(f, pack),
                inv_er=ops.intt_exit_reduce(f, pack),
                inv_e=ops.intt_exit(f, pack))


def _sharded(s, S, run):
    """run(plan, shard of) on S coef ranks; their outputs joined along the
    coefficient axis."""
    N = s["ctx"].N
    L = N // S

    def body():
        plan = make_coef_plan(s["nc"], make_mesh(S, axis_name="coef"))
        i = plan.index
        return run(plan, lambda x: x[..., i * L:(i + 1) * L].contiguous())

    outs = run_ranks(S, body, device="cpu")
    return [torch.cat(o, dim=-1) for o in zip(*outs)]


@pytest.mark.parametrize("S", [2, 4, 8])
def test_forward_equals_single_device(setup, S):
    s = setup
    a = s["a"][0]
    got, got_e = _sharded(s, S, lambda p, cut: (
        ntt_coef_sharded(cut(a), p), ntt_coef_sharded(cut(a), p,
                                                       pre_enter=True)))
    assert torch.equal(got, s["f"][0])
    assert torch.equal(got_e, s["fe"][0])


@pytest.mark.parametrize("S", [2, 4, 8])
def test_inverse_equals_single_device(setup, S):
    s = setup
    f = s["f"][1]
    got, got_e, got_er = _sharded(s, S, lambda p, cut: (
        intt_coef_sharded(cut(f), p),
        intt_coef_sharded(cut(f), p, post_exit=True),
        intt_coef_sharded(cut(f), p, post_exit=True, post_reduce=True)))
    assert torch.equal(got, s["inv"][1])
    assert torch.equal(got_e, s["inv_e"][1])
    assert torch.equal(got_er, s["inv_er"][1])


def test_batched_stack_fused_chains(setup):
    """A [P, C, N] part stack through enter + forward and inverse + exit +
    reduce, as the key switch's chains."""
    s = setup
    got_f, got_i = _sharded(s, 4, lambda p, cut: (
        ntt_coef_sharded(cut(s["a"]), p, pre_enter=True),
        intt_coef_sharded(cut(s["f"]), p, post_exit=True,
                          post_reduce=True)))
    assert torch.equal(got_f, s["fe"])
    assert torch.equal(got_i, s["inv_er"])


def test_2d_layout(setup):
    """(rns, coef) = (2, 4): each rank holds 3 of the 6 channels and a
    quarter of the coefficients; the round trip and both transforms give
    the single-device words."""
    s = setup
    N, C = s["ctx"].N, s["a"].shape[1]

    def body():
        mesh = make_mesh2d(2, 4)
        plan = make_coef_plan(s["nc"], mesh, rns_axis="rns")
        r, i, w, L = mesh.axis_index("rns"), plan.index, C // 2, N // 4
        assert plan.channels == list(range(r * w, (r + 1) * w))
        cut = (slice(r * w, (r + 1) * w), slice(i * L, (i + 1) * L))
        f = ntt_coef_sharded(s["a"][:, cut[0], cut[1]].contiguous(), plan,
                             pre_enter=True)
        back = intt_coef_sharded(f, plan, post_exit=True, post_reduce=True)
        return cut, f, back

    for cut, f, back in run_ranks(8, body, device="cpu"):
        assert torch.equal(f, s["fe"][:, cut[0], cut[1]])
        assert torch.equal(back, s["a"][:, cut[0], cut[1]])


def test_plan_checks(setup):
    """6 channels do not divide over 4 rns ranks; 3 coef shards are not a
    power of two."""
    s = setup

    def body():
        make_coef_plan(s["nc"], make_mesh2d(4, 2), rns_axis="rns")

    with pytest.raises(ValueError, match="not divisible"):
        run_ranks(8, body, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        run_ranks(3, lambda: make_coef_plan(
            s["nc"], make_mesh(3, axis_name="coef")), device="cpu")


def test_rearranged_bank_is_the_local_schedule():
    """Local stage sl, block bl of shard i reads global entry
    2^(k+sl) + i 2^sl + bl, the entry the single-device schedule uses for
    global block i 2^sl + bl of stage k + sl."""
    logN, S = 8, 4
    k, L = 2, (1 << logN) // 4
    for i in range(S):
        idx = _rearranged_index(logN, S, i)
        for sl in range(L.bit_length() - 1):
            for bl in range(1 << sl):
                assert idx[(1 << sl) + bl] == (1 << (k + sl)) + (i << sl) + bl


def test_equals_jax_coef_sharded(setup):
    """The JAX package's sharded forward and inverse on a 4-device coef
    mesh (XLA locals) on the same words: equal mod q."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from liberate_tpu.fhe.context.ckks_context import \
        CkksContext as JaxCkksContext
    from liberate_tpu.ntt import u64
    from liberate_tpu.ntt.ntt_context import NttContext as JaxNttContext
    from liberate_tpu.parallel import make_mesh as jax_make_mesh
    from liberate_tpu.parallel import coef_shard as jax_coef_shard

    s = setup
    a, f = s["a"][2], s["f"][2]
    mesh = jax_make_mesh(4, axis_name="coef")
    plan = jax_coef_shard.make_coef_plan(
        JaxNttContext(JaxCkksContext(**PARAMS)), mesh)
    sh = NamedSharding(mesh, P(None, None, "coef"))

    def put(x):
        return jax.device_put(jnp.asarray(u64.from_int64_np(x.numpy())), sh)

    # One program (eagerly, each operation of the shard_map bodies would
    # compile on its own: minutes on the CPU).
    want_f, want_i = (u64.to_int64_np(np.asarray(w)) for w in jax.jit(
        lambda x, y: (jax_coef_shard.ntt_coef_sharded(x, plan),
                      jax_coef_shard.intt_coef_sharded(y, plan)))(
        put(a), put(f)))
    got_f, got_i = _sharded(s, 4, lambda p, cut: (
        ntt_coef_sharded(cut(a), p), intt_coef_sharded(cut(f), p)))
    q = s["pack"].q.numpy()[:, None]
    assert np.array_equal(got_f.numpy() % q, want_f % q)
    assert np.array_equal(got_i.numpy() % q, want_i % q)


def test_locals_launch_no_kernel_on_the_cpu(setup):
    """On CPU tensors the locals run the twins through the wrappers, which
    count no launch."""
    cuda_ntt.reset_launches()
    s = setup
    _sharded(s, 2, lambda p, cut: (intt_coef_sharded(cut(s["f"]), p),))
    assert cuda_ntt.launches == dict.fromkeys(cuda_ntt.launches, 0)
