"""The batched mult and the switch kernels' ct-batched part segments, on the
CPU.

The segment mode: the state holds B segments of P parts (b-major,
part-fastest), each one ciphertext's switch under the same key. At logN 8
with 40-bit scale primes (the silver width groups (6, 6) and (8, 8)), on
random state rows and keys at level 0 (3 parts, A = 2), with B = 2, the
twins of the folded switch (#11, both modes), the Shoup-key switch (#10)
and the Montgomery-key switch (#9) give the words of the JAX package's
``mxu_pallas.dispatch_ksk_from_state(..., parts=P)`` in interpret mode
over both width groups (one JAX program; the config flags it reads are set
with ``monkeypatch`` for the module), and at every level each segment's
words equal the one-ciphertext switch of that segment.

``mult_batched`` (B = 1 and 3 pairs) and ``mult_stacked`` on
``stack_cts``, taken apart by ``unstack_ct``, give the words of per-pair
``mult``: in the tensor-core domain on each switch route (folded,
unfolded, Montgomery-form key), in the butterfly domain (a loop) also the
JAX engine's per-pair ``mult`` words on the port's ciphertexts and evk
(never the JAX engine's ``mult_stacked``, which gives wrong words on the
CPU). The JAX engine's errors: unequal or empty lists, mixed levels, the
last level. A batched ``_pre_extend`` gives the per-ciphertext state rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import liberate_tpu_torch
from liberate_tpu import config
from liberate_tpu.fhe.context.ckks_context import CkksContext
from liberate_tpu.ntt import mxu_pallas
from liberate_tpu.ntt.ntt_context import NttContext
from liberate_tpu_torch import interop
from liberate_tpu_torch.fhe import engine as port_engine
from liberate_tpu_torch.fhe.presets import errors
from liberate_tpu_torch.ntt import cuda_mxu
from test_torch_engine import PARAMS, _jax_words, _to_jax
from test_torch_switch import PARAMS as MXU_PARAMS
from test_torch_switch import SEED, _limbs, _words

B = 2
_FLAGS = ("use_mxu_ntt", "use_mxu_pallas", "use_pallas", "pallas_interpret",
          "use_shoup_ksk", "use_shoup_moddown", "use_shoup_extend")


def _switch_inputs(te, level, seg, seed):
    """Random state rows of ``seg`` segments, Montgomery-form key stacks
    and their Shoup pairs, and the level's scalar tables."""
    parts = te.ntt.parts(level)
    P, A, N = len(parts), max(p.alpha for p in parts), te.ctx.N
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(rng.integers(-(1 << 63), 1 << 63,
                                       size=(seg * P, A, N), dtype=np.int64))
    pack0 = te.pack(0, -2)
    q = pack0.q.numpy()[:, None]
    mont = [torch.from_numpy(rng.integers(0, 1 << 62, size=(
        len(te.ntt.parts(0)), len(q), N)) % (2 * q)) for _ in range(2)]
    shoup = [port_engine._ksk_shoup(k, pack0) for k in mont]
    return dict(st=st, P=P, A=A, mont=mont, shoup=shoup,
                tables=te._mxu_switch_tables(level),
                groups=te.pack(level, -2).mxu, part_off=parts[0].part_id)


def _port_switches(te, level, x, seg):
    """#11, #10 and #9 on x's inputs as ``seg`` segments (None: one)."""
    terms, off0, piw = x["tables"]
    base = (x["st"], terms, off0)
    rest = (x["groups"], level, x["part_off"])
    return {
        "#11 fold": cuda_mxu.dispatch_switch(
            *base, piw, *x["shoup"], *rest, te.num_special, parts=seg),
        "#10 Shoup key": cuda_mxu.dispatch_switch_inv(
            *base, *x["shoup"], *rest, parts=seg),
        "#9 Montgomery key": cuda_mxu.dispatch_switch_inv(
            *base, *x["mont"], *rest, parts=seg)}


@pytest.fixture(scope="module")
def mxu_eng():
    return liberate_tpu_torch.CkksEngine(device="cpu", use_mxu_ntt=True,
                                         seed=SEED, **MXU_PARAMS)


@pytest.fixture(scope="module")
def segments(mxu_eng):
    """The port's segment-mode twins and the JAX kernels at level 0, B = 2,
    in one interpret-mode program."""
    te, level = mxu_eng, 0
    x = _switch_inputs(te, level, B, 17)
    got = _port_switches(te, level, x, x["P"])
    terms, off0, piw = x["tables"]
    W, N = off0.shape[0], te.ctx.N
    S = R = 16
    tl = interop.int64_to_limbs(terms.numpy())          # [2, P, n, 3, W]
    t6 = np.stack([tl[0], tl[1]], axis=3).reshape(x["P"], -1, 6, W)
    pl = interop.int64_to_limbs(piw.numpy())            # [2, n_sp, 2, W]
    piw4 = np.stack([pl[0, :, 0], pl[1, :, 0], pl[0, :, 1], pl[1, :, 1]],
                    axis=1)

    def key(t):
        return _limbs(t.numpy()).reshape(2, t.shape[0], t.shape[1], R, S)

    shoup = [tuple(key(t) for t in k) for k in x["shoup"]]
    mont = [key(k) for k in x["mont"]]
    with pytest.MonkeyPatch.context() as mp:
        for f in _FLAGS:
            mp.setattr(config, f, True)
        ref = NttContext(CkksContext(**MXU_PARAMS)).level_pack(level, -2).mxu
        assert len(ref.groups) == 2

        def run(st, t6, off0, piw4, k0s, k1s, k0m, k1m):
            kw = dict(interpret=True, parts=x["P"])
            args = (ref, level, x["part_off"], W)
            return (
                mxu_pallas.dispatch_ksk_from_state(
                    st, t6, off0, k0s, k1s, *args, moddown_piw=piw4,
                    n_sp=te.num_special, **kw),
                mxu_pallas.dispatch_ksk_from_state(
                    st, t6, off0, k0s, k1s, *args, **kw),
                mxu_pallas.dispatch_ksk_from_state(
                    st, t6, off0, k0m, k1m, *args, **kw))

        outs = jax.jit(run)(
            _limbs(x["st"].numpy()).reshape(2, B * x["P"], x["A"], S, R),
            jnp.asarray(t6), _limbs(off0.numpy()), jnp.asarray(piw4),
            shoup[0], shoup[1], *mont)
    want = {name: np.stack([_words(o).reshape(B, W, N) for o in pair])
            for name, pair in zip(got, outs)}
    return dict(got=got, want=want)


@pytest.mark.parametrize("kernel", ["#11 fold", "#10 Shoup key",
                                    "#9 Montgomery key"])
def test_segment_twins_equal_pallas(segments, kernel):
    got, want = segments["got"][kernel].numpy(), segments["want"][kernel]
    assert got.shape == want.shape == (2, B, got.shape[2], got.shape[3])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_segments_equal_single_switches(mxu_eng, level):
    """Segment b of a B = 3 call equals the one-ciphertext switch of its
    state rows (level 2: the parts start at 1)."""
    x = _switch_inputs(mxu_eng, level, 3, 29 + level)
    batched = _port_switches(mxu_eng, level, x, x["P"])
    for b in range(3):
        one = dict(x, st=x["st"][b * x["P"]:(b + 1) * x["P"]])
        for name, out in _port_switches(mxu_eng, level, one, None).items():
            assert torch.equal(batched[name][:, b], out), (name, b)


def test_segment_switch_checks_its_segments(mxu_eng):
    x = _switch_inputs(mxu_eng, 0, 1, 3)
    terms, off0, _ = x["tables"]
    g = x["groups"][0]
    with pytest.raises(ValueError, match="segments"):
        cuda_mxu.mxu_switch_inv(x["st"], terms[..., g.lo:g.hi],
                                off0[g.lo:g.hi], *x["shoup"], g.plan, 0, 0,
                                parts=2)


# -- the batched mult -----------------------------------------------------------


def _setup(**kw):
    te = liberate_tpu_torch.CkksEngine(device="cpu", **kw)
    sk = te.create_secret_key()
    pk = te.create_public_key(sk)
    evk = te.create_evk(sk)
    rng = np.random.default_rng(41)
    ms = [rng.uniform(-1, 1, te.num_slots) + 1j * rng.uniform(
        -1, 1, te.num_slots) for _ in range(6)]
    cts = [te.encorypt(m, pk) for m in ms]
    return dict(te=te, sk=sk, evk=evk, ms=ms, cts=cts)


ROUTES = {"folded": dict(use_mxu_ntt=True),
          "unfolded": dict(use_mxu_ntt=True),
          "Montgomery key": dict(use_mxu_ntt=True, use_shoup_ksk=False),
          "butterfly": {}}


@pytest.fixture(scope="module")
def runs():
    """One engine per domain and key form, each from one seed, with six
    ciphertexts (level 1 too, to reach the parts past the first)."""
    out = {}
    for name in ("folded", "Montgomery key", "butterfly"):
        params = MXU_PARAMS if name != "butterfly" else {
            k: v for k, v in PARAMS.items() if k != "seed"}
        out[name] = _setup(seed=SEED, **params, **ROUTES[name])
    out["unfolded"] = out["folded"]
    return out


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.data, b.data))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("bct", [1, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mult_batched_equals_per_pair_mult(runs, route, bct, level,
                                           monkeypatch):
    if route == "unfolded":
        monkeypatch.setattr(port_engine, "FOLD_MAX_LOGN", 0)
    r = runs[route]
    te, evk = r["te"], r["evk"]
    cts = [te.level_up(c, level) if level else c for c in r["cts"]]
    a, b = cts[:bct], cts[3:3 + bct]
    got = te.mult_batched(a, b, evk)
    want = [te.mult(x, y, evk) for x, y in zip(a, b)]
    assert len(got) == bct
    assert all(_equal(g, w) for g, w in zip(got, want))
    for g, x, y in zip(got, r["ms"][:bct], r["ms"][3:3 + bct]):
        assert g.level == level + 1
        assert abs(te.absmax_error(te.decrode(g, r["sk"]), x * y)) < 1e-4


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mult_stacked_equals_per_pair_mult(runs, route, monkeypatch):
    if route == "unfolded":
        monkeypatch.setattr(port_engine, "FOLD_MAX_LOGN", 0)
    r = runs[route]
    te, evk, cts = r["te"], r["evk"], r["cts"]
    sa, sb = te.stack_cts(cts[:3]), te.stack_cts(cts[3:])
    assert sa.data[0].shape == (3,) + cts[0].data[0].shape
    assert all(_equal(u, c) for u, c in zip(te.unstack_ct(sa), cts[:3]))
    out = te.mult_stacked(sa, sb, evk)
    assert out.level == 1 and out.data[0].shape[0] == 3
    want = [te.mult(x, y, evk) for x, y in zip(cts[:3], cts[3:])]
    assert all(_equal(g, w) for g, w in zip(te.unstack_ct(out), want))


@pytest.mark.parametrize("bct", [1, 3])
def test_butterfly_mult_batched_equals_jax_mult(runs, shared_eng, bct):
    """The JAX engine's per-pair mult of the port's ciphertexts under the
    port's evk (interop): the port's batched words."""
    r = runs["butterfly"]
    te = r["te"]
    got = te.mult_batched(r["cts"][:bct], r["cts"][3:3 + bct], r["evk"])
    evk_j = _to_jax(r["evk"])
    for g, x, y in zip(got, r["cts"][:bct], r["cts"][3:3 + bct]):
        want = shared_eng.mult(_to_jax(x), _to_jax(y), evk_j)
        for j, t in zip(want.data, g.data):
            assert np.array_equal(_jax_words(j), t.numpy())


@pytest.mark.parametrize("route", ["folded", "butterfly"])
def test_mult_batched_errors(runs, route):
    r = runs[route]
    te, evk, cts = r["te"], r["evk"], r["cts"]
    with pytest.raises(errors.DifferentTypeError):
        te.mult_batched(cts[:2], cts[3:4], evk)
    with pytest.raises(errors.DifferentTypeError):
        te.mult_batched([], [], evk)
    last = te.num_levels - 1
    deep = [te.level_up(c, last) for c in cts[:2]]
    with pytest.raises(errors.MaximumLevelError):
        te.mult_batched(deep[:1], deep[1:], evk)
    with pytest.raises(errors.MaximumLevelError):
        te.mult_stacked(te.stack_cts(deep[:1]), te.stack_cts(deep[1:]), evk)
    if route == "folded":
        with pytest.raises(errors.NotMatchType):
            te.mult_batched([cts[0], te.level_up(cts[1], 1)], cts[3:5], evk)


def test_batched_pre_extend_equals_per_ciphertext(mxu_eng):
    te, level = mxu_eng, 0
    pack = te.pack(level, -1)
    q = pack.q.numpy()[:, None]
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(0, 1 << 62, size=(3, len(q),
                                                        te.ctx.N)) % q)
    for p in te.ntt.parts(level):
        batched = port_engine._pre_extend(a, p.local_start, p.alpha, p)
        assert len(batched) == p.alpha
        for b in range(3):
            one = port_engine._pre_extend(a[b], p.local_start, p.alpha, p)
            for x, y in zip(batched, one):
                assert x.shape == (3, 1, te.ctx.N)
                assert torch.equal(x[b], y)
