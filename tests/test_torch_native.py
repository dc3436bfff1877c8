"""The port's native host math (``liberate_tpu_torch/native``) against its
pure-Python twins and the JAX package's pure-Python functions, bit for bit,
on the CPU: Miller-Rabin, the NTT prime search in both directions, the
scale and message prime sequences, the primitive roots and psi banks, and
the port's ``CkksContext`` (native by default) against its twin and the
JAX one, field for field. A failed host build raises with the compiler's
log; two processes that build the library at once both load it.

The JAX package's own native library is switched off here (its
``get_lib`` returns None), so its functions run in Python and no test
builds it. The marked-slow test holds the four presets' contexts against
the JAX package's."""

import importlib
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import liberate_tpu
from liberate_tpu import native as jax_native
from liberate_tpu.fhe.context import generate_primes as jax_primes
from liberate_tpu.fhe.context import prim_test as jax_prim

import liberate_tpu_torch
from liberate_tpu_torch import _build, native
from liberate_tpu_torch.fhe.context import generate_primes as port_primes
from liberate_tpu_torch.fhe.context import prim_test as port_prim

# The context packages export the class ckks_context under the module's
# name.
jax_ckks = importlib.import_module("liberate_tpu.fhe.context.ckks_context")
port_ckks = importlib.import_module(
    "liberate_tpu_torch.fhe.context.ckks_context")

REPO = pathlib.Path(__file__).resolve().parent.parent

# Primes; composites: Carmichael numbers, strong pseudoprimes to the first
# bases (2047 to base 2; 1373653 to 2, 3; 25326001 to 2, 3, 5; 3215031751 to
# 2, 3, 5, 7; 2152302898747 to 2-11; 3474749660383 to 2-13;
# 341550071728321 to 2-17; 3825123056546413051 to 2-23), squares of
# primes, and numbers near 2^61, 2^62 and 2^63; then every odd number in
# (2^62 - 200, 2^62), held against the JAX package's test.
PRIMES = [2, 3, 5, 47, 53, 97, 2 ** 31 - 1, 2 ** 61 - 1, 2 ** 62 - 57,
          2 ** 63 - 25]
COMPOSITES = ([0, 1, 4, 9, 25, 49, 2209, (2 ** 31 - 1) ** 2]
              + [561, 1105, 1729, 2465, 2821, 6601, 8911, 41041, 825265,
                 321197185]
              + [2047, 1373653, 25326001, 3215031751, 2152302898747,
                 3474749660383, 341550071728321, 3825123056546413051]
              + [2 ** 61 + 1, 2 ** 62 - 1, 2 ** 62 + 1, 2 ** 63 - 1])
NEAR_2_62 = list(range(2 ** 62 - 199, 2 ** 62, 2))


@pytest.fixture
def jax_plain(monkeypatch):
    """The JAX package's context functions in Python: its native library
    reads as unavailable."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _fields_equal(a, b, skip=()):
    """Every field of two contexts' __dict__ equal (arrays with their
    dtype); returns the names that differ."""
    da, db = a.__dict__, b.__dict__
    assert da.keys() == db.keys()
    bad = []
    for k in da:
        if k in skip:
            continue
        x, y = da[k], db[k]
        if isinstance(x, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = type(x) is type(y) and x == y
        if not same:
            bad.append(k)
    return bad


def test_miller_rabin_equals_twins(jax_plain):
    cases = ([(n, True) for n in PRIMES] + [(n, False) for n in COMPOSITES]
             + [(n, jax_prim.miller_rabin(n)) for n in NEAR_2_62])
    assert any(w for _, w in cases[-len(NEAR_2_62):])
    for n, want in cases:
        assert native.miller_rabin(n) is want, n
        assert port_prim.miller_rabin(n) is want, n
        assert port_prim.miller_rabin_plain(n) is want, n
        assert jax_prim.miller_rabin(n) is want, n


@pytest.mark.parametrize("logN", [8, 10, 12, 14])
def test_find_ntt_prime_equals_twins(jax_plain, logN):
    M = 2 << logN
    for sb in (30, 40, 60):
        for start, up in ((2 ** sb + 1, True), (2 ** sb - 1, False)):
            want = jax_primes.find_the_next_prime(start, M, up=up)
            assert (want - 1) % M == 0 and jax_prim.miller_rabin(want)
            assert native.find_ntt_prime(start, M, up) == want
            assert port_primes.find_the_next_prime(start, M, up) == want
            assert port_primes.find_the_next_prime_plain(start, M,
                                                         up) == want


@pytest.mark.parametrize("logN", [8, 10, 12])
def test_prime_sequences_equal_twins(jax_plain, logN):
    """The context's scale sequences (64 primes, as the context asks) and
    the message/special primes below 2^28 and 2^60."""
    N = 1 << logN
    for sb in (30, 40):
        want = jax_primes.generate_alternating_prime_sequence(
            sb=sb, N=N, how_many=64)
        assert port_primes.generate_alternating_prime_sequence(
            sb=sb, N=N, how_many=64) == want
        with native.plain():
            assert port_primes.generate_alternating_prime_sequence(
                sb=sb, N=N, how_many=64) == want
    want = jax_primes.generate_message_primes(how_many=3,
                                              logN_range=[logN])
    assert port_primes.generate_message_primes(how_many=3,
                                               logN_range=[logN]) == want
    assert port_ckks._get_message_special_primes(60, N, 3) == want[60][N]
    with native.plain():
        assert port_primes.generate_message_primes(
            how_many=3, logN_range=[logN]) == want


@pytest.mark.parametrize("logN", [8, 10, 12])
def test_psi_banks_equal_twins(jax_plain, logN):
    N = 1 << logN
    qs = (port_primes.generate_alternating_prime_sequence(sb=40, N=N,
                                                          how_many=3)
          + port_ckks._get_message_special_primes(60, N, 2))
    for q in qs:
        g = jax_ckks.primitive_root_2N(q, N)
        assert native.primitive_root_2N(q, N) == g
        assert port_ckks.primitive_root_2N(q, N) == g
        assert port_ckks.primitive_root_2N_plain(q, N) == g
    want = jax_ckks.psi_bank(qs, logN)
    for got in (port_ckks.psi_bank(qs, logN),
                port_ckks.psi_bank_plain(qs, logN)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int64
            assert a.shape == (len(qs), N) and np.array_equal(a, b)
    roots = [port_ckks.primitive_root_2N(q, N) for q in qs]
    fwd, inv = native.psi_banks(qs, roots, [pow(r, -1, q) for r, q in
                                            zip(roots, qs)], logN)
    assert fwd.dtype == np.uint64
    assert np.array_equal(fwd.view(np.int64), want[0])
    assert np.array_equal(inv.view(np.int64), want[1])


CONTEXTS = [
    dict(logN=8, scale_bits=30, num_scales=3, num_special_primes=2),
    dict(logN=10, scale_bits=30, num_scales=6, num_special_primes=2),
    dict(buffer_bit_length=30, logN=9, scale_bits=25, num_scales=4,
         num_special_primes=1),
]


@pytest.mark.filterwarnings("ignore:Security budget violated")
@pytest.mark.parametrize("kw", CONTEXTS, ids=["logN8", "logN10", "word30"])
def test_context_equals_twin_and_jax(jax_plain, kw, tmp_path):
    """The native context equals its Python twin, the JAX package's, and a
    context that the twin wrote to the cache (what a cache from before the
    native path holds), field for field."""
    kw = dict(kw, is_secured=False)
    ctx = port_ckks.CkksContext(**kw, cache_folder=str(tmp_path),
                                read_cache=False, save_cache=False)
    with native.plain():
        twin = port_ckks.CkksContext(**kw, cache_folder=str(tmp_path),
                                     read_cache=False)
    assert _fields_equal(ctx, twin) == []
    cached = port_ckks.CkksContext(**kw, cache_folder=str(tmp_path))
    assert _fields_equal(ctx, cached) == []
    ref = jax_ckks.CkksContext(**kw, read_cache=False, save_cache=False)
    assert _fields_equal(ctx, ref, skip=("cache_folder",)) == []
    assert ctx.hash_material == ref.hash_material


def test_wrappers_decline_above_the_range():
    """At 2^63 and above the wrappers return None and the context's
    functions take their Python twins; even starts are refused."""
    big = 2 ** 89 - 1                       # a Mersenne prime
    assert native.miller_rabin(big) is None
    assert port_prim.miller_rabin(big) is True
    assert port_prim.miller_rabin(2 ** 64 + 1) is False
    M = 1 << 10
    assert native.find_ntt_prime(2 ** 63 - 1, M, True) is None
    q = port_primes.find_the_next_prime(2 ** 63 - 1, M, up=True)
    assert q > 2 ** 63 and (q - 1) % M == 0 and port_prim.miller_rabin(q)
    assert q == port_primes.find_the_next_prime_plain(2 ** 63 - 1, M)
    with pytest.raises(ValueError):
        native.find_ntt_prime(2 ** 40, M, True)
    assert native.primitive_root_2N(q, 16) is None
    assert native.psi_banks([q], [3], [3], 4) is None
    for a, b in zip(port_ckks.psi_bank([q], 4),
                    port_ckks.psi_bank_plain([q], 4)):
        assert np.array_equal(a, b)


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setenv("LIBERATE_TPU_TORCH_BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})


def test_failed_host_build_raises(monkeypatch, tmp_path):
    """No compiler, or a source it refuses: the wrappers and the context
    raise with the reason, and nothing falls back to Python."""
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "CXX", "no-such-c++-compiler")
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+-compiler"):
        native.miller_rabin(7)
    with pytest.raises(RuntimeError, match="not found"):
        port_ckks.CkksContext(logN=8, scale_bits=30, num_scales=3,
                              num_special_primes=2, is_secured=False,
                              cache_folder=str(tmp_path), read_cache=False,
                              save_cache=False)
    monkeypatch.undo()
    _fresh_build(monkeypatch, tmp_path)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(_build.HOST_SOURCES, "hostmath", bad)
    with pytest.raises(RuntimeError, match="(?s)hostmath.*exit.*error"):
        native.find_ntt_prime(2 ** 40 + 1, 512, True)
    assert not list(tmp_path.glob("*.so"))


_BUILD_SCRIPT = textwrap.dedent("""
    import ctypes, importlib.util, os, sys, time
    spec = importlib.util.spec_from_file_location("b", sys.argv[1])
    b = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b)
    while not os.path.exists(sys.argv[2]):
        time.sleep(0.001)
    built = not b._lib_path("hostmath").exists()
    f = b.load("hostmath").miller_rabin_u64
    f.restype, f.argtypes = ctypes.c_int32, [ctypes.c_uint64]
    print(built, f(2 ** 61 - 1), f(2 ** 61 + 1))
""")


def test_two_processes_build_at_once(monkeypatch, tmp_path):
    """Two processes that build the host library at the same moment each
    write their own file and both load a whole library."""
    monkeypatch.setenv("LIBERATE_TPU_TORCH_BUILD", str(tmp_path / "b"))
    env = dict(os.environ)
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT,
         str(REPO / "liberate_tpu_torch" / "_build.py"), str(go)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[1:] == ["1", "0"], out
    assert [o.split()[0] for o, _ in outs] == ["True", "True"]
    files = sorted(f.name for f in (tmp_path / "b").iterdir())
    assert [f for f in files if f.endswith(".so")] == [
        _build._lib_path("hostmath").name], files


@pytest.mark.slow
@pytest.mark.filterwarnings("ignore:Security budget violated")
@pytest.mark.parametrize("preset", ["bronze", "silver", "gold", "platinum"])
def test_preset_contexts_equal_jax(jax_plain, preset, tmp_path):
    """The four presets' contexts (native) equal the JAX package's (its
    Python prime search and psi banks), field for field."""
    kw = {k: v for k, v in liberate_tpu_torch.params[preset].items()
          if k != "mesh_shape"}
    assert kw == {k: v for k, v in liberate_tpu.params[preset].items()
                  if k != "mesh_shape"}
    ctx = port_ckks.CkksContext(**kw, cache_folder=str(tmp_path),
                                read_cache=False, save_cache=False)
    ref = jax_ckks.CkksContext(**kw, read_cache=False, save_cache=False)
    assert _fields_equal(ctx, ref, skip=("cache_folder",)) == []
