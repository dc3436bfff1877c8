#!/usr/bin/env python3
"""Where the time of the butterfly transforms goes, on one NVIDIA GPU.

    python3 bfly_variants.py [--parent DIR] [--only NAME ...] [--mulacc]

Builds variants of ``liberate_tpu_torch/csrc/ntt.cu`` (into
``build/bfly_variants``, one nvcc per variant, all started together) and
times ``ltt_ntt_fwd`` and ``ltt_ntt_inv`` with each at the multiply's
silver and gold shapes (plans of the 60-bit primes with the presets'
channel counts; CUDA events behind a spin kernel, median of 100), beside
``x.clone()`` of the same input, a yardstick of the memory floor:

- ``base``: the kernels as they are (held bit-equal to the port's);
- ``gold_k4``: clusters of K = 4 at gold (2^14-word chunks, 128 KB of
  shared memory each, one CTA per SM) instead of 8 (2^13 words, two CTAs
  per SM);
- ``threads1024``: a thread per 16 words (1024 a CTA, 64 registers
  each);
- ``no_swizzle``: shared memory in natural order (bank conflicts);
- ``compute_only``: no loads or stores of words or twiddles, the same
  butterflies on words made from the indices;
- ``no_butterflies``: every butterfly reduced to two adds of its twiddle
  pair (all loads and stores kept).

``--mulacc`` times the unsplit switch core ``ltt_ntt_mulacc`` (#4)
instead, at the silver and bronze level-1 shapes (P=9, C_sp=18 at logN 15;
P=7, C_sp=8 at logN 14; plans of the 60-bit primes), beside the split
route on the same words (``ltt_ntt_fwd`` at B=P, then ``ltt_ksk_mulacc``):
the port's library at the wrapper's geometry (first and last) and at a
few cluster sizes K, part groups G and parts held a CTA
(``MULACC_CASES``), each held bit-equal to its twin; then variants of
``ntt_mulacc.cu`` (``MULACC_VARIANTS``: without the key loads, without the
reads of the sums, without the products at all, without the combine
launch, all wrong words whose times alone mean anything; the combine
launched without programmatic dependence, the port's words) at the
wrapper's geometry; with ``--parent DIR`` also DIR's ``ntt_mulacc.cu`` (the C
interface of the multi-launch kernel it replaced, with its [P, C, N]
scratch), first. ``--only NAME ...`` picks the variants.

``--parent DIR`` also builds ``DIR/liberate_tpu_torch/csrc/ntt.cu`` (an
earlier tree, with this C interface or the one before the Montgomery
modes, which had no ``k`` and mode arguments) as ``parent`` and times it
first and last, around the variants (``--only base``: the parent against
this tree alone). ``base`` is held bit-equal to the plain
twins, and ``parent``, ``gold_k4``, ``threads1024`` and ``no_swizzle`` to
``base``; the others compute wrong words: only their times mean
anything. Exits non-zero without a CUDA device.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (old, new) source edits of each variant.
_GOLD_K4 = [("constexpr int kFullClusterLogN = 16;",
             "constexpr int kFullClusterLogN = 17;"),
            ("    case 24 + 0: return kernel<3, 0, TW, CANON>(fwd);",
             "    case 24 + 0: return kernel<3, 0, TW, CANON>(fwd);\n"
             "    case 16 + 0: return kernel<2, 0, TW, CANON>(fwd);")]
_WARPS32 = [("constexpr int kLogWords = 5;", "constexpr int kLogWords = 4;"),
            ("constexpr int kMaxThreads = 512;",
             "constexpr int kMaxThreads = 1024;")]
_ADD_TWIDDLE = ("  const u64* k = reinterpret_cast<const u64*>(&t);\n"
                "  a += k[0];\n  b += k[sizeof(t) / 8 - 1];")
VARIANTS = {
    "base": [],
    "gold_k4": _GOLD_K4,
    "threads1024": _WARPS32,
    "no_swizzle": [("int swz(int i) { return i ^ ((i >> 4) & 15); }",
                    "int swz(int i) { return i; }")],
    "compute_only": [
        ("    return T{__ldg(w + e), __ldg(wp + e)};",
         "    return T{(u64)e, ~(u64)e};"),
        ("    const ulonglong2 v =\n"
         "        __ldg(reinterpret_cast<const ulonglong2*>(w + e + kk));\n"
         "    const ulonglong2 vp =\n"
         "        __ldg(reinterpret_cast<const ulonglong2*>(wp + e + kk));",
         "    const ulonglong2 v = make_ulonglong2(e + kk, e);\n"
         "    const ulonglong2 vp = make_ulonglong2(~e, kk);"),
        ("        const ulonglong2 v = p[k];",
         "        const ulonglong2 v = make_ulonglong2(base, k);"),
        ("      for (int k = 0; k < W; ++k) x[k] = "
         "sh[swz(base) ^ swz(k << logt)];",
         "      for (int k = 0; k < W; ++k) x[k] = base + k;"),
        ("    for (int k = 0; k < W; ++k) "
         "sh[swz(base) ^ swz(k << logt)] = x[k];",
         "    for (int k = 0; k < W; ++k) if (x[k] == 12345) sh[k] = 0;"),
        ("    *reinterpret_cast<ulonglong2*>(dst + 2 * p) = "
         "make_ulonglong2(lo, hi);",
         "    if (lo == 12345) "
         "*reinterpret_cast<ulonglong2*>(dst + 2 * p) = v;"),
        ("  const ulonglong2 v = "
         "*reinterpret_cast<const ulonglong2*>(sh + (at & ~1));",
         "  const ulonglong2 v = make_ulonglong2(at, p);"),
        ("        v[it][i] = entry<CANON>(\n"
         "            src[j0 + (h + it) * blockDim.x + (long long)i * t], "
         "pre, tw);",
         "        v[it][i] = j0 + it + i;"),
        ("        X::store(sh, j0 + (h + it) * blockDim.x, i, t, v[it][i]);",
         "        if (v[it][i] == 12345) sh[i] = 0;"),
        ("        v[it][i] = X::load(sh, j0 + (h + it) * blockDim.x, i, t);",
         "        v[it][i] = j0 + it + i;"),
        ("        dst[j0 + (h + it) * blockDim.x + (long long)i * t] = o;",
         "        if (o == 12345) "
         "dst[j0 + (h + it) * blockDim.x + (long long)i * t] = o;")],
    # the twiddle words (the pair of a Shoup twiddle) added, for either form
    "no_butterflies": [
        ("  const u64 U = a, V = tw.mul(b, t);\n"
         "  a = cond_sub(U + V, 2 * tw.q);\n"
         "  b = cond_sub(U + 2 * tw.q - V, 2 * tw.q);",
         _ADD_TWIDDLE),
        ("  const u64 U = a, V = b;\n"
         "  b = tw.mul(cond_sub(U + 2 * tw.q - V, 2 * tw.q), t);\n"
         "  a = cond_sub(U + V, 2 * tw.q);",
         _ADD_TWIDDLE)],
}


# The variants of ntt.cu that keep the port's words.
RIGHT_WORDS = ("base", "parent", "gold_k4", "threads1024", "no_swizzle")


# (label, logN, P, C, [(K, G, held), ...], [(K, G, held), ...]): #4 at the
# multiply's level-1 shapes, base at the first geometries and every variant
# at the second; G None: the wrapper's own choice at that K and held.
MULACC_CASES = [
    ("silver P=9 C_sp=18", 15, 9, 18,
     [(2, 3, 1), (2, None, 1), (4, None, 1), (8, None, 1), (8, 3, 1),
      (8, None, 3)], [(8, None, 2)]),
    ("bronze P=7 C_sp=8", 14, 7, 8,
     [(1, None, 1), (2, None, 1), (8, None, 1), (4, None, 2)],
     [(4, None, 1)]),
]


# (old, new) edits of ntt_mulacc.cu's variants: base; the key products
# without the key loads, without the reads of the sums (each part
# overwrites them), or with none of them (the transforms alone); without
# the combine launch; the combine launched plainly (no_pdl, below).
_PRODUCTS = """      ulonglong2 r0, r1;
      for (int j = 0; j < r; ++j) {
        u64 lo, hi;
        word_pair(sh + j * M, i, lo, hi);
        const ulonglong2 e0 =
            __ldcs(reinterpret_cast<const ulonglong2*>(kc0 + (p + j) * k_sp) +
                   i);
        const ulonglong2 e1 =
            __ldcs(reinterpret_cast<const ulonglong2*>(kc1 + (p + j) * k_sp) +
                   i);
        const ulonglong2 t0 = make_ulonglong2(montmul(lo, e0.x, q, kq),
                                              montmul(hi, e0.y, q, kq));
        const ulonglong2 t1 = make_ulonglong2(montmul(lo, e1.x, q, kq),
                                              montmul(hi, e1.y, q, kq));
        if (j == 0) {
          r0 = t0;
          r1 = t1;
        } else {
          r0 = make_ulonglong2(cond_sub(r0.x + t0.x, q2),
                               cond_sub(r0.y + t0.y, q2));
          r1 = make_ulonglong2(cond_sub(r1.x + t1.x, q2),
                               cond_sub(r1.y + t1.y, q2));
        }
      }
      if (p > p0) {
        const ulonglong2 f0 = __ldcg(s0 + i), f1 = __ldcg(s1 + i);
        r0 = make_ulonglong2(cond_sub(f0.x + r0.x, q2),
                             cond_sub(f0.y + r0.y, q2));
        r1 = make_ulonglong2(cond_sub(f1.x + r1.x, q2),
                             cond_sub(f1.y + r1.y, q2));
      }
      __stcg(s0 + i, r0);
      __stcg(s1 + i, r1);"""
MULACC_VARIANTS = {
    "base": [],
    "transforms_only": [(_PRODUCTS, """      u64 lo, hi;
      word_pair(sh, i, lo, hi);
      if (lo == 12345) __stcg(s0 + i, make_ulonglong2(lo, hi));""")],
    "no_key_loads": [
        ("""        const ulonglong2 e0 =
            __ldcs(reinterpret_cast<const ulonglong2*>(kc0 + (p + j) * k_sp) +
                   i);
        const ulonglong2 e1 =
            __ldcs(reinterpret_cast<const ulonglong2*>(kc1 + (p + j) * k_sp) +
                   i);""", """        const ulonglong2 e0 = make_ulonglong2(hi, lo);
        const ulonglong2 e1 = make_ulonglong2(lo, kq);""")],
    "no_sum_reads": [("      if (p > p0) {\n", "      if (p < 0) {\n")],
    "no_combine": [("  if (G > 1) {\n    const long long CN",
                    "  if (G < 0) {\n    const long long CN")],
}
# the combine as a plain launch after the main kernel
MULACC_VARIANTS["no_pdl"] = [
    ("""    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(kCombineThreads, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(&cfg, mulacc_combine, (u64*)d0, (u64*)d1,
                                 (const u64*)part, G - 1, logN, CN,
                                 (const u64*)q);
    if (rc != 0) return rc;""",
     """    mulacc_combine<<<(unsigned)blocks, kCombineThreads, 0,
                     (cudaStream_t)stream>>>((u64*)d0, (u64*)d1,
                                             (const u64*)part, G - 1, logN,
                                             CN, (const u64*)q);"""),
    ("""  asm volatile("griddepcontrol.wait;" ::: "memory");\n""", "")]
MULACC_RIGHT_WORDS = ("base", "parent", "no_pdl")


def mulacc_sweep(dev, gen, parent=None, only=None):
    """#4 at each (K, G) of MULACC_CASES, the wrapper's geometry first and
    last, beside the split route on the same words; then each variant of
    MULACC_VARIANTS (those of ``only``, or all) and the parent's at the
    wrapper's geometry, the parent first and last."""
    import torch

    import chip_smoke
    from liberate_tpu_torch import _build
    from liberate_tpu_torch.ntt import cuda_ntt

    _build.build(["ntt", "ksk_mulacc", "ntt_mulacc"])
    libs = build_variants(REPO / "build" / "bfly_variants" / "mulacc",
                          "ntt_mulacc.cu", MULACC_VARIANTS, only, parent)
    fns = {}
    for name, path in libs.items():
        f = ctypes.CDLL(str(path)).ltt_ntt_mulacc
        P_, L_, I_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # the parent's multi-launch kernel took a [P, C, N] scratch and
        # chose its own launch
        f.argtypes = ([P_, L_, L_, P_, I_, I_, I_, P_, P_, P_, P_, P_, P_, L_,
                       L_, P_, P_, P_] if name == "parent"
                      else cuda_ntt._ARGTYPES["ltt_ntt_mulacc"])
        f.restype = ctypes.c_int
        fns[name] = f
    stream = torch.cuda.current_stream().cuda_stream
    for label, logN, P, C, grid, vgrid in MULACC_CASES:
        plan = cuda_ntt.prime_plan(logN, C, dev)
        N = 1 << logN
        x, k0, k1 = (chip_smoke.random_words(plan.q, (P, C, N), gen,
                                             lazy=True) for _ in range(3))
        want = torch.stack(cuda_ntt.ntt_mulacc_plain(x, k0, k1, plan, 0, 0))
        got = torch.stack(cuda_ntt.ntt_mulacc(x, k0, k1, plan, 0, 0))
        if not torch.equal(got, want):
            raise AssertionError(f"#4 [{label}] differs from its twin")
        y = torch.empty_like(x)

        def split():
            return cuda_ntt.ksk_mulacc(cuda_ntt.ntt_fwd(x, plan), k0, k1,
                                       plan, 0, 0)

        for name, f in (("split route (#1 B=P, then #3)", split),
                        ("#1 B=P alone", lambda: cuda_ntt.ntt_fwd(x, plan)),
                        ("#3 alone",
                         lambda: cuda_ntt.ksk_mulacc(y, k0, k1, plan, 0, 0))):
            ms = chip_smoke.cuda_ms(f, 100)
            print(f"{label} {name}: {ms[0]:.4f} ms (min {ms[1]:.4f}, max "
                  f"{ms[2]:.4f})")
        own = cuda_ntt.mulacc_geometry(logN, P, C)
        runs = [("base", own["K"], None, own["held"]),
                *(("base", *kgh) for kgh in grid),
                *((n, *kgh) for n in libs if n not in ("base", "parent")
                  for kgh in vgrid)]
        if "parent" in libs:
            runs = [("parent", None, None, None)] + runs
        runs.append(("base", own["K"], None, own["held"]))
        for name, K, G, held in runs:
            d = torch.empty((2, C, N), dtype=torch.int64, device=dev)
            if name == "parent":
                scratch = torch.empty_like(x)
                args = (scratch.data_ptr(), P, C, logN)
                what = "parent"
            else:
                geo = cuda_ntt.mulacc_geometry(logN, P, C, K, G, held)
                K, G = geo["K"], geo["G"]
                scratch = torch.empty((max(G - 1, 1), 2, C, N),
                                      dtype=torch.int64, device=dev)
                args = (scratch.data_ptr(), P, G, held, C, logN,
                        K.bit_length() - 1)
                what = (f"{name} K={K} G={G} held={held} ({geo['ctas']} "
                        f"CTAs of {geo['threads']} threads, "
                        f"{geo['per_sm']} an SM)")

            def run(f=fns[name], args=args, d=d, what=what,
                    keep=scratch):
                # no canon pre-stage (a null ident) but in the parent's
                # interface, which had none
                ident = () if name == "parent" else (None,)
                rc = f(x.data_ptr(), x.stride(0), x.stride(1), *args,
                       plan.w.data_ptr(), plan.wp.data_ptr(),
                       plan.q.data_ptr(), plan.k.data_ptr(), *ident,
                       k0.data_ptr(), k1.data_ptr(), k0.stride(0),
                       k0.stride(1), d[0].data_ptr(), d[1].data_ptr(),
                       stream)
                if rc != 0:
                    raise RuntimeError(f"#4 {what}: launch error {rc}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(d, want)
            if name in MULACC_RIGHT_WORDS and not same:
                raise AssertionError(f"#4 [{label}] {what} differs from its "
                                     f"twin")
            ms = chip_smoke.cuda_ms(run, 100)
            print(f"{label} #4 {what}: {ms[0]:.4f} ms (min {ms[1]:.4f}, max "
                  f"{ms[2]:.4f}){', bit-equal to the twin' if same else ''}")


def build_variants(out, source, variants, only=None, parent=None):
    """One library of csrc/``source`` per variant of ``variants`` (those of
    ``only``, or all; always ``base``), each edit applied once to the
    source and the headers together, and with ``parent`` (an earlier
    tree) that tree's ``source`` as ``parent``: {name: path}."""
    from liberate_tpu_torch import _build

    csrc = REPO / "liberate_tpu_torch" / "csrc"
    base = {f.name: f.read_text()
            for f in [csrc / source, *sorted(csrc.glob("*.cuh"))]}
    dirs = {}
    for name, edits in variants.items():
        if only and name not in only and name != "base":
            continue
        texts = dict(base)
        for old, new in edits:
            hits = [f for f, t in texts.items() if old in t]
            if len(hits) != 1 or texts[hits[0]].count(old) != 1:
                raise RuntimeError(f"{name}: the edit {old!r} does not apply")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, t in texts.items():
            (d / f).write_text(t)
        dirs[name] = d
    if parent is not None:
        d = out / "parent"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(Path(parent) / "liberate_tpu_torch" / "csrc", d)
        dirs["parent"] = d
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
         str(d / source)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            if name == "base":
                raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
            print(f"  {name}: nvcc exit {p.returncode}, left out\n"
                  f"{log[-2000:]}")
            del dirs[name]
            continue
        for line in log.splitlines():
            if "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"  ptxas[{name}] {line.strip()}")
    return {name: d / "lib.so" for name, d in dirs.items()}


def build(out, parent=None, only=None):
    """The variants of ntt.cu (those of ``only``, or all): {name: path}."""
    return build_variants(out, "ntt.cu", VARIANTS, only, parent)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose ntt.cu to time "
                                     "first and last")
    ap.add_argument("--only", nargs="*", help="the variants to build and "
                                              "time (default: all)")
    ap.add_argument("--mulacc", action="store_true",
                    help="time the unsplit switch core at a few cluster "
                         "sizes and part groups instead")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bfly_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from liberate_tpu_torch.ntt import cuda_ntt

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    if opts.mulacc:
        mulacc_sweep(dev, gen, opts.parent, opts.only)
        return 0
    libs = build(REPO / "build" / "bfly_variants", opts.parent, opts.only)
    plans = {logN: cuda_ntt.prime_plan(logN, C, dev)
             for logN, C in ((15, 18), (16, 38))}
    # (label, logN, B, C, inverse, scalars, post_reduce): the multiply's
    # transforms at level 1 (chip_smoke.py's kernel phase)
    shapes = [("silver fwd B=4 C=16 enter", 15, 4, 16, False, "enter", 0),
              ("silver fwd B=9 C=18", 15, 9, 18, False, None, 0),
              ("silver inv B=3 C=16 exit+reduce", 15, 3, 16, True,
               "ninv_exit", 1),
              ("silver inv B=2 C=18 reduce", 15, 2, 18, True, "ninv", 1),
              ("gold fwd B=4 C=34 enter", 16, 4, 34, False, "enter", 0),
              ("gold fwd B=10 C=38", 16, 10, 38, False, None, 0),
              ("gold inv B=3 C=34 exit+reduce", 16, 3, 34, True,
               "ninv_exit", 1),
              ("gold inv B=2 C=38 reduce", 16, 2, 38, True, "ninv", 1)]
    cases = []
    for label, logN, B, C, inverse, scal, red in shapes:
        plan = plans[logN].slice(0, C)
        x = chip_smoke.random_words(plan.q, (B, C, 1 << logN), gen,
                                    lazy=scal != "enter")
        want = (cuda_ntt.ntt_inv(x, plan, scal == "ninv_exit", bool(red))
                if inverse else cuda_ntt.ntt_fwd(x, plan, scal == "enter"))
        twin = (cuda_ntt.ntt_inv_plain(x, plan, scal == "ninv_exit",
                                       bool(red)) if inverse
                else cuda_ntt.ntt_fwd_plain(x, plan, scal == "enter"))
        if not torch.equal(want, twin):
            raise AssertionError(f"{label}: the kernel differs from its twin")
        cases.append((label, plan, x, inverse, scal, red, want))
        ms = chip_smoke.cuda_ms(x.clone, 100)
        print(f"{label}: x.clone() of {8 * x.numel()} bytes {ms[0]:.4f} ms "
              f"(min {ms[1]:.4f}, max {ms[2]:.4f})")
    order = [n for n in VARIANTS if n in libs] + ["base"]
    # A parent from before the Montgomery modes takes no k and no mode.
    old_iface = bool(opts.parent) and "int pre," not in (
        Path(opts.parent) / "liberate_tpu_torch" / "csrc" / "ntt.cu"
    ).read_text()
    if opts.parent:
        order = ["parent"] + order + ["parent"]
    fns = {}
    for name in order:
        if name not in fns:
            lib = ctypes.CDLL(str(libs[name]))
            fns[name] = (lib.ltt_ntt_fwd, lib.ltt_ntt_inv)
            for f in fns[name]:
                f.argtypes = cuda_ntt._ARGTYPES["ltt_ntt_fwd"]
                if name == "parent" and old_iface:
                    f.argtypes = f.argtypes[:10] + f.argtypes[11:13] + \
                        f.argtypes[14:]
                f.restype = ctypes.c_int
        for label, plan, x, inverse, scal, red, want in cases:
            y = torch.empty_like(x)
            w, wp = (plan.iw, plan.iwp) if inverse else (plan.w, plan.wp)
            s = getattr(plan, scal) if scal else None

            old = name == "parent" and old_iface
            k = () if old else (plan.k.data_ptr(),)
            mode = () if old else (int(s is not None and not inverse),)

            def run(fn=fns[name][inverse], x=x, y=y, w=w, wp=wp, s=s,
                    red=red, plan=plan, k=k, mode=mode):
                rc = fn(x.data_ptr(), x.stride(0), x.stride(1), y.data_ptr(),
                        x.shape[0], x.shape[1], plan.logN, w.data_ptr(),
                        wp.data_ptr(), plan.q.data_ptr(), *k,
                        s[0].data_ptr() if s else None,
                        s[1].data_ptr() if s else None, *mode, red,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch error {rc}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(y, want)
            if name in RIGHT_WORDS and not same:
                raise AssertionError(f"{name} [{label}] differs from the "
                                     f"port's kernel")
            ms = chip_smoke.cuda_ms(run, 100)
            print(f"{name} [{label}]: {ms[0]:.4f} ms (min {ms[1]:.4f}, max "
                  f"{ms[2]:.4f}){'' if same else ', wrong words'}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("LIBERATE_TPU_TORCH_CACHE",
                          str(REPO / "build" / "liberate_tpu_torch" / "cache"))
    sys.exit(main())
