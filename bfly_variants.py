#!/usr/bin/env python3
"""Where the time of the butterfly transforms goes, on one NVIDIA GPU.

    python3 bfly_variants.py [--parent DIR] [--only NAME ...]

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

``--parent DIR`` also builds ``DIR/liberate_tpu_torch/csrc/ntt.cu`` (an
earlier tree with the same C interface) as ``parent`` and times it first
and last, around the variants. ``base`` is held bit-equal to the plain
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
            ("    case 24 + 0: return kernel<3, 0>(fwd);",
             "    case 24 + 0: return kernel<3, 0>(fwd);\n"
             "    case 16 + 0: return kernel<2, 0>(fwd);")]
_WARPS32 = [("constexpr int kLogWords = 5;", "constexpr int kLogWords = 4;"),
            ("constexpr int kMaxThreads = 512;",
             "constexpr int kMaxThreads = 1024;")]
VARIANTS = {
    "base": [],
    "gold_k4": _GOLD_K4,
    "threads1024": _WARPS32,
    "no_swizzle": [("int swz(int i) { return i ^ ((i >> 4) & 15); }",
                    "int swz(int i) { return i; }")],
    "compute_only": [
        ("    t[0] = __ldg(wc + e);\n    tp[0] = __ldg(wpc + e);",
         "    t[0] = e;\n    tp[0] = ~e;"),
        ("      const ulonglong2 v =\n"
         "          __ldg(reinterpret_cast<const ulonglong2*>(wc + e + kk));\n"
         "      const ulonglong2 vp =\n"
         "          __ldg(reinterpret_cast<const ulonglong2*>(wpc + e + kk));",
         "      const ulonglong2 v = make_ulonglong2(e + kk, e);\n"
         "      const ulonglong2 vp = make_ulonglong2(~e, kk);"),
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
        ("    const ulonglong2 v = "
         "*reinterpret_cast<const ulonglong2*>(sh + (at & ~1));",
         "    const ulonglong2 v = make_ulonglong2(at, p);"),
        ("        v[it][i] = "
         "src[j0 + (h + it) * blockDim.x + (long long)i * t];",
         "        v[it][i] = j0 + it + i;"),
        ("        X::store(sh, j0 + (h + it) * blockDim.x, i, t, v[it][i]);",
         "        if (v[it][i] == 12345) sh[i] = 0;"),
        ("        v[it][i] = X::load(sh, j0 + (h + it) * blockDim.x, i, t);",
         "        v[it][i] = j0 + it + i;"),
        ("        dst[j0 + (h + it) * blockDim.x + (long long)i * t] = o;",
         "        if (o == 12345) "
         "dst[j0 + (h + it) * blockDim.x + (long long)i * t] = o;")],
    "no_butterflies": [
        ("  const u64 U = a, V = shoup(b, w, wp, nq);\n"
         "  a = cond_sub(U + V, 2 * q);\n  b = cond_sub(U + 2 * q - V, 2 * q);",
         "  a += w;\n  b += wp;"),
        ("  const u64 U = a, V = b;\n"
         "  b = shoup(cond_sub(U + 2 * q - V, 2 * q), w, wp, nq);\n"
         "  a = cond_sub(U + V, 2 * q);",
         "  a += w;\n  b += wp;")],
}


# The variants that compute the port's words.
RIGHT_WORDS = ("base", "parent", "gold_k4", "threads1024", "no_swizzle")


def build(out, parent=None, only=None):
    """One library of ntt.cu per variant (those of ``only``, or all):
    {name: path}."""
    from liberate_tpu_torch import _build

    csrc = REPO / "liberate_tpu_torch" / "csrc"
    base = (csrc / "ntt.cu").read_text()
    dirs = {}
    for name, edits in VARIANTS.items():
        if only and name not in only and name != "base":
            continue
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit {old!r} does not apply")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.glob("*.cuh"):
            shutil.copy(f, d / f.name)
        (d / "ntt.cu").write_text(text)
        dirs[name] = d
    if parent is not None:
        d = out / "parent"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(Path(parent) / "liberate_tpu_torch" / "csrc", d)
        dirs["parent"] = d
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
         str(d / "ntt.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
        for line in log.splitlines():
            if "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"  ptxas[{name}] {line.strip()}")
    return {name: d / "lib.so" for name, d in dirs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose ntt.cu to time "
                                     "first and last")
    ap.add_argument("--only", nargs="*", help="the variants to build and "
                                              "time (default: all)")
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
    libs = build(REPO / "build" / "bfly_variants", opts.parent, opts.only)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
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
    if opts.parent:
        order = ["parent"] + order + ["parent"]
    fns = {}
    for name in order:
        if name not in fns:
            lib = ctypes.CDLL(str(libs[name]))
            fns[name] = (lib.ltt_ntt_fwd, lib.ltt_ntt_inv)
            for f in fns[name]:
                f.argtypes = cuda_ntt._ARGTYPES["ltt_ntt_fwd"]
                f.restype = ctypes.c_int
        for label, plan, x, inverse, scal, red, want in cases:
            y = torch.empty_like(x)
            w, wp = (plan.iw, plan.iwp) if inverse else (plan.w, plan.wp)
            s = getattr(plan, scal) if scal else None

            def run(fn=fns[name][inverse], x=x, y=y, w=w, wp=wp, s=s,
                    red=red, plan=plan):
                rc = fn(x.data_ptr(), x.stride(0), x.stride(1), y.data_ptr(),
                        x.shape[0], x.shape[1], plan.logN, w.data_ptr(),
                        wp.data_ptr(), plan.q.data_ptr(),
                        s[0].data_ptr() if s else None,
                        s[1].data_ptr() if s else None, red,
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
