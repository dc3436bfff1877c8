#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--compile-yardstick]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ``liberate_tpu_torch/csrc`` with
   nvcc for sm_90a (into ``build/liberate_tpu_torch``).
3. Holds every kernel against its plain PyTorch twin on the same CUDA
   inputs at the silver shapes of the multiply, bit for bit, and times
   both with CUDA events beside the kernel's bound.
4. Runs the whole path at logN 8 on the card and on the CPU (twins) from
   one seed: the keys and ciphertexts must be identical words.
5. Drives the silver path (keygen -> 2 x encorypt -> mult -> decrode)
   through the public API with the launch counters zeroed just before;
   every kernel must have launched, the multiply must have launched all
   three, and the decoded error must be < 1e-4. Times mult.
6. Prints the kernels' JSON line and, last, the result line.

``--compile-yardstick`` also times ``torch.compile`` of the
``ksk_mulacc`` twin as that kernel's ``library_ms`` (the compile takes
30-50 s); without it ``library_ms`` is null for every kernel, as no single
PyTorch call computes these functions.

Exits non-zero, with no result line, when there is no CUDA device or the
port's package is not beside this script.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 20260816
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds per second: 64 INT32 lanes per SM, half the
# 128 FP32 lanes behind the data sheet's 67 TFLOP/s (= 2 x FMA rate).
INT32_MULS_PER_S = 67e12 / 4
# 32-bit multiplies of one 64-bit modular product: a 64x64 high half
# needs 4 wide partial products, a 64x64 low half 3.
SHOUP_MULS = 4 + 3 + 3      # mulhi(x, wp), x*w, hi*q
MONT_MULS = 4 + 3 + 4       # a*b (128 bit), m = lo*k, m*q (128 bit)
# Spin ahead of each timed call: ~1 ms at the H100's 1.98 GHz boost clock.
SPIN_CYCLES = 2_000_000


def cuda_ms(fn, reps, warmup=5):
    """(median, min, max) of ``reps`` CUDA-event timings of fn(), in ms,
    after ``warmup`` untimed calls. A spin kernel ahead of each start event
    keeps the card busy while the host enqueues fn's launches, so the events
    time the card's work and not the wrapper's host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), min(times), max(times)


def bound(bytes_moved, int32_muls):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = int32_muls / INT32_MULS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_words(q, shape, gen, lazy=False):
    """Uniform words below each channel's modulus q, or below 2q where the
    path feeds the kernel lazily reduced words (``lazy``); q: [C] on the
    device."""
    import torch

    r = torch.randint(0, 1 << 62, shape, generator=gen, device=q.device,
                      dtype=torch.int64)
    return r % (q[:, None] * (2 if lazy else 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compile-yardstick", action="store_true",
                    help="time torch.compile of the ksk_mulacc twin as its "
                         "library_ms")
    opts = ap.parse_args()
    if opts.compile_yardstick:
        # torch.compile compiles in this process instead of a pool of
        # worker processes that could outlive the script.
        os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "liberate_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: liberate_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("LIBERATE_TPU_TORCH_CACHE",
                          str(REPO / "build" / "liberate_tpu_torch" / "cache"))

    import liberate_tpu_torch
    from liberate_tpu_torch import _build
    from liberate_tpu_torch.ntt import cuda_ntt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {time.perf_counter() - t:.2f} s "
          f"({', '.join(p.name for p in libs.values())})")
    for name, p in libs.items():
        log = p.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"  ptxas[{name}] {line.strip()}")

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # -- 3. kernels against their twins at the silver shapes ---------------------
    t = time.perf_counter()
    eng = liberate_tpu_torch.CkksEngine(**liberate_tpu_torch.params["silver"],
                                        seed=SEED)
    print(f"silver engine (context, tables): "
          f"{time.perf_counter() - t:.2f} s")
    level = 1
    pack = eng.pack(level, -1)
    pack_sp = eng.pack(level, -2)
    parts = eng.ntt.parts(level)
    C, C_sp, P = pack.q.shape[0], pack_sp.q.shape[0], len(parts)
    N, logN = eng.ctx.N, eng.ctx.logN
    C0_sp = eng.ntt.total_channels
    print(f"silver shapes at level {level}: N={N} C={C} C_sp={C_sp} P={P} "
          f"C0_sp={C0_sp} part_off={parts[0].part_id}")

    k0 = random_words(eng.pack(0, -2).q, (len(eng.ntt.parts(0)), C0_sp, N),
                      gen, lazy=True)
    k1 = random_words(eng.pack(0, -2).q, k0.shape, gen, lazy=True)
    cases = [
        ("ntt_fwd", f"B=4 C={C} pre_enter (_cc_mult_core)",
         (random_words(pack.q, (4, C, N), gen), pack.plan),
         dict(pre_enter=True)),
        ("ntt_fwd", f"B={P} C={C_sp} (switch extension)",
         (random_words(pack_sp.q, (P, C_sp, N), gen, lazy=True),
          pack_sp.plan), {}),
        ("ntt_inv", f"B=3 C={C} exit+reduce (_relin_pre)",
         (random_words(pack.q, (3, C, N), gen, lazy=True), pack.plan),
         dict(post_exit=True, post_reduce=True)),
        ("ntt_inv", f"B=2 C={C_sp} reduce (intt_reduce)",
         (random_words(pack_sp.q, (2, C_sp, N), gen, lazy=True),
          pack_sp.plan),
         dict(post_reduce=True)),
        ("ksk_mulacc", f"P={P} C={C_sp} level={level}",
         (random_words(pack_sp.q, (P, C_sp, N), gen, lazy=True), k0, k1,
          pack_sp.plan, level, parts[0].part_id), {}),
    ]
    kernels = {"ntt_fwd": (cuda_ntt.ntt_fwd, cuda_ntt.ntt_fwd_plain,
                           "liberate_tpu_torch/csrc/ntt.cu",
                           "liberate_tpu/ntt/pallas_ntt.py:534"),
               "ntt_inv": (cuda_ntt.ntt_inv, cuda_ntt.ntt_inv_plain,
                           "liberate_tpu_torch/csrc/ntt.cu",
                           "liberate_tpu/ntt/pallas_ntt.py:577"),
               "ksk_mulacc": (cuda_ntt.ksk_mulacc, cuda_ntt.ksk_mulacc_plain,
                              "liberate_tpu_torch/csrc/ksk_mulacc.cu",
                              "liberate_tpu/ntt/pallas_ntt.py:693")}
    rows = {}
    for name, label, args, kw in cases:
        fn, twin, src, replaces = kernels[name]
        got = fn(*args, **kw)
        want = twin(*args, **kw)
        got = torch.stack(got) if isinstance(got, tuple) else got
        want = torch.stack(want) if isinstance(want, tuple) else want
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} [{label}]: kernel != twin "
                                 f"(max |diff| {err})")
        ms, ms_lo, ms_hi = cuda_ms(lambda: fn(*args, **kw), 100)
        plain_ms = cuda_ms(lambda: twin(*args, **kw), 3, warmup=1)[0]
        library_ms = None
        if name == "ksk_mulacc" and opts.compile_yardstick:
            # Yardstick only, used nowhere in the port: what torch.compile
            # makes of the plain twin (no PyTorch call computes a modular
            # product of 62-bit words).
            t = time.perf_counter()
            compiled = torch.compile(twin)
            if not torch.equal(torch.stack(compiled(*args)), want):
                raise AssertionError("compiled ksk_mulacc twin differs")
            print(f"  torch.compile of the twin: "
                  f"{time.perf_counter() - t:.1f} s")
            library_ms = cuda_ms(lambda: compiled(*args), 100)[0]
        if name == "ksk_mulacc":
            x = args[0]
            words = x.numel() * 3 + 2 * C_sp * N
            b_ms, b_by = bound(8 * words, 2 * x.numel() * MONT_MULS)
        else:
            x = args[0]
            B = x.shape[0]
            cx = x.shape[1]
            muls = B * cx * (N // 2) * logN
            if name == "ntt_inv" or kw.get("pre_enter"):
                muls += B * cx * N          # the exit or entry multiply
            b_ms, b_by = bound(8 * (2 * x.numel() + 2 * cx * N),
                               muls * SHOUP_MULS)
        print(f"{name} [{label}]: bit-equal to twin; kernel {ms:.4f} ms "
              f"(min {ms_lo:.4f}, max {ms_hi:.4f}), twin {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"library {library_ms} ms")
        if name not in rows:
            rows[name] = dict(name=name, route="cuda", source=src,
                              replaces=replaces, launches=0,
                              max_abs_err=float(err), ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=library_ms)

    # -- 4. the path at logN 8: card against the CPU twins -----------------------
    small = dict(logN=8, scale_bits=30, num_scales=8, num_special_primes=2,
                 is_secured=False, seed=SEED)
    outs = []
    for device in ("cuda:0", "cpu"):
        e = liberate_tpu_torch.CkksEngine(device=device, **small)
        sk = e.create_secret_key()
        pk = e.create_public_key(sk)
        evk = e.create_evk(sk)
        m = (torch.arange(e.num_slots, dtype=torch.float64) / e.num_slots
             ).numpy()
        ct = e.encorypt(m, pk)
        ctm = e.mult(ct, ct, evk)
        outs.append([t.to("cpu") for t in (sk.data, *pk.data, *ct.data,
                                           *ctm.data)])
        err = abs(e.absmax_error(e.decrode(ctm, sk), m * m))
        if not err < 1e-5:
            raise AssertionError(f"logN 8 on {device}: mult error {err}")
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("logN 8: the card's keys or ciphertexts "
                             "differ from the CPU twins'")
    print("logN 8 path: card and CPU twins give identical keys and "
          "ciphertexts")

    # -- 5. the silver path through the public API --------------------------------
    cuda_ntt.reset_launches()
    t = time.perf_counter()
    sk = eng.create_secret_key()
    pk = eng.create_public_key(sk)
    evk = eng.create_evk(sk)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t
    rng = np.random.default_rng(SEED)
    m1 = rng.uniform(-1, 1, eng.num_slots) + 1j * rng.uniform(
        -1, 1, eng.num_slots)
    m2 = rng.uniform(-1, 1, eng.num_slots) + 1j * rng.uniform(
        -1, 1, eng.num_slots)
    ct1 = eng.encorypt(m1, pk)
    ct2 = eng.encorypt(m2, pk)
    before = dict(cuda_ntt.launches)
    ctm = eng.mult(ct1, ct2, evk)
    torch.cuda.synchronize()
    during = {k: cuda_ntt.launches[k] - before[k] for k in before}
    dec = eng.decrode(ctm, sk)
    path_launches = dict(cuda_ntt.launches)
    err = abs(eng.absmax_error(dec, m1 * m2))
    print(f"silver path: keys {t_keys:.2f} s, mult -> level {ctm.level}, "
          f"|err| {err:.3e}, launches {path_launches}, "
          f"in mult {during}")
    for c in ctm.data:
        if tuple(c.shape) != (C, N) or c.device.type != "cuda":
            raise AssertionError(f"mult output shape {tuple(c.shape)}")
    if not err < 1e-4:
        raise AssertionError(f"silver mult error {err} >= 1e-4")
    for k, v in during.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched by mult")
    for k, v in path_launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched on the path")
        rows[k]["launches"] = v

    times = []
    eng.mult(ct1, ct2, evk)
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.mult(ct1, ct2, evk)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    print(f"silver mult: median {statistics.median(times):.3f} ms over "
          f"{len(times)} runs (min {min(times):.3f}, max {max(times):.3f}); "
          f"launches per mult {during}")

    # Where a mult's device time goes (torch.profiler; single stream, so
    # kernel times add up to the busy time).
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            eng.mult(ct1, ct2, evk)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    print(f"profile: {wall:.3f} ms/mult wall with the profiler on, device "
          f"busy {busy:.3f} ms/mult ({len(kern)} kernel names)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / reps:.4f} ms/mult "
              f"x{e.count // reps} {e.key[:100]}")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
