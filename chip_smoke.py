#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--compile-yardstick]

1. Prints the card's name and power limit (nvidia-smi) and the host CPU.
2. Builds the port's CUDA kernels from ``liberate_tpu_torch/csrc`` with
   nvcc for sm_90a (into ``build/liberate_tpu_torch``), one nvcc per
   source, all started together; prints ptxas's registers, stack and
   spills of every kernel entry (each instance of the tensor-core stage
   kernel among them; the butterfly kernels must not spill), holds the
   stage kernel's compiled geometry against ``cuda_mxu.stage_geometry``,
   the butterfly transforms' cluster geometry against
   ``cuda_ntt.bfly_geometry`` at logN 8-17 and the unsplit switch core's
   against ``cuda_ntt.mulacc_geometry`` at logN 8-15 and K = 1-8 (printing
   K, the threads and the shared bytes per logN, and the part groups at
   the silver and bronze shapes).
3. Builds the silver and gold contexts cold on the native host math
   (``liberate_tpu_torch/native``) and from the cache (``context_start``;
   at silver also its pure-Python twin, which must equal it field for
   field; at gold every prime checked in Python), and times the
   tensor-core (MXU) table build at silver, without and with the disk
   cache.
4. Holds every kernel against its plain PyTorch twin on the same CUDA
   inputs, bit for bit, and times both with CUDA events beside the
   kernel's bound, at the shapes of the multiply: at silver the butterfly
   kernels (``ntt_fwd``, ``ntt_inv``, ``ksk_mulacc``, the unsplit switch
   core ``ntt_mulacc``), the tensor-core transforms (``mxu_ntt_fwd``,
   ``mxu_ntt_inv``), the folded switch (``mxu_switch``, both modes), the
   Montgomery-key switch (``mxu_switch_inv_mont``) and the switch core
   from extension words (``mxu_ksk_accum``, ``mxu_ksk_accum_inv``); at gold
   (logN 16) the butterfly kernels #1-#3, the tensor-core transforms and
   the Shoup-key switch without the fold (``mxu_switch_inv``). At gold it
   also splits ``mxu_switch_inv`` and ``mxu_ntt_fwd`` by launch (profiler
   kernel events) and times ``torch._int_mm`` of one (6, 6) channel's
   forward stage-1 product of the switch as a yardstick of the int8
   product alone (the port never calls it). Then ``ntt_fwd`` and
   ``ntt_inv`` on plans of three of the 60-bit primes at logN 14 (one CTA
   per channel) and 17 (clusters of 8), built without a bronze or
   platinum engine. Beside each ``ntt_fwd``/``ntt_inv`` time it prints the
   same kernel's time with a cold L2 (a 128 MB scratch written before each
   launch) and that of ``x.clone()`` of its input, a yardstick of the
   memory floor that the port never calls; beside each ``ntt_mulacc``
   time that of the split route on the same words (``ntt_fwd`` at B=P,
   then ``ksk_mulacc``), its yardstick. At silver and gold also the B=1
   transforms the other operations add (``ops_kernel_phase``): the
   rotation key's inverse and forward of the level-0 secret key without
   the Montgomery exit or entry, ``mc_mult``'s at level 1 and the
   threshold decryption's inverse with the exit and without the reduce, in
   both domains. Then the switch kernels' ct-batched part segments
   (``segment_phase``, ``SEGMENTS``): #11 at silver (B = 2, 4, 8), #9 at
   silver (B = 4), #10 at gold (B = 2, 4), each held against its twin,
   each segment against its single-ciphertext call, and timed beside B
   single calls on the same words; and the batched mult's #5 (B = 4 Bct)
   and #6 (B = 3 Bct) shapes at silver (Bct = 4, 8) and gold (Bct = 4).
5. Runs the whole path at logN 8 on the card and on the CPU (twins) from
   one seed, in both NTT domains, with the Montgomery-form key and with the
   unsplit butterfly switch: the keys and ciphertexts must be identical
   words, and so must those of every other operation of the engine
   (``small_ops``: rotation, conjugation and Galois keys, add, sub,
   negate, the scalar and message operations, the switch of an NTT-state
   ciphertext, the rotations, sum, mean, cov, var, pow, sqrt,
   ``mult_batched``, and two parties' collective public key, evk,
   rotation and Galois keys, the threshold decryption's head and partial,
   mult under the collective evk and rotate_galois under the collective
   Galois key).
6. Drives the paths through the public API, each with the launch counters
   zeroed just before: keygen -> 2 x encorypt -> mult -> decrode at silver
   in each domain, with the unsplit butterfly switch
   (``use_split_switch=False``: ``ntt_mulacc``, no ``ksk_mulacc``) and in
   the tensor-core domain with the Montgomery-form key
   (``use_shoup_ksk=False``), and at gold in each domain: the multiply must
   launch the kernels of its path, the path no other kernel (the switch
   kernels are those ``butterfly_switch_route`` and ``switch_route``
   name), and the decoded error must be < 1e-4; the unsplit engine's mult
   of the split path's ciphertexts must equal the split mult word for
   word, and the two engines' mults are timed in turns (the host gap);
   then the standalone key switch on the unsplit engine
   (``mult(relin=False)``, ``relinearize``, ``square``, ``switch_key`` to a
   second key) and the tensor-core switch
   core from extension words (``_extend_shoup``, ``dispatch_ksk_accum``
   with and without ``fold_inverse``, ``_mod_down_shoup``) held word for
   word against the engine's own switch. Times each path's operation
   (median of 7) and profiles one (device time by kernel, host time by
   operator); prints each path's peak device memory. After each path's
   mult at silver and gold, ``ops_phase`` on its keys and ciphertexts:
   rotation and conjugation keys, add, sub, negate, mult by a float, an
   int and a message, add of a float and of a message, rotate_single and
   conjugate, each with the counters zeroed (decoded error < 1e-4; each
   launches exactly its kernels, a rotation those of the switch route),
   timed a line each; at silver ``galois_phase`` in both domains (the
   Galois key, rotate_galois, sum, mean, cov, var, pow, sqrt; decoded
   error < 1e-3, sqrt < 0.05) and ``rotate_check`` of the unsplit and
   Montgomery-key routes against the others' words. Then
   ``batched_phase``: ``mult_batched`` of Bct = 1, 2, 4, 8 pairs at silver
   (butterfly, a loop; tensor-core; tensor-core with the Montgomery-form
   key) and Bct = 1, 2, 4 at gold tensor-core, each with the counters
   zeroed: the words of per-pair mult, error < 1e-4, in the tensor-core
   domain one switch dispatch a batch; wall (median of 7) and busy per
   batch and per mult (the butterfly loop at Bct = 1 and 8 only), peak
   memory; ``multiparty_phase`` with three parties
   at silver in both domains and at gold tensor-core (the collective
   public key, evk and rotation key, mult and rotate_single under them,
   the threshold decryption < 1e-4, each step timed once, the engine's
   kernels and no other); ``data_phase`` on the card (save/load, clone,
   move_to). Then the engine sharded over 4 ranks at silver
   (``sharded_engine_phase``; ranks as threads on the card, C0_sp = 18
   padded to 20): keygen, encorypt, mult, level_up, rotate_single, three
   parties' threshold decryption and decrode, every key and ciphertext
   the single-device engine's words at the same seed, the mult launching
   4 times its kernels and no other, its wall and busy time; and after
   the gold paths the coefficient-sharded transforms at gold
   (``coef_shard_phase``, S = 4 and 8 ranks on the card): the forward
   with the entry and the inverse with the exit and reduce bit-equal to
   the single-device #1 and #2, S launches each of the local #1 and of #2
   in its no-normalise mode and no other kernel, each local kernel held
   against its twin (its own kernel-table rows, ``ntt_fwd_coef_shard``
   and ``ntt_inv_no_norm``), the sharded pair's wall. Then silver on every
   other mesh, 4 ranks as threads on the card (``mesh_engine_case``, as
   the sharded engine): ``mesh2d_engine_phase`` on a (2 rns x 2 coef) and
   a (1 x 4) mesh, the mult launching exactly the coefficient-sharded
   route's kernels (R times one device's, every inverse #2 in its
   no-normalise mode), then #3 on a shard's columns and the switch's
   local #1 and #2 at rank 0's shapes against their twins;
   ``mxu_mesh_phase``, the tensor-core engine on ``make_mesh(4)`` in both
   key forms with ``mult_batched`` of four pairs, its words mod q of the
   single-device tensor-core engine, each rank's mult launching #5 and #6
   once a width group of its rows and the unfolded switch (#10 or #9)
   once a width group of its with-special rows, never #11, then #10 and
   #9 at rank 0's rows against their twins; ``multiprocess_phase``, two
   processes of a gloo ``torch.distributed`` job on ``cuda:0``
   (``tests/torch_multihost_worker.py``: the sharded engine across them,
   and threshold decryption with one party a process), their wall. Then
   the four examples at silver (``examples_phase``: ``ckks_engine``,
   ``evaluators``, ``multiparty`` and ``multichip`` on 4 ranks as threads
   on the card), each with the counters zeroed: every error they print <
   1e-4, the kernels of their routes launched and no other, their wall.
7. Bronze (logN 14, one special prime) and platinum (logN 17, S = 512,
   six special primes), one preset after the other, each preset's
   engines freed before the next: the engines' start (the context as in
   3, at bronze with its twin, at platinum with the primes checked; the
   tensor-core tables built, with the build's
   peak device memory, written to the cache and read from it); every
   kernel of the preset's multiply against its twin at its level-1
   shapes (the butterfly #1-#3, #4 at bronze, the tensor-core transforms
   #5 and #6, the Shoup key's switch: #11 in both modes with n_sp = 1 at
   bronze, #10 at platinum, and #9 with the Montgomery-form key); at
   platinum the split of #10 and #5 by launch (in a fresh process); the
   paths butterfly, tensor-core and, at platinum, tensor-core with the
   Montgomery-form key, as in 6; at bronze also the unsplit butterfly path
   (``ntt_mulacc``), its mult held against the split one as in 6; after
   the butterfly and tensor-core paths ``ops_phase`` untimed; the segment
   rows #11 at bronze (B = 4) and #10 at platinum (B = 2); the batched
   mult untimed (bronze Bct = 4, platinum Bct = 2) with its peak memory.
8. Prints the timed phases, each preset's cold context beside the
   pure-Python one (the card line and the host CPU beside them) and the
   script's time, the card line, the kernels' JSON line and, last, the
   result line.

``--split-only PRESET`` runs only the split by launch at the preset; the
script runs platinum's so, in a process of its own.

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
# Dense int8 tensor-core operations per second (data sheet); one
# multiply-accumulate is two operations.
INT8_OPS_PER_S = 1.979e15
# 32-bit multiplies of one 64-bit modular product: a 64x64 high half
# needs 4 wide partial products, a 64x64 low half 3.
SHOUP_MULS = 4 + 3 + 3      # mulhi(x, wp), x*w, hi*q
BARRETT_MULS = 4 + 3        # mulhi(x, bp), hi*q
MONT_MULS = 4 + 3 + 4       # a*b (128 bit), m = lo*k, m*q (128 bit)
# Spin ahead of each timed call: ~1 ms at the H100's 1.98 GHz boost clock.
SPIN_CYCLES = 2_000_000
# The kernel launches of one mult of an unsplit butterfly engine.
UNSPLIT_PER_MULT = dict(ntt_fwd=1, ntt_mulacc=1, ntt_inv=2, ksk_mulacc=0)
# The switch kernels' ct-batched segment cases (kernel, B) at each preset.
SEGMENTS = {
    "silver": [("mxu_switch", 2), ("mxu_switch", 4), ("mxu_switch", 8),
               ("mxu_switch_inv_mont", 4)],
    "gold": [("mxu_switch_inv", 2), ("mxu_switch_inv", 4)],
    "bronze": [("mxu_switch", 4)],
    "platinum": [("mxu_switch_inv", 2)]}
SMALL = dict(logN=8, scale_bits=30, num_scales=8, num_special_primes=2,
             is_secured=False, seed=SEED)
# The multi-rank phases, ranks as threads on cuda:0.
SHARDED = "silver sharded engine"
COEF_SHARD = "gold coefficient-sharded transforms"
MESH2D = "silver 2-D mesh engine"
MXU_MESH = "silver tensor-core engine on an rns mesh"
MULTIPROCESS = "silver two-process job"
EXAMPLES = "silver examples"
# The pure-Python context's cold time at gold and platinum in earlier runs of
# this script on an H100's host; this run builds its twin only at bronze and
# silver.
PLAIN_COLD_EARLIER = {"gold": "15-20 s", "platinum": "44.20 s"}
# Ranks of the silver rns meshes; the 2-D meshes (rns, coef) of 4 ranks.
MESH_RANKS = 4
MESH2D_SHAPES = ((2, 2), (1, 4))
# Seconds for the two-process job and for each of its collectives.
MULTIPROCESS_TIMEOUT = 300.0


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


def cold_ms(fn, reps, scratch):
    """(median, min, max) of ``reps`` CUDA-event timings of fn() with a
    cold L2: ``scratch`` (larger than the 50 MB L2) is written before each
    launch, outside the timed events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), min(times), max(times)


def bound(bytes_moved, int32_muls, int8_macs=0):
    """(ms, what bounds it): the larger of the bytes over the memory rate,
    the 32-bit multiplies over the INT32 rate and the int8 tensor-core
    operations over the int8 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(int32_muls / INT32_MULS_PER_S,
                2 * int8_macs / INT8_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def recombine_muls(d):
    """32-bit multiplies of one recombination at d digits: the Barrett
    reduction of the low part, a Shoup product of the high part."""
    return BARRETT_MULS + (SHOUP_MULS if d > 5 else 0)


def mxu_table_bytes(d, S, R, N):
    """Bytes of one channel's tables for one transform: the two int8
    stage tables, their int32 row sums, the int64 twiddles."""
    return d * d * (S * S + R * R) + 4 * d * (S + R) + 8 * N


def mxu_ntt_work(groups, B, S, R):
    """(bytes, int32 multiplies, int8 MACs) of one transform of B
    polynomials over a layout's width groups: data read and written once,
    each channel's tables once; per element two recombinations and the
    twiddle product."""
    N = S * R
    by = muls = macs = 0
    for g in groups:
        C, d = g.hi - g.lo, g.plan.dA
        by += 16 * B * C * N + C * mxu_table_bytes(d, S, R, N)
        muls += B * C * N * (2 * recombine_muls(d) + MONT_MULS)
        macs += B * C * d * d * N * (S + R)
    return by, muls, macs


def mxu_switch_work(groups, P, A, n_sp, S, R, mont=False, from_ext=False,
                    inverse=True, B=1):
    """The same for the switch of one ciphertext: the state rows, the key
    of both halves for every part and channel (Shoup pairs, or ``mont``
    single Montgomery-form words), the forward and inverse tables and the
    output rows; P forward and 2 inverse transforms per channel, the
    extension and the key products. With ``n_sp`` the folded mod-down's
    steps and exported rows as well (0: the switch without the fold).
    ``from_ext``: the input is the extension's words [P, C, N] (no
    extension); ``inverse=False``: no inverse transforms, the key sums are
    the output. ``B``: the switches of B ciphertexts (ct segments) under
    one key, whose words and the tables are read once for all of them."""
    N = S * R
    key_words, key_muls = (2, MONT_MULS) if mont else (4, SHOUP_MULS)
    by = B * ((0 if from_ext else 8 * P * A * N) + 2 * 8 * 2 * n_sp * N)
    ext_muls = 0 if from_ext else BARRETT_MULS + (A - 1) * SHOUP_MULS
    inv = 2 if inverse else 0
    muls = macs = 0
    for g in groups:
        C, d = g.hi - g.lo, g.plan.dA
        tr = 2 * recombine_muls(d) + MONT_MULS
        by += C * (key_words * 8 * P * N
                   + (1 + inverse) * mxu_table_bytes(d, S, R, N)
                   + B * (from_ext * 8 * P * N + 2 * 8 * N))
        muls += B * C * N * (P * (ext_muls + tr + 2 * key_muls)
                             + inv * (tr + n_sp * (BARRETT_MULS
                                                   + SHOUP_MULS)))
        macs += B * C * d * d * N * (S + R) * (P + inv)
    return by, muls, macs


def random_words(q, shape, gen, lazy=False):
    """Uniform words below each channel's modulus q, or below 2q where the
    path feeds the kernel lazily reduced words (``lazy``); q: [C] on the
    device."""
    import torch

    r = torch.randint(0, 1 << 62, shape, generator=gen, device=q.device,
                      dtype=torch.int64)
    return r % (q[:, None] * (2 if lazy else 1))


def check_case(name, label, fn, twin, b, rows, src, replaces,
               library=None, yardsticks=None):
    """Hold fn() bit for bit against twin() (tensors or tuples of them),
    time both, and keep the first case of each kernel as its row. With
    ``yardsticks`` (a scratch beyond L2, the input x) also the cold-L2
    time and that of x.clone(). Returns the kernel's (median, min, max)
    ms."""
    import torch

    got, want = fn(), twin()
    got = torch.stack(got) if isinstance(got, tuple) else got
    want = torch.stack(want) if isinstance(want, tuple) else want
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"{name} [{label}]: kernel != twin "
                             f"(max |diff| {err})")
    ms, ms_lo, ms_hi = cuda_ms(fn, 100)
    plain_ms = cuda_ms(twin, 3, warmup=1)[0]
    library_ms = library() if library else None
    b_ms, b_by = b
    print(f"{name} [{label}]: bit-equal to twin; kernel {ms:.4f} ms "
          f"(median of 100; min {ms_lo:.4f}, max {ms_hi:.4f}), twin "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, share "
          f"{100 * b_ms / ms:.1f} %), library {library_ms} ms")
    if yardsticks:
        scratch, x = yardsticks
        cold = cold_ms(fn, 30, scratch)
        copy = cuda_ms(x.clone, 100)
        print(f"  {name} [{label}]: cold L2 {cold[0]:.4f} ms (min "
              f"{cold[1]:.4f}, max {cold[2]:.4f}); yardstick x.clone() of "
              f"its {8 * x.numel()} input bytes {copy[0]:.4f} ms (min "
              f"{copy[1]:.4f}, max {copy[2]:.4f}), not the library ms")
    if name not in rows:
        rows[name] = dict(name=name, route="cuda", source=src,
                          replaces=replaces, launches=0,
                          max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms)
    return ms, ms_lo, ms_hi


def counters():
    from liberate_tpu_torch.ntt import cuda_mxu, cuda_ntt

    return {**cuda_ntt.launches, **cuda_mxu.launches}


def reset_counters():
    from liberate_tpu_torch.ntt import cuda_mxu, cuda_ntt

    cuda_ntt.reset_launches()
    cuda_mxu.reset_launches()


def check_launches(label, path, own, rows):
    """The path's counts: every kernel of ``own`` launched, no other; a
    kernel's row takes its launches from the first path that launches
    it."""
    for k in own:
        if path[k] <= 0:
            raise AssertionError(f"{k} was not launched by the {label} path")
        if not rows[k]["launches"]:
            rows[k]["launches"] = path[k]
    for k, v in path.items():
        if k not in own and v != 0:
            raise AssertionError(f"the {label} path launched {k}")


def lead_in():
    """The first thing in a profiled window: a spin kernel of about 1 ms,
    then 30 ms on the host before the work is launched. Without the wait
    the profiler kept no kernel of a 0.2 ms window at gold (three calls of
    ``add``); the platinum launch splits lose about half their calls with
    it or without it."""
    import torch

    torch.cuda._sleep(SPIN_CYCLES)
    time.sleep(0.03)


def time_and_profile(label, op, fn, brief=False):
    """Times fn() (host clock, median of 7 after one warm-up, with the time
    Python's cyclic collector took in them) and profiles three calls
    (torch.profiler; single stream, so kernel times add up to the busy
    time; the host's self time by operator). ``brief``: one line, without
    the kernels' and the host's top lists. Returns the wall's median and
    the busy time, ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    fn()
    with GcClock() as clock:
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    wall_line = (f"median {statistics.median(times):.3f} ms over "
                 f"{len(times)} runs (min {min(times):.3f}, max "
                 f"{max(times):.3f})")
    if not brief:
        print(f"{label} {op}: {wall_line}; in them {clock}")

    reps = 3
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if not brief:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        lead_in()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    torch_ops = [e for e in kern if "at::native" in e.key
                 or e.key.startswith(("Memcpy", "Memset"))]
    ops_ms = sum(e.self_device_time_total for e in torch_ops) / 1e3 / reps
    n_ops = sum(e.count for e in torch_ops) // reps
    if brief:
        print(f"timing {label} {op}: wall {wall_line}; device busy "
              f"{busy:.3f} ms/{op}: PyTorch's kernels {ops_ms:.3f} ms in "
              f"{n_ops} launches, the port's {busy - ops_ms:.3f} ms "
              f"({sum(e.count for e in kern) // reps - n_ops} launches); "
              f"{clock}")
        return statistics.median(times), busy
    print(f"profile ({label}): {wall:.3f} ms/{op} wall with the profiler "
          f"on, device busy {busy:.3f} ms/{op} ({len(kern)} kernel names): "
          f"PyTorch's own kernels {ops_ms:.3f} ms/{op} in "
          f"{n_ops} launches, the port's "
          f"{busy - ops_ms:.3f} ms/{op}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / reps:.4f} ms/{op} "
              f"x{e.count // reps} {e.key[:100]}")
    # The host side: the self CPU time of PyTorch's operators and the CUDA
    # runtime calls (the rest of the wall is Python outside them).
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    in_ops = sum(e.self_cpu_time_total for e in host) / 1e3 / reps
    print(f"  host ({label}): {in_ops:.3f} ms/{op} self CPU time in "
          f"{sum(e.count for e in host) // reps} operator and runtime "
          f"calls, {wall - in_ops:.3f} ms/{op} of the wall outside them; "
          f"the most:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"    {e.self_cpu_time_total / 1e3 / reps:.4f} ms/{op} "
              f"x{e.count // reps} {e.key[:80]}")
    return statistics.median(times), busy


def launch_split(label, fn, roles, groups, reps=20):
    """Device ms per call of each launch role of fn(), whose launches come
    in ``groups`` runs of ``roles`` (one run per width group):
    torch.profiler's kernel events of one call in start order,
    averaged over ``reps`` calls, each profiled alone after one warm-up. A
    call whose events the profiler did not all keep is left out and
    counted, and another is profiled, up to 3 x ``reps`` calls; at least
    half of ``reps`` must be whole. Prints and returns {role: ms per
    call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls, tried = [], 0
    per = len(roles) * groups
    while tried < 3 * reps and sum(len(k) == per for k in calls) < reps:
        tried += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in()
            fn()
            torch.cuda.synchronize()
        calls.append(sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("mxu::" in e.name or "extend" in e.name)),
            key=lambda e: e.time_range.start))
    short = sorted(len(k) for k in calls if len(k) != per)
    calls = [k for k in calls if len(k) == per]
    kept = len(calls)
    if kept < reps // 2:
        raise AssertionError(f"{label}: the profiler kept all {per} kernel "
                             f"events of {kept} of {tried} calls (the "
                             f"others kept {short})")
    split = {r: 0.0 for r in roles}
    names = {r: set() for r in roles}
    for kern in calls:
        for i, e in enumerate(kern):
            r = roles[i % len(roles)]
            split[r] += e.time_range.elapsed_us() / 1e3
            names[r].add(e.name.replace("(anonymous namespace)::", "")
                         .split("(")[0][:60])
    split = {r: v / kept for r, v in split.items()}
    print(f"launch split ({label}, {per // len(roles)} width groups, "
          f"{kept} of {tried} calls whole, the others kept {short} events): "
          f"total {sum(split.values()):.4f} ms/call")
    for r in roles:
        print(f"  {r}: {split[r]:.4f} ms/call ({', '.join(sorted(names[r]))})")
    return split


def split_phase(eng_mxu, gen):
    """The per-launch split of #10 (extension, forward stage 1, forward
    stage 2 with the key sums, the two inverse stages) and #5 (stage 1,
    stage 2) at the level-1 shapes of kernel_phase (gold, platinum)."""
    import torch

    from liberate_tpu_torch.fhe.engine import _ksk_shoup
    from liberate_tpu_torch.ntt import cuda_mxu

    level = 1
    parts = eng_mxu.ntt.parts(level)
    P, N = len(parts), eng_mxu.ctx.N
    A = max(p.alpha for p in parts)
    mpack, mpack_sp = eng_mxu.pack(level, -1), eng_mxu.pack(level, -2)
    C = mpack.q.shape[0]
    pack0 = eng_mxu.pack(0, -2)
    k0 = random_words(pack0.q, (len(eng_mxu.ntt.parts(0)),
                                eng_mxu.ntt.total_channels, N), gen,
                      lazy=True)
    k1 = random_words(pack0.q, k0.shape, gen, lazy=True)
    ks = (_ksk_shoup(k0, pack0), _ksk_shoup(k1, pack0))
    st = torch.randint(0, 1 << 62, (P, A, N), generator=gen,
                       device=k0.device, dtype=torch.int64)
    terms, off0, _ = eng_mxu._mxu_switch_tables(level)
    x4 = random_words(mpack.q, (4, C, N), gen, lazy=True)
    return {
        "mxu_switch_inv": launch_split(
            f"#10 mxu_switch_inv, P={P} C_sp={mpack_sp.q.shape[0]} A={A}",
            lambda: cuda_mxu.dispatch_switch_inv(
                st, terms, off0, *ks, mpack_sp.mxu, level,
                parts[0].part_id),
            ["extension", "forward stage 1", "forward stage 2 + key sums",
             "inverse stage 1", "inverse stage 2"], len(mpack_sp.mxu)),
        "mxu_ntt_fwd": launch_split(
            f"#5 mxu_ntt_fwd, B=4 C={C} enter",
            lambda: cuda_mxu.dispatch(x4, mpack.mxu, enter=True),
            ["stage 1", "stage 2"], len(mpack.mxu))}


def geometry_check():
    """The stage kernel's geometry as compiled (ltt_mxu_geometry) against
    ntt/cuda_mxu.py's stage_geometry, for every digit count."""
    import ctypes

    from liberate_tpu_torch import _build
    from liberate_tpu_torch.ntt import cuda_mxu

    fn = _build.load("mxu_ntt").ltt_mxu_geometry
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for d in cuda_mxu.DIGITS:
        out = (ctypes.c_int * 12)()
        if fn(d, out) != 0:
            raise AssertionError(f"no stage kernel geometry at d={d}")
        g, gk = (cuda_mxu.stage_geometry(d, 256, 256, 256, 1, 1, ksum=k)
                 for k in (False, True))
        want = [g["tile_o"], g["ring"], g["smem"], gk["tile_o"], gk["ring"],
                gk["smem"], g["kz"], g["tile_j"], g["x_slots"], g["threads"],
                *g["regs"][1:]]
        if list(out) != want:
            raise AssertionError(f"stage geometry at d={d}: kernel "
                                 f"{list(out)}, stage_geometry {want}")
        print(f"  stage geometry d={d}: {out[7]} columns x {out[0]} rows "
              f"per block ({out[3]} for the key sums), ring of {out[1]} "
              f"({out[4]}) stages of {out[6]} table columns, {out[8]} X "
              f"tiles, {out[2]} ({out[5]}) bytes of shared memory, "
              f"{out[9]} threads, setmaxnreg {out[10]}/{out[11]}")


def bfly_geometry_check():
    """The butterfly transforms' launch as compiled (ltt_ntt_geometry)
    against ntt/cuda_ntt.py's bfly_geometry at every logN they take."""
    import ctypes

    from liberate_tpu_torch import _build
    from liberate_tpu_torch.ntt import cuda_ntt

    fn = _build.load("ntt").ltt_ntt_geometry
    fn.argtypes = cuda_ntt._ARGTYPES["ltt_ntt_geometry"]
    for logN in range(cuda_ntt.MIN_LOGN, cuda_ntt.MAX_LOGN + 1):
        out = (ctypes.c_int * 16)()
        if fn(logN, out) != 0:
            raise AssertionError(f"no butterfly geometry at logN {logN}")
        g = cuda_ntt.bfly_geometry(logN)
        want = [g["K"], g["threads"], g["smem"], len(g["cross"]),
                len(g["groups"]), g["teams"],
                *(v for grp in g["groups"] for v in grp)]
        if list(out)[:len(want)] != want:
            raise AssertionError(f"butterfly geometry at logN {logN}: "
                                 f"kernel {list(out)}, bfly_geometry {want}")
        print(f"  butterfly geometry logN {logN}: clusters of K={out[0]} "
              f"CTAs, {out[1]} threads, {out[2]} shared bytes per CTA, "
              f"{out[3]} cross-chunk stages, register passes (first stage, "
              f"stages) {g['groups']}, the passes after the first in "
              f"{out[5]} teams")


def mulacc_geometry_check():
    """The unsplit switch core's launch as compiled
    (ltt_ntt_mulacc_geometry) against ntt/cuda_ntt.py's mulacc_geometry at
    logN 8-15 and K = 1-8: the same ints where the model says the kernel
    takes the geometry, a refusal where it does not."""
    import ctypes

    from liberate_tpu_torch import _build
    from liberate_tpu_torch.ntt import cuda_ntt

    fn = _build.load("ntt_mulacc").ltt_ntt_mulacc_geometry
    fn.argtypes = cuda_ntt._ARGTYPES["ltt_ntt_mulacc_geometry"]
    for logN in range(cuda_ntt.MIN_LOGN, cuda_ntt.MULACC_MAX_LOGN + 1):
        for K in (1, 2, 4, 8):
            out = (ctypes.c_int * 16)()
            rc = fn(logN, K.bit_length() - 1, out)
            g = cuda_ntt.mulacc_geometry(logN, 1, 1, K, held=1)
            if g["takes"] != (rc == 0):
                raise AssertionError(f"mulacc geometry at logN {logN} K={K}: "
                                     f"kernel rc {rc}, model takes "
                                     f"{g['takes']}")
            want = [g["K"], g["threads"], g["smem"], len(g["cross"]),
                    len(g["groups"]), g["teams"],
                    *(v for grp in g["groups"] for v in grp)]
            if rc == 0 and list(out)[:len(want)] != want:
                raise AssertionError(f"mulacc geometry at logN {logN} K={K}: "
                                     f"kernel {list(out)}, model {want}")
        own = cuda_ntt.mulacc_geometry(logN, 1, 1)
        print(f"  unsplit switch core geometry logN {logN}: clusters of "
              f"K={own['K']} CTAs, {own['threads']} threads, {own['held']} "
              f"parts held, {own['smem']} shared bytes per CTA, "
              f"{own['per_sm']} CTAs an SM (every K the kernel takes agrees "
              f"with the model)")
    for label, logN, P, C in (("silver", 15, 9, 18), ("bronze", 14, 7, 8)):
        g = cuda_ntt.mulacc_geometry(logN, P, C)
        print(f"  unsplit switch core at {label} level 1 (P={P}, C_sp={C}): "
              f"K={g['K']}, G={g['G']} part groups {g['parts']}, "
              f"{g['held']} held, {g['ctas']} CTAs")


def transform_bound(x, logN, muls_extra):
    """The bound of one butterfly transform of x [B, C, N]: the words read
    and written once and the channel's twiddles and quotients once; N/2 *
    logN Shoup products per polynomial, plus ``muls_extra`` per word (the
    entry or exit multiply)."""
    B, cx, N = x.shape
    muls = B * cx * (N // 2) * logN + muls_extra * B * cx * N
    return bound(8 * (2 * x.numel() + 2 * cx * N), muls * SHOUP_MULS)


def prime_plans_phase(dev, gen, rows, scratch):
    """ntt_fwd and ntt_inv against their twins on plans of three 60-bit
    primes at logN 14 (K = 1) and 17 (K = 8), the multiply's batch
    shapes."""
    from liberate_tpu_torch.ntt import cuda_ntt

    for logN, preset in ((14, "bronze"), (17, "platinum")):
        t = time.perf_counter()
        plan = cuda_ntt.prime_plan(logN, 3, dev)
        C, N = 3, 1 << logN
        print(f"logN {logN} ({preset}) plan of 3 primes: "
              f"{time.perf_counter() - t:.2f} s")
        x4 = random_words(plan.q, (4, C, N), gen)
        x3 = random_words(plan.q, (3, C, N), gen, lazy=True)
        for name, fn, twin, x, kw in (
                ("ntt_fwd", cuda_ntt.ntt_fwd, cuda_ntt.ntt_fwd_plain, x4,
                 dict(pre_enter=True)),
                ("ntt_inv", cuda_ntt.ntt_inv, cuda_ntt.ntt_inv_plain, x3,
                 dict(post_exit=True, post_reduce=True))):
            check_case(name, f"logN {logN} B={x.shape[0]} C={C} "
                       f"{'enter' if name == 'ntt_fwd' else 'exit+reduce'}",
                       lambda: fn(x, plan, **kw), lambda: twin(x, plan, **kw),
                       transform_bound(x, logN, 1), rows,
                       "liberate_tpu_torch/csrc/ntt.cu",
                       "liberate_tpu/ntt/pallas_ntt.py:"
                       f"{534 if name == 'ntt_fwd' else 577}",
                       yardsticks=(scratch, x))


def int8_yardstick(eng_mxu, gen):
    """torch._int_mm of one gold (6, 6) channel's forward stage-1 product of
    #10 ([DA*O, DB*K] x [DB*K, P*J] int8 -> int32), times the switch's (6, 6)
    channel count: a yardstick of the int8 product alone. The port never
    calls it, and no PyTorch call computes the stage's function."""
    import torch

    level = 1
    P = len(eng_mxu.ntt.parts(level))
    g = next(g for g in eng_mxu.pack(level, -2).mxu if g.plan.dA == 6)
    plan, C = g.plan, g.hi - g.lo
    a = plan.m1[0]
    b = torch.randint(-128, 128, (plan.dB * plan.S, P * plan.R),
                      generator=gen, device=a.device, dtype=torch.int8)
    try:
        torch._int_mm(a, b)
    except RuntimeError:  # a cuBLASLt build that takes B column-major only
        b = b.t().contiguous().t()
    ms = cuda_ms(lambda: torch._int_mm(a, b), 100)[0]
    macs = a.shape[0] * a.shape[1] * b.shape[1]
    print(f"yardstick (not the kernel's library ms): torch._int_mm "
          f"{a.shape[0]} x {a.shape[1]} x {b.shape[1]} (one (6, 6) channel's "
          f"forward stage-1 product of #10) {ms:.4f} ms, "
          f"{2 * macs / ms / 1e9:.1f} TOP/s; x {C} channels = "
          f"{ms * C:.4f} ms")
    return ms * C


def messages(eng):
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [rng.uniform(-1, 1, eng.num_slots) + 1j * rng.uniform(
        -1, 1, eng.num_slots) for _ in range(2)]


def own_kernels(eng):
    """The kernels of the engine's multiply: its domain's transforms and
    the kernels of its switch route."""
    return list(dict.fromkeys(transforms(eng) + switch_kernels(eng)))


def drive_path(eng, label, rows, per_mult=None):
    """keygen -> 2 x encorypt -> mult -> decrode through the public API
    with the counters zeroed just before; checks the error, that mult
    launched every kernel of the engine's domain and switch route (exactly
    ``per_mult`` launches where given) and that the path launched no other.
    Times mult, profiles one and prints the path's peak device memory.
    Returns {"keys": (sk, pk, evk), "cts": (ct1, ct2), "out": the mult}."""
    import torch

    own = own_kernels(eng)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t = time.perf_counter()
    sk = eng.create_secret_key()
    pk = eng.create_public_key(sk)
    evk = eng.create_evk(sk)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t
    m1, m2 = messages(eng)
    ct1 = eng.encorypt(m1, pk)
    ct2 = eng.encorypt(m2, pk)
    before = counters()
    ctm = eng.mult(ct1, ct2, evk)
    torch.cuda.synchronize()
    during = {k: v - before[k] for k, v in counters().items()}
    dec = eng.decrode(ctm, sk)
    path = counters()
    err = abs(eng.absmax_error(dec, m1 * m2))
    print(f"{label} path: keys {t_keys:.2f} s, mult -> level {ctm.level}, "
          f"|err| {err:.3e}, launches {path}, in mult {during}")
    C = eng.ntt.num_channels(ctm.level, -1)
    for c in ctm.data:
        if tuple(c.shape) != (C, eng.ctx.N) or c.device.type != "cuda":
            raise AssertionError(f"mult output shape {tuple(c.shape)}")
    if not err < 1e-4:
        raise AssertionError(f"{label} mult error {err} >= 1e-4")
    for k in own:
        if during[k] <= 0:
            raise AssertionError(f"{k} was not launched by the {label} mult")
    if per_mult is not None and {k: during[k] for k in per_mult} != per_mult:
        raise AssertionError(f"the {label} mult launched {during}, not "
                             f"{per_mult}")
    check_launches(label, path, own, rows)
    time_and_profile(label, "mult", lambda: eng.mult(ct1, ct2, evk))
    print(f"{label} path: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB held by the engine before the path)")
    return {"keys": (sk, pk, evk), "cts": (ct1, ct2), "out": ctm}


def unsplit_equals_split(label, eng_unsplit, split):
    """The unsplit engine's mult (#4) of the split path's ciphertexts under
    its evk against the split path's mult (#1 then #3), word for word."""
    import torch

    ct1, ct2 = split["cts"]
    got = eng_unsplit.mult(ct1, ct2, split["keys"][2])
    same = all(torch.equal(a, b) for a, b in zip(got.data, split["out"].data))
    print(f"{label}: the unsplit mult of the split path's ciphertexts "
          f"{'equals' if same else 'DIFFERS from'} the split mult word for "
          f"word")
    if not same:
        raise AssertionError(f"{label}: unsplit and split mults differ")


class GcClock:
    """Python's cyclic collector while it is a gc callback: the
    collections it ran (full ones apart) and the seconds they took."""

    def __init__(self):
        self.runs = self.full = 0
        self.seconds = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.runs += 1
            self.full += info["generation"] == 2
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        import gc

        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self)

    def __str__(self):
        return (f"the cyclic collector ran {self.runs} times ({self.full} "
                f"full), {self.seconds * 1e3:.1f} ms in all")


def host_gap(label, runs):
    """Host-clock mult times of engines in turns (each run: (name, engine,
    drive_path's result)), 7 each, in the order given then reversed: a
    difference that follows the engine and not the moment of the call."""
    import torch

    times = {name: [] for name, _, _ in runs}
    with GcClock() as clock:
        for name, eng, run in runs + runs[::-1]:
            ct1, ct2 = run["cts"]
            eng.mult(ct1, ct2, run["keys"][2])
            for _ in range(7):
                torch.cuda.synchronize()
                t = time.perf_counter()
                eng.mult(ct1, ct2, run["keys"][2])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
    print(f"{label} in turns: " + "; ".join(
        f"{name} median {statistics.median(v):.3f} ms (min {min(v):.3f}, "
        f"max {max(v):.3f})" for name, v in times.items()) + f"; {clock}")


def standalone_switch_path(eng, keys, label, rows):
    """The key switch through its standalone entry points, with the
    counters zeroed just before: mult(relin=False) -> decrypt_triplet and
    relinearize, square, and switch_key under a key-switching key to a
    second secret key; each decoded with its key, error < 1e-4, and the
    relinearized triplet equal word for word to mult. Times switch_key."""
    import torch

    sk, pk, evk = keys
    m1, m2 = messages(eng)
    reset_counters()
    ct1 = eng.encorypt(m1, pk)
    ct2 = eng.encorypt(m2, pk)
    sk2 = eng.create_secret_key()
    ksk = eng.create_key_switching_key(sk, sk2)
    ctt = eng.mult(ct1, ct2, evk, relin=False)
    rel = eng.relinearize(ctt, evk)
    outs = {"decrypt_triplet": (ctt, sk, m1 * m2),
            "relinearize": (rel, sk, m1 * m2),
            "square": (eng.square(ct1, evk), sk, m1 * m1),
            "switch_key": (eng.switch_key(ct1, ksk), sk2, m1)}
    errs = {k: abs(eng.absmax_error(eng.decrode(ct, key), want))
            for k, (ct, key, want) in outs.items()}
    path = counters()
    print(f"{label} path: |err| {errs}, launches {path}")
    for k, e in errs.items():
        if not e < 1e-4:
            raise AssertionError(f"{label} {k} error {e} >= 1e-4")
    if not all(torch.equal(a, b) for a, b in
               zip(rel.data, eng.mult(ct1, ct2, evk).data)):
        raise AssertionError(f"{label}: relinearize(mult(relin=False)) "
                             f"differs from mult")
    check_launches(label, path, own_kernels(eng), rows)
    time_and_profile(label, "switch_key", lambda: eng.switch_key(ct1, ksk))


def switch_kernels(eng):
    """The kernels of one key switch on the engine's route: the tensor-core
    switch kernel of ``switch_route``, or the butterfly core of
    ``butterfly_switch_route`` with the inverse transform (and, but on the
    fused route, the forward transform of the parts)."""
    from liberate_tpu_torch.fhe.engine import butterfly_switch_route, \
        switch_route

    if eng.use_mxu_ntt:
        return [switch_route(eng.ctx.logN, eng.use_shoup_ksk)]
    return {"split": ["ntt_fwd", "ksk_mulacc", "ntt_inv"],
            "fused": ["ntt_mulacc", "ntt_inv"],
            "composed": ["ntt_fwd", "ntt_inv"]}[
        butterfly_switch_route(eng.ctx.logN, eng.use_split_switch)]


def transforms(eng):
    """The engine's domain's forward and inverse transform kernels."""
    return (["mxu_ntt_fwd", "mxu_ntt_inv"] if eng.use_mxu_ntt
            else ["ntt_fwd", "ntt_inv"])


def tensors(x):
    """The tensors of a DataStruct, tuple or list, nested or not."""
    if hasattr(x, "data") and not hasattr(x, "numel"):
        return tensors(x.data)
    if isinstance(x, (tuple, list)):
        return [t for d in x for t in tensors(d)]
    return [x]


def nbytes(x):
    return sum(t.numel() * t.element_size() for t in tensors(x))


def ops_phase(eng, label, run, rows, timed=False):
    """The single-party operations beside the multiply, on drive_path's
    keys and ciphertexts at level 1 (a: the mult's output, m1 m2; b: ct2
    levelled up, m2), each with the launch counters zeroed just before and
    read just after: the rotation (delta 1) and conjugation keys (the
    domain's transforms, no other kernel); add, sub, negate, mult by a
    float, an int and a message, add of a float and of a message (no
    kernel, but the message mult's transforms); rotate_single and
    conjugate (exactly the kernels of the engine's switch route). Each
    decoded error < 1e-4 against numpy. With ``timed`` the times of
    rotate_single, conjugate, add, mult_scalar and mc_mult, a line each.
    Prints the phase's peak device memory, the keys included. Returns the
    operand a, the keys and the outputs."""
    import numpy as np
    import torch

    sk, pk, evk = run["keys"]
    m1, m2 = messages(eng)
    a, ma = run["out"], m1 * m2
    b = eng.level_up(run["cts"][1], a.level)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t = time.perf_counter()
    rotk = eng.create_rotation_key(sk, 1)
    conjk = eng.create_conjugation_key(sk)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t
    check_launches(f"{label} rotation keys", counters(), transforms(eng),
                   rows)
    switch = switch_kernels(eng)
    ops = {
        "add": (lambda: eng.add(a, b), ma + m2, []),
        "sub": (lambda: eng.sub(a, b), ma - m2, []),
        "negate": (lambda: eng.negate(a), -ma, []),
        "mult_scalar": (lambda: eng.mult(a, 0.5), ma * 0.5, []),
        "mult_int_scalar": (lambda: eng.mult(a, 3), ma * 3, []),
        "mc_mult": (lambda: eng.mult(m2, a), ma * m2, transforms(eng)),
        "add_scalar": (lambda: eng.add(a, 0.5), ma + 0.5, []),
        "cm_add": (lambda: eng.add(a, m2), ma + m2, []),
        "rotate_single": (lambda: eng.rotate_single(a, rotk),
                          np.roll(ma, 1), switch),
        "conjugate": (lambda: eng.conjugate(a, conjk), np.conj(ma), switch),
    }
    outs, errs, launched = {}, {}, {}
    for name, (fn, want, own) in ops.items():
        reset_counters()
        outs[name] = fn()
        torch.cuda.synchronize()
        path = counters()
        check_launches(f"{label} {name}", path, own, rows)
        launched[name] = {k: v for k, v in path.items() if v}
        errs[name] = abs(eng.absmax_error(eng.decrode(outs[name], sk), want))
    print(f"{label} operations at level {a.level}: rotation and conjugation "
          f"keys {t_keys:.2f} s; |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; launches {launched}")
    for k, e in errs.items():
        if not e < 1e-4:
            raise AssertionError(f"{label} {k} error {e} >= 1e-4")
    if timed:
        for name in ("rotate_single", "conjugate", "add", "mult_scalar",
                     "mc_mult"):
            time_and_profile(label, name, ops[name][0], brief=True)
    stacked = nbytes(eng._ksk_stacked(rotk))
    print(f"{label} operations: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({held / 1e9:.2f} "
          f"GB held before the phase); one rotation key {nbytes(rotk) / 1e9:.3f} "
          f"GB, its switch stack {stacked / 1e9:.3f} GB")
    return dict(a=a, rotk=rotk, conjk=conjk, outs=outs)


def rotate_check(eng, label, ref, rows):
    """rotate_single on another route of the same domain (the unsplit
    butterfly switch, the Montgomery-form key) of ops_phase's operand and
    key, with the counters zeroed just before: exactly the route's switch
    kernels, and ops_phase's words."""
    import torch

    reset_counters()
    out = eng.rotate_single(ref["a"], ref["rotk"])
    torch.cuda.synchronize()
    path = counters()
    check_launches(f"{label} rotate_single", path, switch_kernels(eng), rows)
    same = all(torch.equal(x, y) for x, y in
               zip(out.data, ref["outs"]["rotate_single"].data))
    print(f"{label} rotate_single: launches "
          f"{ {k: v for k, v in path.items() if v} }, "
          f"{'equal to' if same else 'DIFFERS from'} the other route's words")
    if not same:
        raise AssertionError(f"{label}: rotate_single differs across routes")


def galois_phase(eng, label, run, rows):
    """The Galois key and the statistics at silver, with the counters
    zeroed just before: create_galois_key, rotate_galois by 3 and by
    num_slots - 1, sum, mean, cov, var, pow(5) and sqrt(e=0.3, alpha=0.2)
    on fresh real ciphertexts; decoded error < 1e-3 (sqrt < 0.05, as
    tests/test_engine_math.py), the engine's domain's transforms and
    switch kernels launched and no other. Times sum; prints the key's
    bytes, its switch stacks' and the phase's peak device memory."""
    import numpy as np
    import torch

    sk, pk, evk = run["keys"]
    n = eng.num_slots
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t = time.perf_counter()
    gk = eng.create_galois_key(sk)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t
    rng = np.random.default_rng(SEED + 1)
    x, y = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    z = rng.uniform(0.35, 0.95, n)
    cx, cy, cz = (eng.encorypt(v, pk) for v in (x, y, z))
    ct1, m1 = run["cts"][0], messages(eng)[0]
    cases = {
        "rotate_galois 3": (lambda: eng.rotate_galois(ct1, gk, 3),
                            np.roll(m1, 3), 1e-3),
        f"rotate_galois {n - 1}": (lambda: eng.rotate_galois(ct1, gk, n - 1),
                                   np.roll(m1, n - 1), 1e-3),
        "sum": (lambda: eng.sum(cx, gk), np.full(n, x.sum()), 1e-3),
        "mean": (lambda: eng.mean(cx, gk), np.full(n, x.mean()), 1e-3),
        "cov": (lambda: eng.cov(cx, cy, evk, gk),
                (x - x.mean()) * (y - y.mean()) / (n - 1), 1e-3),
        "var": (lambda: eng.var(cx, evk, gk),
                np.full(n, ((x - x.mean()) ** 2).mean()), 1e-3),
        "pow 5": (lambda: eng.pow(cx, 5, evk), x ** 5, 1e-3),
        "sqrt": (lambda: eng.sqrt(cz, evk, e=0.3, alpha=0.2), np.sqrt(z),
                 0.05),
    }
    outs = {k: fn() for k, (fn, _, _) in cases.items()}
    torch.cuda.synchronize()
    path = counters()
    errs = {k: abs(eng.absmax_error(
        eng.decrode(outs[k], sk, is_real=not k.startswith("rotate")), want))
        for k, (_, want, _) in cases.items()}
    print(f"{label} Galois phase: {len(gk.data)} rotation keys "
          f"{t_keys:.2f} s; |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; launches {path}")
    for k, (_, _, tol) in cases.items():
        if not errs[k] < tol:
            raise AssertionError(f"{label} {k} error {errs[k]} >= {tol}")
    check_launches(f"{label} Galois", path, own_kernels(eng), rows)
    time_and_profile(label, "sum", cases["sum"][0], brief=True)
    stacked = sum(nbytes(eng._ksk_stacked_cache[k]) for k in gk.data
                  if k in eng._ksk_stacked_cache)
    print(f"{label} Galois phase: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB held before the phase); the Galois key "
          f"{nbytes(gk) / 1e9:.3f} GB, its switch stacks "
          f"{stacked / 1e9:.3f} GB")
    for k in gk.data:
        eng._ksk_stacked_cache.pop(k, None)


def small_ops(e, sk, pk, evk, ct):
    """Every operation of the slice at logN 8 on the path's keys and
    ciphertext: {name: the words of its result}."""
    import numpy as np

    from liberate_tpu_torch.ntt import ops

    n = e.num_slots
    m = np.arange(n)[::-1] / n
    x = 0.35 + 0.6 * np.arange(n) / n
    rotk = e.create_rotation_key(sk, 1)
    conjk = e.create_conjugation_key(sk)
    gk = e.create_galois_key(sk)
    ksk = e.create_key_switching_key(sk, e.create_secret_key())
    ct2, cx = e.encorypt(m, pk), e.encorypt(x, pk)
    pack = e.pack(0, -1)
    ct_ntt = ct._replace(data=tuple(ops.enter_ntt(d, pack) for d in ct.data),
                         ntt_state=True, montgomery_state=True)
    ctt = e.mult(ct, ct2, evk, relin=False)
    outs = {
        "rotation key": rotk, "conjugation key": conjk, "Galois key": gk,
        "add": e.add(ct, ct2), "sub": e.sub(ct, ct2), "negate": e.negate(ct),
        "add triplets": e.add(ctt, ctt), "mult float": e.mult(ct, 0.5),
        "mult int": e.mult(ct, 3), "mult message": e.mult(m, ct),
        "add float": e.add(ct, 0.5), "add message": e.add(ct, m),
        "sub message": e.sub(m, ct), "sub from float": e.sub(0.5, ct),
        "switch_key of an NTT-state ciphertext": e.switch_key(ct_ntt, ksk),
        "rotate_single": e.rotate_single(ct, rotk),
        "conjugate": e.conjugate(ct, conjk),
        "rotate_galois": e.rotate_galois(ct, gk, 3), "sum": e.sum(ct, gk),
        "mean": e.mean(ct, gk), "cov": e.cov(ct, ct2, evk, gk),
        "var": e.var(ct, evk, gk), "pow": e.pow(ct, 5, evk),
        "sqrt": e.sqrt(cx, evk, e=0.3, alpha=0.2),
        "mult_batched": e.mult_batched([ct, ct2], [cx, ct], evk),
    }
    sks = [sk, e.create_secret_key()]
    cpk, cevk, crotk = _collective_keys(e, sks)
    gcrs = e.generate_galois_crs(gk)
    cgk = e.multiparty_generate_galois_key(
        [gk, e.multiparty_create_galois_key(sks[1], gcrs)])
    ctc = e.encorypt(m, cpk)
    outs.update({
        "collective public key": cpk, "collective evk": cevk,
        "collective rotation key": crotk, "collective Galois key": cgk,
        "decrypt head": e.multiparty_decrypt_head(ctc, sks[0]),
        "decrypt partial": e.multiparty_decrypt_partial(ctc, sks[1]),
        "mult under the collective evk": e.mult(ctc, ctc, cevk),
        "rotate_galois under the collective Galois key": e.rotate_galois(
            ctc, cgk, 3)})
    return {k: [t.to("cpu") for t in tensors(v)] for k, v in outs.items()}


def ops_kernel_phase(preset, eng, eng_mxu, gen, rows, scratch):
    """The kernel shapes and modes the operations beside the multiply add
    at the preset, against their twins: the rotation key's transforms of
    the level-0 secret key (B=1 over the ordinary channels; the inverse
    without the Montgomery exit or the reduce, the forward without the
    entry), mc_mult's B=1 transforms at level 1 (the forward with the
    entry, the inverse with the exit and the reduce) and the threshold
    decryption's B=1 inverse at level 1 (the exit without the reduce), in
    both domains."""
    from liberate_tpu_torch.ntt import cuda_mxu, cuda_ntt

    N, logN = eng.ctx.N, eng.ctx.logN
    p0, p1 = eng.pack(0, -1), eng.pack(1, -1)
    C0, C1 = p0.q.shape[0], p1.q.shape[0]
    x0 = random_words(p0.q, (1, C0, N), gen, lazy=True)
    x1 = random_words(p1.q, (1, C1, N), gen, lazy=True)
    key = "rotation key"
    for name, label, x, plan, kw in (
            ("ntt_inv", f"B=1 C={C0} no exit, no reduce ({key})", x0,
             p0.plan, {}),
            ("ntt_fwd", f"B=1 C={C0} no enter ({key})", x0, p0.plan, {}),
            ("ntt_fwd", f"B=1 C={C1} enter (mc_mult)", x1, p1.plan,
             dict(pre_enter=True)),
            ("ntt_inv", f"B=1 C={C1} exit+reduce (mc_mult)", x1, p1.plan,
             dict(post_exit=True, post_reduce=True)),
            ("ntt_inv", f"B=1 C={C1} exit, no reduce (decrypt head and "
             f"partial)", x1, p1.plan, dict(post_exit=True))):
        fwd = name == "ntt_fwd"
        fn = cuda_ntt.ntt_fwd if fwd else cuda_ntt.ntt_inv
        twin = cuda_ntt.ntt_fwd_plain if fwd else cuda_ntt.ntt_inv_plain
        check_case(name, f"{preset} {label}",
                   lambda fn=fn, x=x, plan=plan, kw=kw: fn(x, plan, **kw),
                   lambda twin=twin, x=x, plan=plan, kw=kw: twin(x, plan,
                                                                 **kw),
                   transform_bound(x, logN, int(not fwd
                                                or "pre_enter" in kw)),
                   rows, "liberate_tpu_torch/csrc/ntt.cu",
                   f"liberate_tpu/ntt/pallas_ntt.py:{534 if fwd else 577}",
                   yardsticks=(scratch, x))
    m0, m1 = eng_mxu.pack(0, -1), eng_mxu.pack(1, -1)
    S, R = m0.mxu[0].plan.S, m0.mxu[0].plan.R
    y0 = random_words(m0.q, (1, C0, N), gen, lazy=True)
    y1 = random_words(m1.q, (1, C1, N), gen, lazy=True)
    for name, label, y, groups, kw in (
            ("mxu_ntt_inv", f"B=1 C={C0} no exit, no reduce ({key})", y0,
             m0.mxu, dict(inverse=True)),
            ("mxu_ntt_fwd", f"B=1 C={C0} no enter ({key})", y0, m0.mxu, {}),
            ("mxu_ntt_fwd", f"B=1 C={C1} enter (mc_mult)", y1, m1.mxu,
             dict(enter=True)),
            ("mxu_ntt_inv", f"B=1 C={C1} exitx+reduce (mc_mult)", y1,
             m1.mxu, dict(inverse=True, exitx=True, post_reduce=True)),
            ("mxu_ntt_inv", f"B=1 C={C1} exitx, no reduce (decrypt head and "
             f"partial)", y1, m1.mxu, dict(inverse=True, exitx=True))):
        check_case(name, f"{preset} {label}, {len(groups)} groups",
                   lambda y=y, g=groups, kw=kw: cuda_mxu.dispatch(y, g,
                                                                  **kw),
                   lambda y=y, g=groups, kw=kw: cuda_mxu.dispatch(
                       y, g, plain=True, **kw),
                   bound(*mxu_ntt_work(groups, 1, S, R)), rows,
                   "liberate_tpu_torch/csrc/mxu_ntt.cu",
                   "liberate_tpu/ntt/mxu_pallas.py:"
                   f"{163 if 'inverse' in kw else 143}")


def segment_phase(preset, eng_mxu, gen, rows, cases, bcts=()):
    """The switch kernels' ct-batched part segments at the level-1 shapes:
    for each (kernel, B) of ``cases`` B segments of the level's P parts
    under one random key, bit for bit against the twin and timed (median,
    min and max of 100) beside the bound of the B switches and beside B
    single-ciphertext calls on the same words (each segment's words also
    equal to its single call's). ``bcts``: the batched mult's transform
    shapes at those batch sizes, #5 at B=4 Bct with the entry and #6 at
    B=3 Bct with the exit and the reduce. Returns {label: (ms, B single
    calls ms, bound ms)}."""
    import torch

    from liberate_tpu_torch.fhe.engine import _ksk_shoup
    from liberate_tpu_torch.ntt import cuda_mxu

    level = 1
    parts = eng_mxu.ntt.parts(level)
    P, N = len(parts), eng_mxu.ctx.N
    A = max(p.alpha for p in parts)
    mpack, mpack_sp = eng_mxu.pack(level, -1), eng_mxu.pack(level, -2)
    C, C_sp = mpack.q.shape[0], mpack_sp.q.shape[0]
    S, R = mpack.mxu[0].plan.S, mpack.mxu[0].plan.R
    pack0 = eng_mxu.pack(0, -2)
    k0 = random_words(pack0.q, (len(eng_mxu.ntt.parts(0)),
                                eng_mxu.ntt.total_channels, N), gen,
                      lazy=True)
    k1 = random_words(pack0.q, k0.shape, gen, lazy=True)
    shoup = (_ksk_shoup(k0, pack0), _ksk_shoup(k1, pack0))
    keys = {"mxu_switch": shoup, "mxu_switch_inv": shoup,
            "mxu_switch_inv_mont": (k0, k1)}
    terms, off0, piw = eng_mxu._mxu_switch_tables(level)
    part_off, n_sp = parts[0].part_id, eng_mxu.num_special
    lines = {"mxu_switch": 815, "mxu_switch_inv": 777,
             "mxu_switch_inv_mont": 588}
    out = {}
    for name, B in cases:
        st = torch.randint(0, 1 << 62, (B * P, A, N), generator=gen,
                           device=k0.device, dtype=torch.int64)
        ks = keys[name]

        def run(x, seg, plain=False, name=name, ks=ks):
            if name == "mxu_switch":
                return cuda_mxu.dispatch_switch(
                    x, terms, off0, piw, *ks, mpack_sp.mxu, level, part_off,
                    n_sp, plain=plain, parts=seg)
            return cuda_mxu.dispatch_switch_inv(
                x, terms, off0, *ks, mpack_sp.mxu, level, part_off,
                plain=plain, parts=seg)

        def singles(st=st, run=run, B=B):
            return [run(st[b * P:(b + 1) * P], None) for b in range(B)]

        label = (f"{preset} B={B} segments of P={P} C_sp={C_sp} A={A}"
                 f"{f' n_sp={n_sp}' if name == 'mxu_switch' else ''}")
        b = bound(*mxu_switch_work(
            mpack_sp.mxu, P, A, n_sp if name == "mxu_switch" else 0, S, R,
            mont=name == "mxu_switch_inv_mont", B=B))
        ms = check_case(name, label, lambda run=run, st=st: run(st, P),
                        lambda run=run, st=st: run(st, P, plain=True), b,
                        rows, "liberate_tpu_torch/csrc/mxu_switch.cu",
                        f"liberate_tpu/ntt/mxu_pallas.py:{lines[name]}")
        got = run(st, P)
        if not all(torch.equal(got[:, i], one)
                   for i, one in enumerate(singles())):
            raise AssertionError(f"{name} [{label}]: a segment differs from "
                                 f"its single-ciphertext switch")
        one = cuda_ms(singles, 100)
        print(f"  {name} [{label}]: batched {ms[0]:.4f} ms (min {ms[1]:.4f},"
              f" max {ms[2]:.4f}) against {B} single-ciphertext calls on the"
              f" same words {one[0]:.4f} ms (min {one[1]:.4f}, max "
              f"{one[2]:.4f}): {ms[0] / B:.4f} against {one[0] / B:.4f} ms a"
              f" ciphertext, bound {b[0] / B:.4f} ms a ciphertext; each "
              f"segment equal to its single call")
        out[f"{name} {label}"] = (ms[0], one[0], b[0])
    for bct in bcts:
        x4 = random_words(mpack.q, (4 * bct, C, N), gen, lazy=True)
        x3 = random_words(mpack.q, (3 * bct, C, N), gen, lazy=True)
        for name, x, kw, line in (
                ("mxu_ntt_fwd", x4, dict(enter=True), 143),
                ("mxu_ntt_inv", x3, dict(inverse=True, exitx=True,
                                         post_reduce=True), 163)):
            mode = "enter" if name == "mxu_ntt_fwd" else "exitx+reduce"
            check_case(name, f"{preset} B={x.shape[0]} C={C} {mode} "
                       f"(batched mult, Bct={bct}), {len(mpack.mxu)} groups",
                       lambda x=x, kw=kw: cuda_mxu.dispatch(x, mpack.mxu,
                                                            **kw),
                       lambda x=x, kw=kw: cuda_mxu.dispatch(
                           x, mpack.mxu, plain=True, **kw),
                       bound(*mxu_ntt_work(mpack.mxu, x.shape[0], S, R)),
                       rows, "liberate_tpu_torch/csrc/mxu_ntt.cu",
                       f"liberate_tpu/ntt/mxu_pallas.py:{line}")
    return out


def batched_phase(eng, label, run, rows, bcts, timed=()):
    """mult_batched of Bct pairs of fresh level-0 ciphertexts under the
    path's evk, each with the launch counters zeroed just before: the words
    of per-pair mult, decoded error < 1e-4, every kernel of the engine's
    multiply launched and no other, in the tensor-core domain one switch
    dispatch a batch (as many switch launches as one mult: one a width
    group), in the butterfly domain the loop's (Bct mults' launches). For
    the Bct in ``timed`` the batch's wall (median of 7) and busy time, per
    batch and per mult; each Bct's peak device memory."""
    import numpy as np
    import torch

    sk, pk, evk = run["keys"]
    n, bmax = eng.num_slots, max(bcts)
    rng = np.random.default_rng(SEED + 2)
    ms = [rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
          for _ in range(2 * bmax)]
    cts = [eng.encorypt(m, pk) for m in ms]
    switch = switch_kernels(eng)
    reset_counters()
    eng.mult(cts[0], cts[bmax], evk)
    torch.cuda.synchronize()
    one = counters()
    for bct in bcts:
        a, b = cts[:bct], cts[bmax:bmax + bct]
        want = [eng.mult(x, y, evk) for x, y in zip(a, b)]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        outs = eng.mult_batched(a, b, evk)
        torch.cuda.synchronize()
        path = counters()
        peak = torch.cuda.max_memory_allocated()
        same = all(torch.equal(x, y) for o, w in zip(outs, want)
                   for x, y in zip(o.data, w.data))
        err = max(abs(eng.absmax_error(eng.decrode(o, sk), x * y))
                  for o, x, y in zip(outs, ms[:bct], ms[bmax:bmax + bct]))
        per = {k: (one[k] if eng.use_mxu_ntt else bct * one[k])
               for k in switch}
        print(f"{label} mult_batched Bct={bct}: "
              f"{'equal to' if same else 'DIFFERS from'} per-pair mult word "
              f"for word, |err| {err:.3e}, launches "
              f"{ {k: v for k, v in path.items() if v} }, peak device memory "
              f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held before)")
        if not same:
            raise AssertionError(f"{label} Bct={bct}: mult_batched differs "
                                 f"from per-pair mult")
        if not err < 1e-4:
            raise AssertionError(f"{label} Bct={bct}: error {err} >= 1e-4")
        check_launches(f"{label} mult_batched", path, own_kernels(eng), rows)
        if {k: path[k] for k in switch} != per:
            raise AssertionError(f"{label} Bct={bct}: switch launches "
                                 f"{ {k: path[k] for k in switch} }, not "
                                 f"{per}")
        if bct in timed:
            wall, busy = time_and_profile(
                f"{label} Bct={bct}", "batch",
                lambda a=a, b=b: eng.mult_batched(a, b, evk), brief=True)
            print(f"  {label} mult_batched Bct={bct}: {wall / bct:.3f} ms "
                  f"wall and {busy / bct:.3f} ms busy a mult")
        del outs, want


def _collective_keys(e, sks):
    """The parties' collective public key, evk and rotation key (delta 1),
    each over one common CRS."""
    pk0 = e.multiparty_create_public_key(sks[0])
    crs = e.multiparty_public_crs(pk0)
    cpk = e.multiparty_create_collective_public_key(
        [pk0] + [e.multiparty_create_public_key(s, a=crs) for s in sks[1:]])
    shares = [e.create_key_switching_key(sks[0], sks[0])]
    crs = e.generate_rotation_crs(shares[0])
    shares += [e.multiparty_create_key_switching_key(s, s, a=crs)
               for s in sks[1:]]
    summed = e.multiparty_sum_evk_share(shares)
    cevk = e.multiparty_sum_evk_share_mult(
        [e.multiparty_mult_evk_share_sum(summed, s) for s in sks])
    rotk0 = e.multiparty_create_rotation_key(sks[0], 1)
    crs = e.generate_rotation_crs(rotk0)
    crotk = e.multiparty_generate_rotation_key(
        [rotk0] + [e.multiparty_create_rotation_key(s, 1, a=crs)
                   for s in sks[1:]])
    return cpk, cevk, crotk


def _threshold_decrypt(e, ct, sks):
    pcts = [e.multiparty_decrypt_head(ct, sks[0])]
    pcts += [e.multiparty_decrypt_partial(ct, s) for s in sks[1:]]
    return e.multiparty_decrypt_fusion(pcts, level=ct.level)


def multiparty_phase(eng, label, rows, parties=3):
    """Threshold FHE with the launch counters zeroed just before: the
    parties' secret keys, the collective public key, evk and rotation key,
    a ciphertext under the collective key, mult under the collective evk,
    rotate_single under the collective rotation key, the threshold
    decryption of both; each step timed once (host clock, synchronised);
    decoded errors < 1e-4; the engine's transforms and switch kernels
    launched and no other. Prints the phase's peak device memory."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return res

    sks = step("secret keys", lambda: [eng.create_secret_key()
                                       for _ in range(parties)])
    cpk, cevk, crotk = step("collective pk, evk and rotation key",
                            lambda: _collective_keys(eng, sks))
    m = np.random.default_rng(SEED + 3).uniform(-1, 1, eng.num_slots)
    ct = step("encorypt", lambda: eng.encorypt(m, cpk))
    ctm = step("mult", lambda: eng.mult(ct, ct, cevk))
    rot = step("rotate_single", lambda: eng.rotate_single(ctm, crotk))
    dec_m = step("threshold decrypt", lambda: _threshold_decrypt(eng, ctm,
                                                                 sks))
    dec_r = _threshold_decrypt(eng, rot, sks)
    path = counters()
    errs = {"mult": abs(eng.absmax_error(dec_m[:eng.num_slots], m * m)),
            "rotate_single": abs(eng.absmax_error(dec_r[:eng.num_slots],
                                                  np.roll(m * m, 1)))}
    print(f"{label} multiparty ({parties} parties): |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; once each: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                        for k, v in times.items())
          + f"; launches { {k: v for k, v in path.items() if v} }; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({held / 1e9:.2f} GB held before)")
    for k, e in errs.items():
        if not e < 1e-4:
            raise AssertionError(f"{label} multiparty {k} error {e} >= 1e-4")
    check_launches(f"{label} multiparty", path, own_kernels(eng), rows)


def _barrier(mesh, axis):
    """Every rank of the axis has reached this point (and its queued
    work has run: the gloo sum stages its tensor through the host)."""
    import torch

    from liberate_tpu_torch.parallel import comm

    comm.all_sum(torch.zeros(1, dtype=torch.int64, device=mesh.device),
                 mesh, axis)


def coef_shard_phase(eng, gen, rows, shards=(4, 8)):
    """The coefficient-sharded transforms at gold, S ranks as threads on
    cuda:0: the level-0 with-special channels of a [P, C, N] part stack
    through ``ntt_coef_sharded(pre_enter=True)`` and
    ``intt_coef_sharded(post_exit=True, post_reduce=True)``, bit-equal to
    the single-device #1 and #2 on the same words, with the counters
    zeroed just before: S launches of the local #1 and of #2 in its
    no-normalise mode, no other kernel. Each local kernel held against its
    twin at the local shape (logL 14 at S = 4, 13 at S = 8), timed beside
    its bound; the whole sharded pair's wall (median of 5, rank 0's clock
    between barriers) beside the single-device pair's. One card: a
    functional check, the exchanges go through host buffers."""
    import statistics

    import torch

    from liberate_tpu_torch.ntt import cuda_ntt, ops
    from liberate_tpu_torch.parallel import make_mesh, run_ranks
    from liberate_tpu_torch.parallel.coef_shard import (
        intt_coef_sharded, make_coef_plan, ntt_coef_sharded)

    pack = eng.pack(0, -2)
    P, C, N = len(eng.ntt.parts(0)), pack.q.shape[0], eng.ctx.N
    x = random_words(pack.q, (P, C, N), gen)
    f_ref = ops.enter_ntt(x, pack)
    i_ref = ops.intt_exit_reduce(f_ref, pack)
    single = cuda_ms(lambda: ops.intt_exit_reduce(ops.enter_ntt(x, pack),
                                                  pack), 20)
    for S in shards:
        L = N // S

        def body():
            plan = make_coef_plan(eng.ntt, make_mesh(S, axis_name="coef"))
            mesh, i = plan.mesh, plan.index
            xs = x[..., i * L:(i + 1) * L].contiguous()
            torch.cuda.synchronize()
            _barrier(mesh, "coef")
            if i == 0:
                reset_counters()
            _barrier(mesh, "coef")
            f = ntt_coef_sharded(xs, plan, pre_enter=True)
            back = intt_coef_sharded(f_ref[..., i * L:(i + 1) * L]
                                     .contiguous(), plan, post_exit=True,
                                     post_reduce=True)
            torch.cuda.synchronize()
            _barrier(mesh, "coef")
            path = counters()
            walls = []
            for _ in range(6):
                _barrier(mesh, "coef")
                t = time.perf_counter()
                intt_coef_sharded(ntt_coef_sharded(xs, plan, pre_enter=True),
                                  plan, post_exit=True, post_reduce=True)
                torch.cuda.synchronize()
                _barrier(mesh, "coef")
                walls.append((time.perf_counter() - t) * 1e3)
            return plan.local, xs, f, back, path, walls[1:]

        out = run_ranks(S, body, device="cuda:0")
        f = torch.cat([o[2] for o in out], dim=-1)
        back = torch.cat([o[3] for o in out], dim=-1)
        path, walls = out[0][4], out[0][5]
        same = torch.equal(f, f_ref) and torch.equal(back, i_ref)
        print(f"gold coef-sharded S={S} ([P={P}, C={C}, L={L}] a rank): "
              f"forward with the entry and "
              f"inverse with the exit and reduce "
              f"{'bit-equal to' if same else 'DIFFER from'} the "
              f"single-device #1 and #2; launches "
              f"{ {k: v for k, v in path.items() if v} }; wall of the pair "
              f"{statistics.median(walls):.3f} ms (median of 5, min "
              f"{min(walls):.3f}, max {max(walls):.3f}; exchanges through "
              f"host buffers) against {single[0]:.3f} ms single-device "
              f"(CUDA events, median of 20)")
        if not same:
            raise AssertionError(f"gold coef-sharded S={S}: words differ "
                                 f"from the single-device transforms")
        want = dict.fromkeys(path, 0)
        want.update(ntt_fwd=S, ntt_inv_no_norm=S)
        if path != want:
            raise AssertionError(f"gold coef-sharded S={S}: launches {path}, "
                                 f"not {want}")
        local, xs = out[1][0], out[1][1]
        fs = out[1][2]
        logL = local.logN
        for name, fn, twin, b, line in (
                ("ntt_fwd_coef_shard",
                 lambda: cuda_ntt.ntt_fwd(xs, local),
                 lambda: cuda_ntt.ntt_fwd_plain(xs, local),
                 transform_bound(xs, logL, 0), 534),
                ("ntt_inv_no_norm",
                 lambda: cuda_ntt.ntt_inv(fs, local, no_norm=True),
                 lambda: cuda_ntt.ntt_inv_plain(fs, local, no_norm=True),
                 transform_bound(fs, logL, 0), 1112)):
            check_case(name, f"gold coef shard S={S} B={P} C={C} logL={logL}",
                       fn, twin, b, rows, "liberate_tpu_torch/csrc/ntt.cu",
                       f"liberate_tpu/ntt/pallas_ntt.py:{line}")
        for name, k in (("ntt_fwd_coef_shard", "ntt_fwd"),
                        ("ntt_inv_no_norm", "ntt_inv_no_norm")):
            if not rows[name]["launches"]:
                rows[name]["launches"] = path[k]
        del out, f, back

    # On the card a shard shorter than the kernels' range (logN 8-17) is
    # refused when the plan is made: there is no plain fallback.
    from liberate_tpu_torch.fhe.context.ckks_context import CkksContext
    from liberate_tpu_torch.ntt.ntt_context import NttContext

    small = NttContext(CkksContext(logN=8, scale_bits=30, num_scales=3,
                                   num_special_primes=2, is_secured=False),
                       "cuda:0")

    def refused():
        try:
            make_coef_plan(small, make_mesh(2, axis_name="coef"))
        except ValueError:
            return True
        return False

    if not all(run_ranks(2, refused, device="cuda:0")):
        raise AssertionError("a coef plan of 2^7-word shards on the card was "
                             "not refused")
    print("coef-sharded plan of 2^7-word shards (logN 8, S=2) on the card: "
          "refused, as the kernels take logL 8-17")


def _words_equal(e, a, b):
    """'raw' where two DataStructs (a tree) hold the same words, 'mod q'
    where only their residues agree, else ''."""
    import torch

    from liberate_tpu_torch import DataStruct

    raw = True
    for x, y in zip(a.data, b.data):
        if isinstance(x, DataStruct):
            r = _words_equal(e, x, y)
            if not r:
                return ""
            raw = raw and r == "raw"
            continue
        if torch.equal(x, y):
            continue
        raw = False
        q = e.pack(a.level, -2 if a.include_special else -1).q[:, None]
        if x.shape != y.shape or not torch.equal(x % q, y % q):
            return ""
    return "raw" if raw else "mod q"


def _sharded_flow(e, ms, batched=False):
    """The sharded engine's path: keygen (a rotation key too), two
    encryptions, mult, level_up, rotate_single, with ``batched``
    mult_batched of four pairs, three parties' collective public key and
    encryption under it. Returns the keys and ciphertexts and the threshold
    decryption."""
    sk = e.create_secret_key()
    pk = e.create_public_key(sk)
    evk = e.create_evk(sk)
    rotk = e.create_rotation_key(sk, 1)
    ct1, ct2 = e.encorypt(ms[0], pk), e.encorypt(ms[1], pk)
    out = e.mult(ct1, ct2, evk)
    sks = [sk, e.create_secret_key(), e.create_secret_key()]
    pk0 = e.multiparty_create_public_key(sks[0])
    crs = e.multiparty_public_crs(pk0)
    cpk = e.multiparty_create_collective_public_key(
        [pk0] + [e.multiparty_create_public_key(s, a=crs) for s in sks[1:]])
    ctc = e.encorypt(ms[0], cpk)
    words = dict(sk=sk, pk=pk, evk=evk, rotk=rotk, ct1=ct1, ct2=ct2, out=out,
                 level_up=e.level_up(ct1, 2),
                 rotate_single=e.rotate_single(ct1, rotk), cpk=cpk,
                 ct_collective=ctc)
    if batched:
        for i, c in enumerate(e.mult_batched([ct1, ct2, ct1, ct2],
                                             [ct2, ct1, ct1, ct2], evk)):
            words[f"batched{i}"] = c
    return words, _threshold_decrypt(e, ctc, sks)


def _mesh_barrier(mesh):
    """Every rank of the mesh has reached this point: a barrier along each
    of its axes in turn."""
    for axis in mesh.axis_names:
        if mesh.axis_size(axis) > 1:
            _barrier(mesh, axis)


def _flat_rank(mesh):
    r = 0
    for axis in mesh.axis_names:
        r = r * mesh.axis_size(axis) + mesh.axis_index(axis)
    return r


def _run_mesh(ranks, body):
    """run_ranks(ranks, lambda: body(window)) on cuda:0, with
    torch.profiler over one window: every rank calls window(mesh, fn) once,
    which runs fn three times between barriers. The profiler starts and
    stops in this thread (kineto refuses a profiler made in another): rank
    0 hands it the window. Returns the ranks' results and the window's
    device busy ms, copy ms (to and from host buffers) and launches, each
    per call of fn (None where the window never opened)."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from liberate_tpu_torch.parallel import run_ranks

    events = [threading.Event() for _ in range(3)]   # ready, go, done

    def window(mesh, fn):
        r = _flat_rank(mesh)
        _mesh_barrier(mesh)
        if r == 0:
            events[0].set()
            events[1].wait()
        _mesh_barrier(mesh)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        _mesh_barrier(mesh)
        if r == 0:
            events[2].set()

    out = []

    def run():
        try:
            out.extend(run_ranks(ranks, lambda: body(window),
                                 device="cuda:0"))
        except BaseException as e:      # noqa: BLE001 - raised below
            out.append(e)

    ranks_run = threading.Thread(target=run)
    ranks_run.start()
    while not events[0].wait(1) and ranks_run.is_alive():
        pass
    busy = copies = launched = None
    if events[0].is_set():
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                events[1].set()
                while not events[2].wait(1) and ranks_run.is_alive():
                    pass
        except BaseException:
            events[1].set()     # the ranks go on if the profiler failed
            ranks_run.join()
            raise
        kern = [k for k in prof.key_averages()
                if k.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(k.self_device_time_total for k in kern) / 1e3 / 3
        copies = sum(k.self_device_time_total for k in kern
                     if k.key.startswith("Memcpy")) / 1e3 / 3
        launched = sum(k.count for k in kern) // 3
    ranks_run.join()
    if len(out) != ranks:
        raise out[0]
    return out, busy, copies, launched


def _mesh_mult(e, a, b, evk):
    """On every rank of e's mesh: the launches of one e.mult(a, b, evk)
    with the counters zeroed just before (read once every rank has
    finished), and the walls of five more (ms, rank's clock between
    barriers, after one more)."""
    import torch

    mesh, r = e.mesh, _flat_rank(e.mesh)
    _mesh_barrier(mesh)
    if r == 0:
        reset_counters()
    _mesh_barrier(mesh)
    e.mult(a, b, evk)
    torch.cuda.synchronize()
    _mesh_barrier(mesh)
    path = counters()
    walls = []
    for _ in range(6):
        _mesh_barrier(mesh)
        t = time.perf_counter()
        e.mult(a, b, evk)
        torch.cuda.synchronize()
        _mesh_barrier(mesh)
        walls.append((time.perf_counter() - t) * 1e3)
    return path, walls[1:]


def mesh_engine_case(label, eng, mesh_fn, ranks, expect, keep=None,
                     batched=False, **kw):
    """The engine of ``eng``'s parameters and ``kw`` on ``ranks`` ranks as
    threads on cuda:0, each on its mesh ``mesh_fn()``: ``_sharded_flow``
    (keygen, encorypt, mult with relin and rescale, level_up,
    rotate_single, three parties' threshold decryption, with ``batched``
    mult_batched of four pairs) and decrode; every key and ciphertext
    gathered from the ranks equal to ``eng``'s (reseeded: the single-device
    engine at the same seed) mod q (raw where it is), the decode errors <
    1e-4 and the same messages on every rank. The mult, with the counters
    zeroed just before, must launch the sum over the ranks of
    ``expect(engine, one)`` (one: the single-device mult's launches); its
    wall (median of 5, rank 0's clock between barriers) and busy time
    (torch.profiler over the ranks' kernels), the phase's peak memory.
    Returns the mult's launches and ``keep(engine, words)`` of rank 0
    (every rank calls it). One card: a functional check, no speed
    claim."""
    import statistics

    import numpy as np
    import torch

    import liberate_tpu_torch

    params = {k: v for k, v in liberate_tpu_torch.params["silver"].items()
              if k != "mesh_shape"}
    rng = np.random.default_rng(SEED + 4)
    ms = [rng.uniform(-1, 1, eng.num_slots) + 1j * rng.uniform(
        -1, 1, eng.num_slots) for _ in range(2)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng.refresh(SEED)
    t = time.perf_counter()
    want, dec_t_want = _sharded_flow(eng, ms, batched)
    ct1, ct2, evk = want["ct1"], want["ct2"], want["evk"]
    reset_counters()
    eng.mult(ct1, ct2, evk)
    torch.cuda.synchronize()
    one = counters()
    t_single = time.perf_counter() - t

    def body(window):
        e = liberate_tpu_torch.CkksEngine(mesh=mesh_fn(), seed=SEED,
                                          **params, **kw)
        r = _flat_rank(e.mesh)
        t = time.perf_counter()
        words, dec_t = _sharded_flow(e, ms, batched)
        dec = e.decrode(words["out"], words["sk"])
        torch.cuda.synchronize()
        t_flow = time.perf_counter() - t
        full = {k: e.gather(v) for k, v in words.items()}
        a, b, ek = words["ct1"], words["ct2"], words["evk"]
        path, walls = _mesh_mult(e, a, b, ek)
        window(e.mesh, lambda: e.mult(a, b, ek))
        kept = keep(e, words) if keep else None
        return (full if r == 0 else None, dec, dec_t, t_flow, path, walls,
                expect(e, one), kept if r == 0 else None)

    out, busy, copies, launched = _run_mesh(ranks, body)
    full, dec, dec_t, t_flow, path, walls, _, kept = out[0]
    want_path = dict.fromkeys(one, 0)
    for o in out:
        for k, v in o[6].items():
            want_path[k] += v
    peak = torch.cuda.max_memory_allocated()
    same = {k: _words_equal(eng, full[k], want[k]) for k in want}
    err = abs(eng.absmax_error(dec, ms[0] * ms[1]))
    err_t = abs(eng.absmax_error(dec_t[:eng.num_slots], ms[0]))
    agree = all(np.array_equal(o[1], dec) and np.array_equal(o[2], dec_t)
                for o in out)
    print(f"{label}: words of the single-device engine: "
          + ", ".join(f"{k} {v or 'DIFFER'}" for k, v in same.items())
          + f"; |err| mult {err:.3e}, threshold decryption {err_t:.3e}, "
          f"{'the same' if agree else 'DIFFERENT'} messages on every rank; "
          f"the path {t_flow:.2f} s on rank 0 (single-device "
          f"{t_single:.2f} s with one more mult)")
    print(f"  {label} mult: launches "
          f"{ {k: v for k, v in path.items() if v} } (single-device "
          f"{ {k: v for k, v in one.items() if v} }); wall "
          f"{statistics.median(walls):.3f} ms (median of 5, min "
          f"{min(walls):.3f}, max {max(walls):.3f}), device busy "
          f"{busy:.3f} ms in {launched} launches (all ranks; copies to and "
          f"from host buffers {copies:.3f} ms of it); peak "
          f"device memory {peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held "
          f"before)")
    bad = [k for k, v in same.items() if not v]
    if bad:
        raise AssertionError(f"{label}: {bad} differ from the single-device "
                             f"engine")
    if not (err < 1e-4 and err_t < 1e-4 and agree):
        raise AssertionError(f"{label}: errors {err}, {err_t} or ranks "
                             f"disagree ({agree})")
    if path != want_path:
        raise AssertionError(f"{label} mult launched {path}, not "
                             f"{want_path}")
    return path, kept


def sharded_engine_phase(eng, rows):
    """The RNS-channel-sharded engine at silver on MESH_RANKS ranks as
    threads (C0_sp = 19 does not divide by 4: the padded layout), as
    ``mesh_engine_case``: the mult launches R times the single-device
    mult's kernels and no other."""
    from liberate_tpu_torch.parallel import make_mesh

    C, ranks = eng.ntt.total_channels, MESH_RANKS
    path, _ = mesh_engine_case(
        f"silver sharded engine, {ranks} ranks on cuda:0 (C0_sp {C} padded "
        f"to {-(-C // ranks) * ranks})", eng, lambda: make_mesh(ranks),
        ranks, lambda e, one: one)
    check_launches("silver sharded engine", path, own_kernels(eng), rows)


def _no_norm(one):
    """The single-device launches with every inverse transform in the
    no-normalise mode: those of the coefficient-sharded transforms."""
    out = dict.fromkeys(one, 0)
    for k, v in one.items():
        out["ntt_inv_no_norm" if k == "ntt_inv" else k] += v
    return out


def mesh2d_engine_phase(eng, rows, gen):
    """The engine on meshes with a ``coef`` axis at silver, 4 ranks as
    threads (``mesh_engine_case``): MESH2D_SHAPES, a (2 rns x 2 coef) and a
    coefficient-only (1 x 4) mesh. Its mult launches exactly the mesh
    route's kernels: R times the single-device mult's, each forward the
    local #1 of a shard (logL 14 and 13), each inverse #2 in its
    no-normalise mode (the sharded inverse's local), the split switch's #3
    on the shard's columns. Then the local kernels at rank 0's shapes
    against their twins: #3 on a coefficient shard, the switch's #1 and #2
    locals; and on the card an engine of 2^7-word shards refused."""
    import liberate_tpu_torch
    from liberate_tpu_torch.ntt import cuda_ntt
    from liberate_tpu_torch.parallel import make_mesh2d, run_ranks

    def keep(e, words):
        level = words["out"].level
        return (e.pack(level, -2), e._ksk_at(words["evk"], level),
                e.ntt.parts(level)[0].part_id, len(e.ntt.parts(level)))

    for shape in MESH2D_SHAPES:
        ranks = shape[0] * shape[1]
        _, (pack_sp, (k0, k1, at), part_off, P) = mesh_engine_case(
            f"silver 2-D mesh engine {shape[0]} rns x {shape[1]} coef, "
            f"{ranks} ranks on cuda:0", eng,
            lambda shape=shape: make_mesh2d(*shape), ranks,
            lambda e, one: _no_norm(one), keep)
        local = pack_sp.coef.local
        C, logL = local.q.shape[0], local.logN
        L = 1 << logL
        x = random_words(local.q, (P, C, L), gen, lazy=True)
        f = random_words(local.q, (2, C, L), gen, lazy=True)
        shape_label = (f"silver {shape[0]}x{shape[1]} mesh rank 0 C={C} "
                       f"logL={logL}")
        check_case("ksk_mulacc", f"{shape_label} P={P} (split switch on a "
                   f"coefficient shard)",
                   lambda: cuda_ntt.ksk_mulacc(x, k0, k1, local, at,
                                               part_off),
                   lambda: cuda_ntt.ksk_mulacc_plain(x, k0, k1, local, at,
                                                     part_off),
                   bound(8 * (3 * x.numel() + 2 * C * L),
                         2 * x.numel() * MONT_MULS), rows,
                   "liberate_tpu_torch/csrc/ksk_mulacc.cu",
                   "liberate_tpu/ntt/pallas_ntt.py:693")
        check_case("ntt_fwd_coef_shard", f"{shape_label} B={P} (switch "
                   f"extension)", lambda: cuda_ntt.ntt_fwd(x, local),
                   lambda: cuda_ntt.ntt_fwd_plain(x, local),
                   transform_bound(x, logL, 0), rows,
                   "liberate_tpu_torch/csrc/ntt.cu",
                   "liberate_tpu/ntt/pallas_ntt.py:534")
        check_case("ntt_inv_no_norm", f"{shape_label} B=2 (intt_reduce's "
                   f"local)",
                   lambda: cuda_ntt.ntt_inv(f, local, no_norm=True),
                   lambda: cuda_ntt.ntt_inv_plain(f, local, no_norm=True),
                   transform_bound(f, logL, 0), rows,
                   "liberate_tpu_torch/csrc/ntt.cu",
                   "liberate_tpu/ntt/pallas_ntt.py:1112")

    # On the card an engine whose coefficient shards are shorter than the
    # kernels' range is refused as it is made: there is no plain fallback.
    def refused():
        try:
            liberate_tpu_torch.CkksEngine(
                mesh=make_mesh2d(1, 2), seed=SEED, logN=8, scale_bits=30,
                num_scales=3, num_special_primes=2, is_secured=False)
        except ValueError:
            return True
        return False

    if not all(run_ranks(2, refused, device="cuda:0")):
        raise AssertionError("an engine of 2^7-word coefficient shards on "
                             "the card was not refused")
    print("engine on a (1, 2) mesh at logN 8 (2^7-word shards) on the card: "
          "refused as it is made")


def mxu_mesh_phase(eng_mxu, eng_mont, rows, gen):
    """The tensor-core engine on an ``rns`` mesh at silver, MESH_RANKS ranks
    as threads, in both key forms (``mesh_engine_case`` with mult_batched
    of four pairs): the words mod q of the single-device tensor-core
    engine, which folds the mod-down. Each rank's mult launches #5 and #6
    once for each width group of its rows of the ordinary layout and the
    unfolded switch of its key form (#10 with the Shoup-form key, #9 with
    the Montgomery-form one) once for each width group of its
    with-special rows; #11 never. Then #10 and #9 at rank 0's shape
    against their twins."""
    import torch

    from liberate_tpu_torch.fhe.engine import switch_route
    from liberate_tpu_torch.ntt import cuda_mxu
    from liberate_tpu_torch.parallel import make_mesh

    def expect(e, one):
        level = 1
        out = dict.fromkeys(one, 0)
        n = len(e.pack(level, -1).mxu)
        out["mxu_ntt_fwd"] = out["mxu_ntt_inv"] = n
        out[switch_route(e.ctx.logN, e.use_shoup_ksk, True)] = len(
            e.pack(level, -2).mxu)
        return out

    def keep(e, words):
        level = words["out"].level
        parts = e.ntt.parts(level)
        return (e.pack(level, -2), e._mxu_switch_tables(level),
                e._ksk_at(words["evk"], level), parts[0].part_id, len(parts),
                max(p.alpha for p in parts))

    C0, ranks = eng_mxu.ntt.total_channels, MESH_RANKS
    for e1, shoup in ((eng_mxu, True), (eng_mont, False)):
        form = "Shoup" if shoup else "Montgomery"
        _, (pack_sp, (terms, off0, _), (k0, k1, at), part_off, P, A) = \
            mesh_engine_case(
                f"silver tensor-core engine, {form}-form key, {ranks} ranks "
                f"on cuda:0 (C0_sp {C0} padded to "
                f"{-(-C0 // ranks) * ranks})", e1,
                lambda: make_mesh(ranks), ranks, expect, keep,
                batched=True, use_mxu_ntt=True, use_shoup_ksk=shoup)
        name = switch_route(e1.ctx.logN, shoup, True)
        groups = pack_sp.mxu
        C = pack_sp.q.shape[0]
        S, R = groups[0].plan.S, groups[0].plan.R
        st = torch.randint(0, 1 << 62, (P, A, S * R), generator=gen,
                           device=gen.device, dtype=torch.int64)
        check_case(
            name, f"silver rank 0's {C} rows of the with-special layout, "
            f"P={P} A={A}, {len(groups)} group(s), {form}-form key",
            lambda: cuda_mxu.dispatch_switch_inv(
                st, terms, off0, k0, k1, groups, at, part_off),
            lambda: cuda_mxu.dispatch_switch_inv(
                st, terms, off0, k0, k1, groups, at, part_off, plain=True),
            bound(*mxu_switch_work(groups, P, A, 0, S, R, mont=not shoup)),
            rows, "liberate_tpu_torch/csrc/mxu_switch.cu",
            "liberate_tpu/ntt/mxu_pallas.py:" + ("777" if shoup else "588"))


def multiprocess_phase():
    """The port as a torch.distributed job of two processes on cuda:0 at
    silver over gloo (``tests/torch_multihost_worker.py``): the RNS-sharded
    engine across them against a single-device engine of the same seed,
    and two parties' threshold decryption with one party a process. Prints
    their output and wall; a process that fails, or the time limit
    (MULTIPROCESS_TIMEOUT), fails the phase."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_multihost_worker as worker

    codes, outs, wall = worker.launch(2, "cuda:0", "silver",
                                      MULTIPROCESS_TIMEOUT)
    for out in outs:
        for line in out.splitlines():
            if line.startswith("["):
                print(f"  {line}")
    print(f"silver two-process job on cuda:0 (gloo): exit codes "
          f"{codes}, wall {wall:.2f} s (two processes' start, the engines, "
          f"both steps)")
    if codes != [0, 0] or not all(f"[{r}] OK" in o
                                  for r, o in enumerate(outs)):
        raise AssertionError("the two-process job failed:\n"
                             + "\n".join(outs))


def data_phase(eng, run):
    """save/load, clone and move_to on the card: the loaded ciphertext on
    the card (and on the CPU without the move) with the saved words; an
    in-place write to a clone of the evk leaves the evk as it was; gpu2cpu
    then cpu2gpu gives the words back on the card."""
    import torch

    ct, evk = run["out"], run["keys"][2]
    path = REPO / "build" / "liberate_tpu_torch" / "chip_smoke_ct.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    back = eng.load(eng.save(ct, path))
    t_io = time.perf_counter() - t
    host = eng.load(path, move_to_device=False)
    path.unlink()
    clone = eng.clone(evk)
    clone.data[0].data[0][0, 0] += 1
    kept = not torch.equal(clone.data[0].data[0], evk.data[0].data[0])
    moved = eng.move_to(ct, "gpu2cpu")
    again = eng.move_to(moved, "cpu2gpu")
    checks = {
        "load": eng.device(back) == "cuda" and all(
            torch.equal(a, b) for a, b in zip(back.data, ct.data)),
        "load without the move": eng.device(host) == "cpu" and all(
            torch.equal(a.to(b.device), b) for a, b in zip(host.data,
                                                          ct.data)),
        "clone": kept,
        "move_to": eng.device(moved) == "cpu" and eng.device(again) == "cuda"
        and all(torch.equal(a, b) for a, b in zip(again.data, ct.data))}
    print(f"data phase: save and load of a ciphertext {t_io * 1e3:.1f} ms; "
          + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                      for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"data phase: {checks}")


def switch_core_path(eng, evk, gen, label, rows):
    """The tensor-core switch core from extension words on a random plain
    level-1 polynomial, with the counters zeroed just before: the port's
    Shoup extension, #8 (dispatch_ksk_accum with fold_inverse) and the
    Shoup mod-down against the engine's own switch (#9 with the fused
    extension, then the mod-down), word for word; #7 then the #6 inverse
    with the reduce against #8, word for word. Times the extension, #8 and
    the mod-down."""
    import torch

    from liberate_tpu_torch.fhe.engine import _extend_shoup, \
        _mod_down_shoup, _pre_extend
    from liberate_tpu_torch.ntt import cuda_mxu

    level = 1
    pack, pack_sp = eng.pack(level, -1), eng.pack(level, -2)
    parts = eng.ntt.parts(level)
    k0, k1 = eng._ksk_stacked(evk)
    part_off = parts[0].part_id
    a = random_words(pack.q, (pack.q.shape[0], eng.ctx.N), gen)

    def extension():
        return torch.stack([
            _extend_shoup(_pre_extend(a, p.local_start, p.alpha, p),
                          p.L_enter_sh, pack_sp, eng.bp_sp[level], level)
            for p in parts])

    def switch():
        d = cuda_mxu.dispatch_ksk_accum(extension(), k0, k1, pack_sp.mxu,
                                        level, part_off, fold_inverse=True)
        return _mod_down_shoup(d, pack_sp, pack, eng.PiWs[level],
                               eng.bp_sp[level][0], eng.num_special)

    reset_counters()
    got = switch()
    want = eng._switch_mxu(a, evk, level)
    ext = extension()
    d8 = cuda_mxu.dispatch_ksk_accum(ext, k0, k1, pack_sp.mxu, level,
                                     part_off, fold_inverse=True)
    d7 = cuda_mxu.dispatch_ksk_accum(ext, k0, k1, pack_sp.mxu, level,
                                     part_off)
    d76 = cuda_mxu.dispatch(d7, pack_sp.mxu, inverse=True, post_reduce=True)
    torch.cuda.synchronize()
    path = counters()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"{label} path: extension + #8 + mod-down "
          f"{'equal to' if same else 'DIFFERS from'} the engine's switch "
          f"(#9) word for word; #6 after #7 "
          f"{'equal to' if torch.equal(d76, d8) else 'DIFFERS from'} #8; "
          f"launches {path}")
    if not same or not torch.equal(d76, d8):
        raise AssertionError(f"{label}: the switch core disagrees")
    check_launches(label, path, ["mxu_ksk_accum", "mxu_ksk_accum_inv",
                                 "mxu_ntt_inv", "mxu_switch_inv_mont"], rows)
    time_and_profile(label, "switch", switch)


def kernel_phase(preset, eng, eng_mxu, gen, rows, compile_yardstick,
                 scratch):
    """Every kernel of the preset's multiply against its twin at its shapes
    at level 1: the butterfly kernels (#4 up to logN 15), the tensor-core
    transforms, the tensor-core switch of the Shoup key's route (the folded
    #11 up to logN 15, else #10) and, but at gold, the Montgomery-key
    switch (#9); at silver also the switch core from extension words (#7,
    #8)."""
    import torch

    from liberate_tpu_torch.fhe.engine import FUSED_SWITCH_MAX_LOGN, \
        _ksk_shoup, switch_route
    from liberate_tpu_torch.ntt import cuda_mxu, cuda_ntt

    level = 1
    pack = eng.pack(level, -1)
    pack_sp = eng.pack(level, -2)
    parts = eng.ntt.parts(level)
    C, C_sp, P = pack.q.shape[0], pack_sp.q.shape[0], len(parts)
    N, logN = eng.ctx.N, eng.ctx.logN
    C0_sp = eng.ntt.total_channels
    A = max(p.alpha for p in parts)
    groups = [(g.lo, g.hi, g.plan.dA) for g in eng_mxu.pack(level, -2).mxu]
    print(f"{preset} shapes at level {level}: N={N} C={C} C_sp={C_sp} P={P} "
          f"A={A} C0_sp={C0_sp} part_off={parts[0].part_id}, width groups "
          f"(lo, hi, digits) {groups}")

    k0 = random_words(eng.pack(0, -2).q, (len(eng.ntt.parts(0)), C0_sp, N),
                      gen, lazy=True)
    k1 = random_words(eng.pack(0, -2).q, k0.shape, gen, lazy=True)
    butterfly = [
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
    if logN <= FUSED_SWITCH_MAX_LOGN:
        butterfly.append(
            ("ntt_mulacc", f"P={P} C={C_sp} level={level} (unsplit switch)",
             (random_words(pack_sp.q, (P, C_sp, N), gen, lazy=True), k0, k1,
              pack_sp.plan, level, parts[0].part_id), {}))
    kernels = {"ntt_fwd": (cuda_ntt.ntt_fwd, cuda_ntt.ntt_fwd_plain,
                           "liberate_tpu_torch/csrc/ntt.cu",
                           "liberate_tpu/ntt/pallas_ntt.py:534"),
               "ntt_inv": (cuda_ntt.ntt_inv, cuda_ntt.ntt_inv_plain,
                           "liberate_tpu_torch/csrc/ntt.cu",
                           "liberate_tpu/ntt/pallas_ntt.py:577"),
               "ksk_mulacc": (cuda_ntt.ksk_mulacc, cuda_ntt.ksk_mulacc_plain,
                              "liberate_tpu_torch/csrc/ksk_mulacc.cu",
                              "liberate_tpu/ntt/pallas_ntt.py:693"),
               "ntt_mulacc": (cuda_ntt.ntt_mulacc, cuda_ntt.ntt_mulacc_plain,
                              "liberate_tpu_torch/csrc/ntt_mulacc.cu",
                              "liberate_tpu/ntt/pallas_ntt.py:614")}
    for name, label, args, kw in butterfly:
        fn, twin, src, replaces = kernels[name]
        library = None
        if name == "ksk_mulacc":
            x = args[0]
            words = x.numel() * 3 + 2 * C_sp * N
            b = bound(8 * words, 2 * x.numel() * MONT_MULS)
            if compile_yardstick:
                def library(twin=twin, args=args):
                    # Yardstick only, used nowhere in the port: what
                    # torch.compile makes of the plain twin (no PyTorch
                    # call computes a modular product of 62-bit words).
                    t = time.perf_counter()
                    compiled = torch.compile(twin)
                    if not torch.equal(torch.stack(compiled(*args)),
                                       torch.stack(twin(*args))):
                        raise AssertionError("compiled ksk_mulacc twin "
                                             "differs")
                    print(f"  torch.compile of the twin: "
                          f"{time.perf_counter() - t:.1f} s")
                    return cuda_ms(lambda: compiled(*args), 100)[0]
        elif name == "ntt_mulacc":
            # ext and both key halves read, twiddles and quotients once,
            # d0 and d1 written; P forward transforms, 2P key products.
            x = args[0]
            b = bound(8 * (3 * x.numel() + 4 * C_sp * N),
                      x.numel() // 2 * logN * SHOUP_MULS
                      + 2 * x.numel() * MONT_MULS)
        else:
            x = args[0]
            # the exit or entry multiply
            b = transform_bound(x, logN, int(name == "ntt_inv"
                                             or kw.get("pre_enter", False)))
        check_case(name, f"{preset} {label}", lambda: fn(*args, **kw),
                   lambda: twin(*args, **kw), b, rows, src, replaces,
                   library, (scratch, args[0]) if name in ("ntt_fwd",
                                                           "ntt_inv")
                   else None)
        if name == "ntt_mulacc":
            x, plan = args[0], args[3]
            split = cuda_ms(lambda: cuda_ntt.ksk_mulacc(
                cuda_ntt.ntt_fwd(x, plan), *args[1:]), 100)
            print(f"  ntt_mulacc [{preset} {label}]: yardstick, the split "
                  f"route on the same words (ntt_fwd B={P}, then "
                  f"ksk_mulacc) {split[0]:.4f} ms (min {split[1]:.4f}, max "
                  f"{split[2]:.4f})")

    # The tensor-core kernels at the shapes of the MXU mult.
    mpack = eng_mxu.pack(level, -1)
    mpack_sp = eng_mxu.pack(level, -2)
    S, R = mpack.mxu[0].plan.S, mpack.mxu[0].plan.R
    x4 = random_words(mpack.q, (4, C, N), gen, lazy=True)
    x3 = random_words(mpack.q, (3, C, N), gen, lazy=True)
    st = torch.randint(0, 1 << 62, (P, A, N), generator=gen,
                       device=x4.device, dtype=torch.int64)
    pack0 = eng_mxu.pack(0, -2)
    terms, off0, piw = eng_mxu._mxu_switch_tables(level)
    part_off, n_sp = parts[0].part_id, eng_mxu.num_special
    ngr = len(mpack.mxu)
    mxu_cases = [
        ("mxu_ntt_fwd", f"B=4 C={C} enter (_cc_mult_core), {ngr} groups",
         lambda p: cuda_mxu.dispatch(x4, mpack.mxu, enter=True, plain=p),
         mxu_ntt_work(mpack.mxu, 4, S, R), "mxu_ntt.cu",
         "liberate_tpu/ntt/mxu_pallas.py:143"),
        ("mxu_ntt_inv", f"B=3 C={C} exitx+reduce (_relin_pre), {ngr} groups",
         lambda p: cuda_mxu.dispatch(x3, mpack.mxu, inverse=True, exitx=True,
                                     post_reduce=True, plain=p),
         mxu_ntt_work(mpack.mxu, 3, S, R), "mxu_ntt.cu",
         "liberate_tpu/ntt/mxu_pallas.py:163"),
    ]
    sw_base = (st, terms, off0)
    ks = (_ksk_shoup(k0, pack0), _ksk_shoup(k1, pack0))
    if switch_route(logN, True) == "mxu_switch":
        mxu_cases.append(
            ("mxu_switch", f"P={P} C_sp={C_sp} A={A} n_sp={n_sp} "
             f"level={level}, special then ordinary mode",
             lambda p: cuda_mxu.dispatch_switch(
                 *sw_base, piw, *ks, mpack_sp.mxu, level, part_off, n_sp,
                 plain=p),
             mxu_switch_work(mpack_sp.mxu, P, A, n_sp, S, R),
             "mxu_switch.cu", "liberate_tpu/ntt/mxu_pallas.py:815"))
    else:
        mxu_cases.append(
            ("mxu_switch_inv", f"P={P} C_sp={C_sp} A={A} level={level}, "
             f"Shoup-form key",
             lambda p: cuda_mxu.dispatch_switch_inv(
                 *sw_base, *ks, mpack_sp.mxu, level, part_off, plain=p),
             mxu_switch_work(mpack_sp.mxu, P, A, 0, S, R),
             "mxu_switch.cu", "liberate_tpu/ntt/mxu_pallas.py:777"))
    if preset != "gold":
        mxu_cases.append(
            ("mxu_switch_inv_mont", f"P={P} C_sp={C_sp} A={A} "
             f"level={level}, Montgomery-form key",
             lambda p: cuda_mxu.dispatch_switch_inv(
                 *sw_base, k0, k1, mpack_sp.mxu, level, part_off, plain=p),
             mxu_switch_work(mpack_sp.mxu, P, A, 0, S, R, mont=True),
             "mxu_switch.cu", "liberate_tpu/ntt/mxu_pallas.py:588"))
    if preset == "silver":
        ext = random_words(mpack_sp.q, (P, C_sp, N), gen, lazy=True)
        for fold, name, line in ((False, "mxu_ksk_accum", 433),
                                 (True, "mxu_ksk_accum_inv", 574)):
            mxu_cases.append(
                (name, f"P={P} C_sp={C_sp} level={level}, Montgomery-form "
                 f"key, {'coefficient' if fold else 'NTT'}-domain out",
                 lambda p, fold=fold: cuda_mxu.dispatch_ksk_accum(
                     ext, k0, k1, mpack_sp.mxu, level, part_off,
                     fold_inverse=fold, plain=p),
                 mxu_switch_work(mpack_sp.mxu, P, A, 0, S, R, mont=True,
                                 from_ext=True, inverse=fold),
                 "mxu_switch.cu", f"liberate_tpu/ntt/mxu_pallas.py:{line}"))
    for name, label, run, work, file, replaces in mxu_cases:
        by, muls, macs = work
        print(f"  {preset} {name} work: {by} bytes, {muls} 32-bit "
              f"multiplies, {macs} int8 MACs (S={S}, R={R})")
        check_case(name, f"{preset} {label}", lambda run=run: run(False),
                   lambda run=run: run(True), bound(by, muls, macs), rows,
                   "liberate_tpu_torch/csrc/" + file, replaces)


def _fields_differ(a, b):
    """The fields (pickled ``__dict__`` entries) of two contexts that
    differ; arrays must match in dtype and shape too."""
    import numpy as np

    da, db = a.__dict__, b.__dict__
    if da.keys() != db.keys():
        return sorted(set(da) ^ set(db))
    return [k for k in da if not (
        da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k])
        if isinstance(da[k], np.ndarray)
        else type(da[k]) is type(db[k]) and da[k] == db[k])]


def context_start(preset, starts):
    """The preset's context built cold on the native host math (its cached
    pickle not read, then rewritten) and read from the cache. At bronze and
    silver its pure-Python twin (``native.plain()``) is built too and must
    equal it field for field; at gold and platinum, where the twin would
    cost what a cold start cost before, every prime is checked in Python
    (prime, and q = 1 mod 2N). Records the times in ``starts``."""
    import liberate_tpu_torch
    from liberate_tpu_torch import native
    from liberate_tpu_torch.fhe.context.ckks_context import CkksContext
    from liberate_tpu_torch.fhe.context.prim_test import miller_rabin_plain

    params = {k: v for k, v in liberate_tpu_torch.params[preset].items()
              if k != "mesh_shape"}
    t = time.perf_counter()
    ctx = CkksContext(**params, read_cache=False)
    cold = time.perf_counter() - t
    t = time.perf_counter()
    CkksContext(**params)
    cached = time.perf_counter() - t
    if preset in PLAIN_COLD_EARLIER:
        bad = [q for q in ctx.q if not (
            (q - 1) % (2 * ctx.N) == 0 and miller_rabin_plain(q))]
        if bad:
            raise AssertionError(f"{preset} context: {bad} are not NTT "
                                 f"primes")
        plain = f"{PLAIN_COLD_EARLIER[preset]} in an earlier run"
        check = (f"all {len(ctx.q)} primes prime and 1 mod 2N (checked in "
                 f"Python); the pure-Python context took {plain}")
    else:
        t = time.perf_counter()
        with native.plain():
            twin = CkksContext(**params, read_cache=False, save_cache=False)
        plain = f"{time.perf_counter() - t:.2f} s in this run"
        differ = _fields_differ(ctx, twin)
        if differ:
            raise AssertionError(f"{preset} context: the native and "
                                 f"pure-Python contexts differ in {differ}")
        check = (f"its pure-Python twin {plain}, equal field for field "
                 f"({len(ctx.__dict__)} fields: the primes, the psi banks, "
                 f"every constant)")
    starts[preset] = (cold, plain)
    print(f"{preset} context ({len(ctx.q)} primes, logN {ctx.logN}): "
          f"{cold:.3f} s cold on the native host math, {cached:.3f} s from "
          f"the cache; {check}")


def host_cpu():
    """The host CPU's model name (``lscpu``; else ``/proc/cpuinfo``), its
    architecture and the cores this process may use."""
    import platform

    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    with open("/proc/cpuinfo") as f:
        out += f.read()
    model = next((line.split(":", 1)[1].strip()
                  for line in out.splitlines()
                  if line.lower().startswith("model name")), "not reported")
    return (f"{model} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} cores")


def examples_phase(rows):
    """The four examples (``liberate_tpu_torch.examples``) at silver on the
    card as a user runs them, ``main(["silver"])``, each with the counters
    zeroed just before: every error they print < 1e-4; ``ckks_engine``
    launches #1 and #2, ``evaluators`` and ``multiparty`` #1, #2 and #3
    (the butterfly split route), ``multichip`` (4 ranks as threads on the
    card, an ``rns`` and a 2-D mesh) those and #2 in its no-normalise mode
    (the coefficient-sharded inverse); none launches another kernel. Prints
    each example's wall time and errors."""
    import numpy as np
    import torch

    from liberate_tpu_torch.examples import (ckks_engine, evaluators,
                                             multichip, multiparty)

    bfly = ("ntt_fwd", "ntt_inv", "ksk_mulacc")
    for name, mod, own in (
            ("ckks_engine", ckks_engine, bfly[:2]),
            ("evaluators", evaluators, bfly),
            ("multiparty", multiparty, bfly),
            ("multichip", multichip, bfly + ("ntt_inv_no_norm",))):
        torch.cuda.synchronize()
        reset_counters()
        t = time.perf_counter()
        errors = mod.main(["silver"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        path = counters()
        worst = {k: float(np.max(v)) for k, v in errors.items()}
        top = max(worst, key=worst.get)
        print(f"example {name} at silver: {wall:.2f} s wall; {len(worst)} "
              f"errors, the largest {worst[top]:.3e} ({top}); launches "
              f"{ {k: v for k, v in path.items() if v} }")
        if not worst[top] < 1e-4:
            raise AssertionError(f"example {name}: error {worst[top]} "
                                 f"({top}) >= 1e-4")
        check_launches(f"example {name}", path, own, rows)


def engine_start(preset, dev, starts):
    """The start of the preset's engines, in parts: the context
    (``context_start``); the tensor-core tables built without the cache
    (with the build's peak device memory), built and written to the cache,
    and read from it."""
    import torch

    import liberate_tpu_torch
    from liberate_tpu_torch.fhe.context.ckks_context import CkksContext
    from liberate_tpu_torch.ntt import mxu_ntt

    params = {k: v for k, v in liberate_tpu_torch.params[preset].items()
              if k != "mesh_shape"}
    context_start(preset, starts)
    ctx = CkksContext(**params)
    groups = mxu_ntt.width_groups(ctx.q)
    for lo, hi, (dA, dB) in groups:
        mxu_ntt._cache_path(ctx, lo, hi, dA, dB).unlink(missing_ok=True)
    times = []
    for cache in (False, True, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        plans = mxu_ntt.group_plans(ctx, dev, cache=cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if not cache:
            size = sum(t.numel() * t.element_size() for _, _, p in plans
                       for t in p.tensors().values())
            peak = torch.cuda.max_memory_allocated() - held
        del plans
    files = sum(mxu_ntt._cache_path(ctx, lo, hi, *d).stat().st_size
                for lo, hi, d in groups)
    print(f"MXU tables at {preset} (groups "
          f"{[(lo, hi, d) for lo, hi, d in groups]}): {size / 1e9:.3f} GB "
          f"on the device, build {times[0]:.3f} s uncached (peak "
          f"{peak / 1e9:.3f} GB above what was held), {times[1]:.3f} s "
          f"building and writing the cache ({files / 1e9:.3f} GB of files), "
          f"{times[2]:.3f} s read from the cache")
    torch.cuda.empty_cache()


def preset_phase(preset, dev, gen, rows, scratch, new_phases, starts):
    """Bronze and platinum: the engines' start (engine_start, then the
    butterfly and tensor-core engines from the cached context and
    tables), every kernel of their multiply against its twin, the split
    of #10 and #5 by launch (platinum), and the paths with the launch
    counters zeroed: butterfly, at bronze butterfly unsplit (its mult held
    word for word against the butterfly one), tensor-core and, at
    platinum, the tensor-core engine with the Montgomery-form key. Each
    engine is freed after its path."""
    import torch

    import liberate_tpu_torch
    from liberate_tpu_torch.fhe.engine import FUSED_SWITCH_MAX_LOGN

    t0 = time.perf_counter()
    params = liberate_tpu_torch.params[preset]
    engine_start(preset, dev, starts)
    t = time.perf_counter()
    eng = liberate_tpu_torch.CkksEngine(**params, seed=SEED)
    print(f"{preset} engine (context from the cache, butterfly tables): "
          f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    eng_mxu = liberate_tpu_torch.CkksEngine(**params, seed=SEED,
                                            use_mxu_ntt=True)
    print(f"{preset} MXU engine (context and tables from the cache): "
          f"{time.perf_counter() - t:.2f} s")
    kernel_phase(preset, eng, eng_mxu, gen, rows, False, scratch)
    t = time.perf_counter()
    segment_phase(preset, eng_mxu, gen, rows, SEGMENTS[preset])
    new_phases[f"{preset} segments"] = time.perf_counter() - t
    if preset == "platinum":
        # By now this process has traced some 150 profiler windows, and the
        # profiler drops whole windows here (about half the platinum calls,
        # in one run all of them); a fresh process kept every one.
        torch.cuda.empty_cache()
        sys.stdout.flush()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--split-only", preset], check=True, timeout=900)
    split = drive_path(eng, f"{preset} butterfly", rows)
    ops_phase(eng, f"{preset} butterfly", split, rows)
    del eng
    if params["logN"] <= FUSED_SWITCH_MAX_LOGN:
        eng_unsplit = liberate_tpu_torch.CkksEngine(
            **params, seed=SEED, use_split_switch=False)
        drive_path(eng_unsplit, f"{preset} butterfly unsplit", rows,
                   per_mult=UNSPLIT_PER_MULT)
        unsplit_equals_split(f"{preset} butterfly unsplit", eng_unsplit,
                             split)
        del eng_unsplit
    del split
    run = drive_path(eng_mxu, f"{preset} MXU", rows)
    ops_phase(eng_mxu, f"{preset} MXU", run, rows)
    t = time.perf_counter()
    batched_phase(eng_mxu, f"{preset} MXU", run, rows,
                  (4,) if preset == "bronze" else (2,))
    new_phases[f"{preset} MXU batched"] = time.perf_counter() - t
    del eng_mxu, run
    if preset == "platinum":
        torch.cuda.empty_cache()
        eng_mont = liberate_tpu_torch.CkksEngine(
            **params, seed=SEED, use_mxu_ntt=True, use_shoup_ksk=False)
        drive_path(eng_mont, f"{preset} MXU Montgomery-key", rows)
        del eng_mont
    torch.cuda.empty_cache()
    print(f"{preset} phases: {time.perf_counter() - t0:.1f} s")


def main():
    start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compile-yardstick", action="store_true",
                    help="time torch.compile of the ksk_mulacc twin as its "
                         "library_ms")
    ap.add_argument("--split-only", metavar="PRESET",
                    help="only split the preset's tensor-core switch and "
                         "transform by launch (the script runs the "
                         "platinum split so, in a process of its own)")
    opts = ap.parse_args()
    if opts.compile_yardstick:
        # torch.compile compiles in this process instead of a pool of
        # worker processes that could outlive the script.
        os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
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
    from liberate_tpu_torch.fhe.context.ckks_context import CkksContext
    from liberate_tpu_torch.ntt import mxu_ntt

    if opts.split_only:
        eng_mxu = liberate_tpu_torch.CkksEngine(
            **liberate_tpu_torch.params[opts.split_only], seed=SEED,
            use_mxu_ntt=True)
        split_phase(eng_mxu, torch.Generator(device="cuda:0").manual_seed(
            SEED))
        return 0

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    cpu = host_cpu()
    print(f"host CPU: {cpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t = time.perf_counter()
    _build.build(list(_build.HOST_SOURCES))
    print(f"host math build ({_build.CXX}): {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {time.perf_counter() - t:.2f} s "
          f"({', '.join(p.name for p in libs.values())})")
    spilled = []
    for name, p in libs.items():
        # One line per kernel: its (mangled) entry, ptxas's registers and
        # shared memory, and its stack and spills; and every ptxas warning
        # (a serialised wgmma, an ignored setmaxnreg). The butterfly kernels
        # must not spill.
        log = p.with_suffix(".log")
        entry = spill = None
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry" in line:
                entry, spill = line.split("'")[1], None
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                print(f"  ptxas[{name}] {entry}: "
                      f"{line.split(':', 1)[1].strip()}; {spill}")
                if name in ("ntt", "ksk_mulacc", "ntt_mulacc") and not (
                        spill and spill.endswith(
                            " 0 bytes spill stores, 0 bytes spill loads")):
                    spilled.append(f"{name} {entry}: {spill}")
            elif "warning" in line.lower():
                print(f"  ptxas[{name}] {line.strip()}")
    if spilled:
        raise AssertionError("butterfly kernels spill: " + "; ".join(spilled))
    geometry_check()
    bfly_geometry_check()
    mulacc_geometry_check()

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    silver = liberate_tpu_torch.params["silver"]

    # -- 3. the contexts on the native host math; the tensor-core tables at
    # silver: build, cache write, cache read -----------------------------------
    starts = {}
    for preset in ("silver", "gold"):
        context_start(preset, starts)
    ctx = CkksContext(**{k: v for k, v in silver.items()
                         if k != "mesh_shape"})
    for p in Path(ctx.cache_folder).glob("mxu_*.pt"):
        p.unlink()
    times = []
    for cache in (False, True, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mxu_ntt.group_plans(ctx, dev, cache=cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    print(f"MXU tables at silver ({len(ctx.q)} channels, groups "
          f"{[(lo, hi, d) for lo, hi, d in mxu_ntt.width_groups(ctx.q)]}): "
          f"build {times[0]:.3f} s uncached, {times[1]:.3f} s building and "
          f"writing the cache, {times[2]:.3f} s read from the cache")

    # -- 4. kernels against their twins at the silver and gold shapes ----------
    rows = {}
    engines = {}
    new_phases = {}
    scratch = torch.empty(16 << 20, dtype=torch.int64, device=dev)
    for preset in ("silver", "gold"):
        params = liberate_tpu_torch.params[preset]
        t = time.perf_counter()
        eng = liberate_tpu_torch.CkksEngine(**params, seed=SEED)
        print(f"{preset} engine (context, tables): "
              f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        eng_mxu = liberate_tpu_torch.CkksEngine(**params, seed=SEED,
                                                use_mxu_ntt=True)
        print(f"{preset} MXU engine (context, tables"
              f"{', cached' if preset == 'silver' else ''}): "
              f"{time.perf_counter() - t:.2f} s")
        engines[preset] = (eng, eng_mxu)
        kernel_phase(preset, eng, eng_mxu, gen, rows,
                     opts.compile_yardstick and preset == "silver", scratch)
        ops_kernel_phase(preset, eng, eng_mxu, gen, rows, scratch)
        t = time.perf_counter()
        segment_phase(preset, eng_mxu, gen, rows, SEGMENTS[preset],
                      bcts=(4, 8) if preset == "silver" else (4,))
        new_phases[f"{preset} segments"] = time.perf_counter() - t
        if preset == "gold":
            split_phase(eng_mxu, gen)
            int8_yardstick(eng_mxu, gen)
    prime_plans_phase(dev, gen, rows, scratch)

    # -- 5. the path at logN 8: card against the CPU twins -----------------------
    t = time.perf_counter()
    for domain, kw in (
            ("butterfly", dict(use_mxu_ntt=False)),
            ("butterfly unsplit", dict(use_split_switch=False)),
            ("MXU", dict(use_mxu_ntt=True)),
            ("MXU Montgomery-key", dict(use_mxu_ntt=True,
                                        use_shoup_ksk=False))):
        outs, new_ops = [], []
        for device in ("cuda:0", "cpu"):
            e = liberate_tpu_torch.CkksEngine(device=device, **kw, **SMALL)
            sk = e.create_secret_key()
            pk = e.create_public_key(sk)
            evk = e.create_evk(sk)
            m = (torch.arange(e.num_slots, dtype=torch.float64)
                 / e.num_slots).numpy()
            ct = e.encorypt(m, pk)
            ctm = e.mult(ct, ct, evk)
            outs.append([t.to("cpu") for t in (sk.data, *pk.data, *ct.data,
                                               *ctm.data)])
            err = abs(e.absmax_error(e.decrode(ctm, sk), m * m))
            if not err < 1e-5:
                raise AssertionError(f"logN 8 {domain} on {device}: mult "
                                     f"error {err}")
            new_ops.append(small_ops(e, sk, pk, evk, ct))
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"logN 8 {domain}: the card's keys or "
                                 f"ciphertexts differ from the CPU twins'")
        print(f"logN 8 {domain} path: card and CPU twins give identical "
              f"keys, ciphertexts and mult output")
        on_card, on_cpu = new_ops
        differ = [k for k in on_card
                  if len(on_card[k]) != len(on_cpu[k]) or not all(
                      torch.equal(a, b) for a, b in zip(on_card[k],
                                                        on_cpu[k]))]
        if differ:
            raise AssertionError(f"logN 8 {domain}: the card's words differ "
                                 f"from the CPU twins' in {differ}")
        print(f"logN 8 {domain} path: card and CPU twins give identical "
              f"words for {len(on_card)} operations ({', '.join(on_card)})")
    print(f"logN 8 card against the CPU: {time.perf_counter() - t:.1f} s")

    # -- 6. the paths through the public API -------------------------------------
    eng, eng_mxu = engines["silver"]
    split = drive_path(eng, "silver butterfly", rows)
    split_ops = ops_phase(eng, "silver butterfly", split, rows, timed=True)
    galois_phase(eng, "silver butterfly", split, rows)
    t = time.perf_counter()
    batched_phase(eng, "silver butterfly", split, rows, (1, 2, 4, 8),
                  timed=(1, 8))
    multiparty_phase(eng, "silver butterfly", rows)
    new_phases["silver butterfly batched and multiparty"] = (
        time.perf_counter() - t)
    mxu = drive_path(eng_mxu, "silver MXU", rows)
    mxu_ops = ops_phase(eng_mxu, "silver MXU", mxu, rows, timed=True)
    galois_phase(eng_mxu, "silver MXU", mxu, rows)
    t = time.perf_counter()
    batched_phase(eng_mxu, "silver MXU", mxu, rows, (1, 2, 4, 8),
                  timed=(1, 2, 4, 8))
    multiparty_phase(eng_mxu, "silver MXU", rows)
    data_phase(eng_mxu, mxu)
    new_phases["silver MXU batched, multiparty and data"] = (
        time.perf_counter() - t)
    eng_mont = liberate_tpu_torch.CkksEngine(
        **liberate_tpu_torch.params["silver"], seed=SEED, use_mxu_ntt=True,
        use_shoup_ksk=False)
    mont = drive_path(eng_mont, "silver MXU Montgomery-key", rows)
    evk_mont = mont["keys"][2]
    rotate_check(eng_mont, "silver MXU Montgomery-key", mxu_ops, rows)
    t = time.perf_counter()
    batched_phase(eng_mont, "silver MXU Montgomery-key", mont, rows,
                  (1, 2, 4, 8), timed=(1, 2, 4, 8))
    new_phases["silver MXU Montgomery-key batched"] = time.perf_counter() - t
    del mont
    switch_core_path(eng_mont, evk_mont, gen, "silver MXU switch core", rows)
    eng_unsplit = liberate_tpu_torch.CkksEngine(
        **liberate_tpu_torch.params["silver"], seed=SEED,
        use_split_switch=False)
    unsplit = drive_path(eng_unsplit, "silver butterfly unsplit", rows,
                         per_mult=UNSPLIT_PER_MULT)
    unsplit_equals_split("silver butterfly unsplit", eng_unsplit, split)
    rotate_check(eng_unsplit, "silver butterfly unsplit", split_ops, rows)
    host_gap("silver butterfly mult, split and unsplit engines",
             [("split", eng, split), ("unsplit", eng_unsplit, unsplit)])
    standalone_switch_path(eng_unsplit, unsplit["keys"],
                           "silver standalone switch", rows)
    t = time.perf_counter()
    sharded_engine_phase(eng, rows)
    new_phases[SHARDED] = time.perf_counter() - t
    del eng, eng_mxu, eng_mont, eng_unsplit, evk_mont, split, unsplit
    del split_ops, mxu, mxu_ops
    del engines["silver"]
    eng, eng_mxu = engines.pop("gold")
    for e, label in ((eng, "gold butterfly"), (eng_mxu, "gold MXU")):
        run = drive_path(e, label, rows)
        ops_phase(e, label, run, rows, timed=True)
    t = time.perf_counter()
    batched_phase(eng_mxu, "gold MXU", run, rows, (1, 2, 4),
                  timed=(1, 2, 4))
    multiparty_phase(eng_mxu, "gold MXU", rows)
    new_phases["gold MXU batched and multiparty"] = time.perf_counter() - t
    t = time.perf_counter()
    coef_shard_phase(eng, gen, rows)
    new_phases[COEF_SHARD] = time.perf_counter() - t
    del eng, eng_mxu, e, run
    torch.cuda.empty_cache()

    # -- 6b. silver on every mesh, and as a job of two processes ------------
    t = time.perf_counter()
    eng = liberate_tpu_torch.CkksEngine(**silver, seed=SEED)
    mesh2d_engine_phase(eng, rows, gen)
    new_phases[MESH2D] = time.perf_counter() - t
    t = time.perf_counter()
    eng_mxu = liberate_tpu_torch.CkksEngine(**silver, seed=SEED,
                                            use_mxu_ntt=True)
    eng_mont = liberate_tpu_torch.CkksEngine(**silver, seed=SEED,
                                             use_mxu_ntt=True,
                                             use_shoup_ksk=False)
    mxu_mesh_phase(eng_mxu, eng_mont, rows, gen)
    new_phases[MXU_MESH] = time.perf_counter() - t
    del eng, eng_mxu, eng_mont
    torch.cuda.empty_cache()
    t = time.perf_counter()
    multiprocess_phase()
    new_phases[MULTIPROCESS] = time.perf_counter() - t
    t = time.perf_counter()
    examples_phase(rows)
    new_phases[EXAMPLES] = time.perf_counter() - t

    # -- 7. bronze and platinum: start, kernels, paths ---------------------------
    for preset in ("bronze", "platinum"):
        preset_phase(preset, dev, gen, rows, scratch, new_phases, starts)
    del scratch

    print("timed phases: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in new_phases.items())
        + f"; {sum(new_phases.values()):.1f} s in all")
    print(f"cold contexts on the native host math ({card}; host CPU {cpu}): "
          + ", ".join(f"{p} {cold:.3f} s (pure Python {plain})"
                      for p, (cold, plain) in starts.items()))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
