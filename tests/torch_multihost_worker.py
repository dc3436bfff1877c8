"""One process of a two-process run of the port over ``torch.distributed``
(gloo); not a test module. ``tests/test_torch_multihost.py`` runs it on the
CPU and ``chip_smoke.py`` on ``cuda:0``, both through ``launch``:

    python tests/torch_multihost_worker.py RANK WORLD PORT DEVICE PARAMS \\
        TIMEOUT [FAIL_RANK]

joins the job at ``tcp://127.0.0.1:PORT`` as RANK of WORLD (every
collective carries TIMEOUT seconds), with the engines on DEVICE (``cpu``
or ``cuda:0``) at PARAMS (``small``: logN 8, or a preset name), and runs:

1. the RNS-channel-sharded engine across the processes: ``make_mesh(WORLD)``
   from the job; keys, ``encorypt``, ``mult``, ``rotate_single``. The words
   gathered from the ranks must be those of a single-device engine at the
   same seed, built in this process;
2. threshold FHE with one party a process (the counterpart of
   ``tests/multihost_worker.py``): every process draws the common CRS from
   the same seed (identical across the processes, checked by a gather),
   makes its secret key and public share, the pk0 shares cross by
   ``all_gather`` into the collective key, every process encrypts the same
   message under it, party 0 takes the decryption's head and the others
   their partial decryptions, which cross by ``all_gather`` into the
   fusion: error < 1e-4.

Prints ``[RANK] ...`` lines, ``[RANK] OK`` last. Any exception ends the
process at once with exit code 1, which closes its connections, so the
peers' collectives fail too instead of waiting out their time limit
(FAIL_RANK: that rank raises once the mesh is made, to show it).
"""

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SMALL = dict(logN=8, scale_bits=30, num_scales=3, num_special_primes=2,
             is_secured=False)
SEED = 20260817


def _tensors(x):
    from liberate_tpu_torch import DataStruct

    if isinstance(x, DataStruct):
        return _tensors(x.data)
    if isinstance(x, (tuple, list)):
        return [t for d in x for t in _tensors(d)]
    return [x]


def _flow(e, m):
    sk = e.create_secret_key()
    pk = e.create_public_key(sk)
    evk = e.create_evk(sk)
    rotk = e.create_rotation_key(sk, 1)
    ct = e.encorypt(m, pk)
    out = e.mult(ct, ct, evk)
    rot = e.rotate_single(ct, rotk)
    return dict(sk=sk, pk=pk, evk=evk, rotk=rotk, ct=ct, mult=out,
                rotate_single=rot), (e.decrode(out, sk), e.decrode(rot, sk))


def _gather(x, world):
    """Every process's x (a tensor), as a list in rank order, on x's
    device (gloo moves host tensors)."""
    import torch
    import torch.distributed as dist

    buf = x.contiguous().cpu()
    outs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(outs, buf)
    return [o.to(x.device) for o in outs]


def sharded_step(rank, world, device, params, fail=False):
    """Step 1: the engine over make_mesh(world) against a single-device
    engine of the same seed (``fail``: raise once the mesh is made, while
    the peers go on into the engine's collectives)."""
    import numpy as np
    import torch

    import liberate_tpu_torch
    from liberate_tpu_torch.parallel import make_mesh

    t = time.perf_counter()
    rng = np.random.default_rng(SEED)
    e1 = liberate_tpu_torch.CkksEngine(devices=device, seed=SEED, **params)
    m = (rng.uniform(-1, 1, e1.num_slots)
         + 1j * rng.uniform(-1, 1, e1.num_slots))
    want, _ = _flow(e1, m)
    mesh = make_mesh(world, devices=[device] * world)
    if fail:
        raise RuntimeError(f"[{rank}] told to fail")
    e = liberate_tpu_torch.CkksEngine(mesh=mesh, seed=SEED, **params)
    got, (dec, dec_rot) = _flow(e, m)
    for k, w in want.items():
        a, b = _tensors(e.gather(got[k])), _tensors(w)
        if len(a) != len(b) or not all(torch.equal(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"[{rank}] sharded {k} differs from the "
                                 f"single-device engine's words")
    err = max(np.abs(dec - m * m).max(), np.abs(dec_rot - np.roll(m, 1))
              .max())
    if not err < 1e-4:
        raise AssertionError(f"[{rank}] sharded engine error {err}")
    rows = e.ntt.rows(0, -2)
    print(f"[{rank}] sharded engine over {world} processes (rows {rows} of "
          f"the level-0 with-special layout): keys, encorypt, mult and "
          f"rotate_single the single-device words; |err| {err:.3e}; "
          f"{time.perf_counter() - t:.2f} s", flush=True)


def parties_step(rank, world, device, params):
    """Step 2: one party a process, threshold decryption across them."""
    import numpy as np
    import torch

    import liberate_tpu_torch

    t = time.perf_counter()
    eng = liberate_tpu_torch.CkksEngine(devices=device, seed=SEED + 1,
                                        **params)
    # The CRS comes from the common stream: the same draw on every process.
    crs = eng.rng.randint(amax=eng.ntt.q_ints(0, -1), repeats=0)
    every = _gather(crs, world)
    if not all(torch.equal(c, every[0]) for c in every):
        raise AssertionError(f"[{rank}] the CRS differs across processes")
    print(f"[{rank}] CRS identical across {world} processes", flush=True)
    eng.refresh(seed=1000 + rank)
    sk = eng.create_secret_key()
    share = eng.multiparty_create_public_key(sk, a=crs)
    cpk = eng.multiparty_create_collective_public_key(
        [share._replace(data=(pk0, share.data[1]))
         for pk0 in _gather(share.data[0], world)])
    eng.refresh(seed=555)
    m = (np.linspace(-1, 1, eng.num_slots)
         + 1j * np.linspace(1, -1, eng.num_slots))
    ct = eng.encorypt(m, cpk)
    if rank == 0:
        pct = eng.multiparty_decrypt_head(ct, sk)
    else:
        pct = eng.multiparty_decrypt_partial(ct, sk)
    dec = eng.multiparty_decrypt_fusion(_gather(pct, world), level=ct.level)
    err = np.abs(dec - m).max()
    if not err < 1e-4:
        raise AssertionError(f"[{rank}] threshold decryption error {err}")
    print(f"[{rank}] threshold decryption across {world} processes: "
          f"|err| {err:.3e}; {time.perf_counter() - t:.2f} s", flush=True)


def main(argv):
    rank, world, port = (int(a) for a in argv[:3])
    device, which, timeout = argv[3], argv[4], float(argv[5])
    fail_rank = int(argv[6]) if len(argv) > 6 else -1
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    import liberate_tpu_torch

    if device == "cpu":
        torch.set_num_threads(1)
    params = SMALL if which == "small" else {
        k: v for k, v in liberate_tpu_torch.params[which].items()
        if k != "mesh_shape"}
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    sharded_step(rank, world, device, params, fail=rank == fail_rank)
    parties_step(rank, world, device, params)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "liberate_tpu"))
    if bad:
        raise AssertionError(f"[{rank}] imported {bad}")
    dist.destroy_process_group()
    print(f"[{rank}] OK", flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, device, params="small", timeout=60.0, fail_rank=-1,
           kill_on_failure=True):
    """Run ``world`` workers and wait for them at most ``timeout`` seconds
    (each collective gets as long). The time limit, and with
    ``kill_on_failure`` a worker that fails, kills every worker still
    running. Returns their exit codes, their outputs and the wall in
    seconds."""
    outs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    port = _free_port()
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(port), device, params, str(timeout), str(fail_rank)],
        stdout=out, stderr=subprocess.STDOUT, text=True, cwd=str(REPO))
        for r, out in enumerate(outs)]
    try:
        while time.perf_counter() - t < timeout:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or (
                    kill_on_failure and any(c for c in codes)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
    wall = time.perf_counter() - t
    texts = []
    for out in outs:
        out.seek(0)
        texts.append(out.read())
        out.close()
    return codes, texts, wall


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except BaseException:      # noqa: BLE001 - any failure ends the process
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
