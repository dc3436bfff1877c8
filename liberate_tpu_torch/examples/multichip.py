"""Multi-rank use: the engine sharded over the RNS channel axis.

    python -m liberate_tpu_torch.examples.multichip [preset] [--device cpu]

The reference spreads RNS channels over GPUs with per-device tensor lists
(reference: src/liberate/ntt/rns_partition.py, ckks_engine.py:746-904);
here each of 4 ranks runs the engine on its rows of the padded channel
axis, with explicit collectives between them. Every public API call is
unchanged: the mesh is a constructor argument. The ranks run as threads of
this process on one device (``parallel.run_ranks``); rank 0 prints.
"""

import numpy as np

import liberate_tpu_torch
from liberate_tpu_torch.examples._params import example_params, parse_args
from liberate_tpu_torch.parallel import (make_mesh, make_mesh2d, run_ranks,
                                         shard_datastruct)
from liberate_tpu_torch.utils import check_errors

RANKS = 4


def _rank(params):
    mesh = make_mesh(RANKS)    # 1-D mesh over the 'rns' (channel) axis
    first = mesh.axis_index("rns") == 0
    errors = {}

    def report(label, x, y):
        """Rank 0 prints the error statistics; every rank keeps |x - y|'s
        maximum."""
        if first:
            print(f"== {label} ==")
            errors[label] = float(check_errors(x, y).max())
        else:
            errors[label] = float(np.abs(np.asarray(x) - np.asarray(y)).max())

    if first:
        print(f"mesh: {RANKS} ranks x {mesh.device.type}")

    engine = liberate_tpu_torch.CkksEngine(mesh=mesh, **params)

    sk = engine.create_secret_key()     # born sharded on the mesh
    pk = engine.create_public_key(sk)
    evk = engine.create_evk(sk)

    m1 = engine.example(amin=-1, amax=1)
    m2 = engine.example(amin=-1, amax=1)
    ct1 = engine.encorypt(m1, pk)
    ct2 = engine.encorypt(m2, pk)

    # The channel (RNS) axis of every polynomial is spread over the mesh:
    if first:
        print("ciphertext poly on rank 0:", tuple(ct1.data[0].shape), mesh)

    out = engine.mult(ct1, ct2, evk)    # relin + rescale inside
    report("sharded mult", engine.decrode(out, sk), m1 * m2)

    gk = engine.create_galois_key(sk)
    rot = engine.rotate_galois(out, gk, 5)
    report("sharded rotate", engine.decrode(rot, sk), np.roll(m1 * m2, 5))

    # Import single-device data onto the mesh (pads uneven channel counts).
    # The ranks of this process share one single-device engine and its data.
    def host_data():
        eng1 = liberate_tpu_torch.CkksEngine(device=mesh.device, **params)
        sk_host = eng1.create_secret_key()
        return eng1.encorypt(m1, eng1.create_public_key(sk_host)), sk_host

    ct_host, sk_host = mesh.shared("multichip example host data", host_data)
    ct_mesh = shard_datastruct(ct_host, mesh)
    sk_mesh = shard_datastruct(sk_host, mesh)
    report("imported host ciphertext", engine.decrode(ct_mesh, sk_mesh), m1)

    # 2-D ('rns', 'coef') layout: channels over one mesh axis AND each
    # polynomial's coefficients over the other, so a single transform
    # spans ranks (cross-shard NTT stages are paired exchanges,
    # liberate_tpu_torch/parallel/coef_shard.py). Same API, different mesh.
    mesh2 = make_mesh2d(2, RANKS // 2)
    eng2 = liberate_tpu_torch.CkksEngine(mesh=mesh2, **params)
    sk2 = eng2.create_secret_key()
    pk2 = eng2.create_public_key(sk2)
    evk2 = eng2.create_evk(sk2)
    c1 = eng2.encorypt(m1, pk2)
    c2 = eng2.encorypt(m2, pk2)
    if first:
        print("ciphertext poly on rank 0 of the 2-D mesh:",
              tuple(c1.data[0].shape), mesh2)
    report("2-D (rns, coef) mesh mult",
           eng2.decrode(eng2.mult(c1, c2, evk2), sk2), m1 * m2)
    return errors


def main(argv=None, device=None):
    """Runs the example on RANKS ranks; returns {label: every rank's
    error}."""
    opts = parse_args(argv, __doc__)
    params = example_params(opts.preset)
    out = run_ranks(RANKS, lambda: _rank(params),
                    device=device or opts.device)
    return {k: tuple(o[k] for o in out) for k in out[0]}


if __name__ == "__main__":
    main()
