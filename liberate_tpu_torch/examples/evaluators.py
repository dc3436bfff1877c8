"""Homomorphic evaluation: add/sub/mult/rotate/conjugate at every level.

    python -m liberate_tpu_torch.examples.evaluators [preset] [--device cpu]

Mirrors the reference's "[Example] Evaluators.ipynb" error sweeps.
"""

import numpy as np

import liberate_tpu_torch
from liberate_tpu_torch.examples._params import example_params, parse_args


def main(argv=None, device=None):
    opts = parse_args(argv, __doc__)
    engine = liberate_tpu_torch.CkksEngine(device=device or opts.device,
                                           **example_params(opts.preset))
    sk = engine.create_secret_key()
    pk = engine.create_public_key(sk)
    evk = engine.create_evk(sk)
    gk = engine.create_galois_key(sk)
    conjk = engine.create_conjugation_key(sk)

    m1 = engine.example(amin=-1, amax=1)
    m2 = engine.example(amin=-1, amax=1)
    errors = {}

    def err(label, x, y):
        errors[label] = float(abs(engine.absmax_error(x, y)))
        return errors[label]

    print("level | add        | sub        | mult       | rotate     | conj")
    for level in range(engine.num_levels - 1):
        ct1 = engine.encorypt(m1, pk, level)
        ct2 = engine.encorypt(m2, pk, level)
        e_add = err(f"level {level} add",
                    engine.decrode(engine.add(ct1, ct2), sk), m1 + m2)
        e_sub = err(f"level {level} sub",
                    engine.decrode(engine.sub(ct1, ct2), sk), m1 - m2)
        e_mul = err(f"level {level} mult",
                    engine.decrode(engine.mult(ct1, ct2, evk), sk), m1 * m2)
        e_rot = err(f"level {level} rotate",
                    engine.decrode(engine.rotate_galois(ct1, gk, 3), sk),
                    np.roll(m1, 3))
        e_cnj = err(f"level {level} conj",
                    engine.decrode(engine.conjugate(ct1, conjk), sk),
                    np.conj(m1))
        print(f"{level:5d} | {e_add:.3e} | {e_sub:.3e} | {e_mul:.3e} "
              f"| {e_rot:.3e} | {e_cnj:.3e}")

    # Mixed-level (auto-leveling) ops:
    ct1 = engine.encorypt(m1, pk, 0)
    ct2 = engine.encorypt(m2, pk, 2)
    print("auto-level mult err:",
          err("auto-level mult",
              engine.decrode(engine.mult(ct1, ct2, evk), sk), m1 * m2))

    # Scalar and plaintext operands:
    ct = engine.encorypt(m1, pk)
    print("ct+scalar err:", err("ct+scalar",
                                engine.decrode(engine.add(ct, 0.5), sk),
                                m1 + 0.5))
    print("ct*scalar err:", err("ct*scalar",
                                engine.decrode(engine.mult(ct, 1.5), sk),
                                m1 * 1.5))
    print("ct*message err:", err("ct*message",
                                 engine.decrode(engine.mult(ct, m2), sk),
                                 m1 * m2))
    return errors


if __name__ == "__main__":
    main()
