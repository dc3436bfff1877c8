"""Basic engine use: keygen, encode and encrypt, decrypt and decode.

    python -m liberate_tpu_torch.examples.ckks_engine [preset] [--device cpu]

Mirrors the reference's "[Example] CKKS engine.ipynb".
"""

import os
import tempfile

import liberate_tpu_torch
from liberate_tpu_torch.examples._params import example_params, parse_args
from liberate_tpu_torch.utils import check_errors


def main(argv=None, device=None):
    opts = parse_args(argv, __doc__)
    engine = liberate_tpu_torch.CkksEngine(device=device or opts.device,
                                           **example_params(opts.preset))
    errors = {}

    sk = engine.create_secret_key()
    pk = engine.create_public_key(sk)

    m = engine.example(amin=-1, amax=1)

    # Separate encode / encrypt / decrypt / decode:
    pt = engine.encode(m)
    ct = engine.encrypt(pt, pk)
    dec = engine.decode(engine.decrypt(ct, sk))
    print("== separate encode/encrypt ==")
    errors["separate encode/encrypt"] = float(check_errors(dec, m).max())

    # Fused (with bias-guard DC protection):
    ct = engine.encorypt(m, pk)
    dec = engine.decrode(ct, sk)
    print("== fused encorypt/decrode ==")
    errors["fused encorypt/decrode"] = float(check_errors(dec, m).max())

    # Serialization round trip:
    with tempfile.TemporaryDirectory() as d:
        fn = engine.save(ct, os.path.join(d, "ct.pkl"))
        ct2 = engine.load(fn)
    print("== after save/load ==")
    errors["after save/load"] = float(
        check_errors(engine.decrode(ct2, sk), m).max())
    return errors


if __name__ == "__main__":
    main()
