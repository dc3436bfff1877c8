"""Multiparty (threshold) FHE: all four reference protocols.

    python -m liberate_tpu_torch.examples.multiparty [preset] [--device cpu]

Mirrors the reference's "MultiParty Enc & Dec", "Multiparty Evk",
"Multiparty Rotation", and "Multiparty Galois" notebooks. All parties share
one engine (same parameters); shares are exchanged as DataStructs.
"""

import liberate_tpu_torch
from liberate_tpu_torch.examples._params import example_params, parse_args

N_PARTIES = 3


def main(argv=None, device=None):
    opts = parse_args(argv, __doc__)
    engine = liberate_tpu_torch.CkksEngine(device=device or opts.device,
                                           **example_params(opts.preset))
    errors = {}

    def err(label, x, y):
        errors[label] = float(abs(engine.absmax_error(x, y)))
        return errors[label]

    # Per-party secret keys.
    sks = [engine.create_secret_key() for _ in range(N_PARTIES)]

    # --- Collective public key (common reference string from party 0) ----
    pk0 = engine.multiparty_create_public_key(sks[0])
    crs = engine.multiparty_public_crs(pk0)
    pks = [pk0] + [engine.multiparty_create_public_key(sk, a=crs)
                   for sk in sks[1:]]
    cpk = engine.multiparty_create_collective_public_key(pks)

    # --- Threshold encryption/decryption ---------------------------------
    m = engine.example(amin=-1, amax=1)
    ct = engine.encorypt(m, cpk)
    pcts = [engine.multiparty_decrypt_head(ct, sks[0])]
    pcts += [engine.multiparty_decrypt_partial(ct, sk) for sk in sks[1:]]
    dec = engine.multiparty_decrypt_fusion(pcts, level=ct.level)
    print("threshold enc/dec err:", err("threshold enc/dec", dec, m))

    # --- Collective evaluation key (3-round protocol) ---------------------
    # Round 1: each party publishes a ksk(sk_i -> sk_i) share on a common CRS.
    evk_shares = [engine.create_key_switching_key(sks[0], sks[0])]
    evk_crs = engine.generate_rotation_crs(evk_shares[0])
    evk_shares += [engine.multiparty_create_key_switching_key(sk, sk,
                                                              a=evk_crs)
                   for sk in sks[1:]]
    # Round 2: sum the shares; each party multiplies by its secret.
    evk_sum = engine.multiparty_sum_evk_share(evk_shares)
    evk_mult = [engine.multiparty_mult_evk_share_sum(evk_sum, sk)
                for sk in sks]
    # Round 3: sum the re-encrypted shares.
    cevk = engine.multiparty_sum_evk_share_mult(evk_mult)

    ctm = engine.mult(ct, ct, evk=cevk)
    pcts = [engine.multiparty_decrypt_head(ctm, sks[0])]
    pcts += [engine.multiparty_decrypt_partial(ctm, sk) for sk in sks[1:]]
    dec = engine.multiparty_decrypt_fusion(pcts, level=ctm.level)
    print("collective-evk mult err:", err("collective-evk mult", dec, m * m))

    # --- Collective rotation / Galois keys --------------------------------
    rotk0 = engine.multiparty_create_rotation_key(sks[0], delta=1)
    rot_crs = engine.generate_rotation_crs(rotk0)
    rotks = [rotk0] + [engine.multiparty_create_rotation_key(sk, 1, a=rot_crs)
                       for sk in sks[1:]]
    crotk = engine.multiparty_generate_rotation_key(rotks)
    print("collective rotation key assembled:", crotk.origin)

    galk0 = engine.multiparty_create_galois_key(
        sks[0], a=[None] * len(engine.galois_deltas))
    gal_crs = engine.generate_galois_crs(galk0)
    galks = [galk0] + [engine.multiparty_create_galois_key(sk, a=gal_crs)
                       for sk in sks[1:]]
    cgalk = engine.multiparty_generate_galois_key(galks)
    print("collective galois key assembled:", cgalk.origin)
    return errors


if __name__ == "__main__":
    main()
