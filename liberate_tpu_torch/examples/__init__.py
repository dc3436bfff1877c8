"""The library's examples, each a module with ``main(argv=None,
device=None)``:

    python -m liberate_tpu_torch.examples.ckks_engine [preset] [--device cpu]

``ckks_engine`` (keys, encode and encrypt, decrypt and decode, save and
load), ``evaluators`` (add, sub, mult, rotate and conjugate at every level,
scalar and plaintext operands), ``multiparty`` (threshold FHE: the
collective public, evaluation, rotation and Galois keys) and ``multichip``
(the engine sharded over 4 ranks: an ``rns`` mesh and a 2-D ``rns`` x
``coef`` mesh). Without a preset they run a small configuration (logN 10).
They run on ``cuda:0`` unless the caller names another device. ``main``
returns the errors it printed, by label.
"""
