"""Preset parameter envelopes.

Mirrors the reference presets (reference: src/liberate/fhe/presets/params.py:1-30):
bronze/silver/gold/platinum with scale_bits=40. The ``mesh_shape`` entry
names how many devices the RNS channel axis is sharded over; the port runs
on one device and ignores it.
"""

params = {
    "bronze": {
        "logN": 14,
        "num_special_primes": 1,
        "scale_bits": 40,
        "num_scales": None,
        "mesh_shape": None,
    },
    "silver": {
        "logN": 15,
        "num_special_primes": 2,
        "scale_bits": 40,
        "num_scales": None,
        "mesh_shape": None,
    },
    "gold": {
        "logN": 16,
        "num_special_primes": 4,
        "scale_bits": 40,
        "num_scales": None,
        "mesh_shape": None,
    },
    "platinum": {
        "logN": 17,
        "num_special_primes": 6,
        "scale_bits": 40,
        "num_scales": None,
        "mesh_shape": None,
    },
}
