"""Data-structure origin tags (reference: src/liberate/fhe/presets/types.py)."""

origins = {
    "sk": "secret key",
    "pk": "public key",
    "ksk": "key switch key",
    "rotk": "rotation key:",
    "galk": "galois key",
    "conjk": "conjugation key",
    "ct": "cipher text",
    "ctt": "cipher text triplet",
}
