"""The plain reference that judges the port's ciphertexts.

Plain NumPy and PyTorch only: it imports neither JAX nor any part of the
port, and takes nothing the port made but the ciphertexts it judges. From
the seed and the configuration it works out again what the port derived
from them: the primes (``primes``), the secret key (``chacha20``), and so
the plaintext that each timed answer has to decrypt to (``ckks``).
"""
