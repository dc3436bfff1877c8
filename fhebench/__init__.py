"""The benchmark of the PyTorch/CUDA port of the CKKS library
(``liberate_tpu_torch``): see README.md in this folder."""
