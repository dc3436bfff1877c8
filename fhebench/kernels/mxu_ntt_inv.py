"""#6, the tensor-core inverse transform of one width group
(``cuda_mxu.mxu_ntt_inv``; N^-1, the exit and the reduce folded into its
stages): the same work as #5's (``mxu_ntt_fwd.py``)."""

from fhebench.harness.kernels import load

MODULE = "liberate_tpu_torch.ntt.cuda_mxu"
shape = load("mxu_ntt_fwd").shape
work = load("mxu_ntt_fwd").work
