"""#5, the tensor-core forward transform of one width group
(``cuda_mxu.mxu_ntt_fwd``; csrc/mxu_ntt.cu on csrc/mxu.cuh). Per call:
the words read and written once, each channel's tables once; per element
two digit recombinations and the twiddle product; the int8 products of
both stages (S + R columns contracted a row, d x d digit planes)."""

from fhebench.harness import costs

MODULE = "liberate_tpu_torch.ntt.cuda_mxu"


def shape(x, plan, *args, **kwargs):
    C, N = plan.num_channels, plan.S * plan.R
    return dict(B=x.numel() // (C * N), C=C, d=plan.dA, S=plan.S, R=plan.R,
                mont_rec=bool(plan.mont_rec))


def work(s):
    B, C, d, S, R = s["B"], s["C"], s["d"], s["S"], s["R"]
    N = S * R
    by = 16 * B * C * N + C * costs.mxu_table_bytes(d, S, R, N)
    muls = B * C * N * (2 * costs.recombine_muls(d, s["mont_rec"])
                        + costs.MONT_MULS)
    macs = B * C * d * d * N * (S + R)
    return by, muls, macs
