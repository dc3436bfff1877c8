"""#3, the key multiply-accumulate of the butterfly domain's split switch
(``cuda_ntt.ksk_mulacc``; csrc/ksk_mulacc.cu): the P parts' words and the
two key halves read, the two sums written; two Montgomery products a
word of a part."""

from fhebench.harness import costs

MODULE = "liberate_tpu_torch.ntt.cuda_ntt"


def shape(x, k0, k1, plan, level, part_off):
    P, C, N = x.shape
    return dict(P=P, C=C, N=N)


def work(s):
    words = s["P"] * s["C"] * s["N"]
    by = 8 * (3 * words + 2 * s["C"] * s["N"])
    return by, 2 * words * costs.MONT_MULS, 0
