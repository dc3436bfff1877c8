"""#11, the fused key switch of one width group with the special-prime
mod-down folded in (``cuda_mxu.mxu_switch``; csrc/mxu_switch.cu). Per
call of B ciphertext segments of P parts, A channels a part: the state
rows, the Shoup-form key (value and quotient) of both halves for every
part and channel, the forward and inverse tables, the exported dropped
rows and the output; P forward and 2 inverse transforms a channel, the
basis extension, the key products and the mod-down's n_sp steps."""

from fhebench.harness import costs

MODULE = "liberate_tpu_torch.ntt.cuda_mxu"


def switch_shape(st, plan, parts, n_sp, mont):
    BP, A, N = st.shape
    P = BP if parts is None else parts
    return dict(B=BP // P, P=P, A=A, n_sp=n_sp, C=plan.num_channels,
                d=plan.dA, S=plan.S, R=plan.R, mont=mont)


def shape(st, terms, off0, piw, k0, k1, plan, key_ch, part_off, n_sp,
          special, srcs=None, out=None, parts=None):
    return switch_shape(st, plan, parts, n_sp, False)


def switch_work(s):
    B, P, A, n_sp = s["B"], s["P"], s["A"], s["n_sp"]
    C, d, S, R = s["C"], s["d"], s["S"], s["R"]
    N = S * R
    key_words, key_muls = ((2, costs.MONT_MULS) if s["mont"]
                           else (4, costs.SHOUP_MULS))
    ext = costs.BARRETT_MULS + (A - 1) * costs.SHOUP_MULS
    tr = 2 * costs.recombine_muls(d) + costs.MONT_MULS
    by = (B * (8 * P * A * N + 2 * 8 * 2 * n_sp * N)
          + C * (key_words * 8 * P * N
                 + 2 * costs.mxu_table_bytes(d, S, R, N) + B * 2 * 8 * N))
    muls = B * C * N * (P * (ext + tr + 2 * key_muls)
                        + 2 * (tr + n_sp * (costs.BARRETT_MULS
                                            + costs.SHOUP_MULS)))
    macs = B * C * d * d * N * (S + R) * (P + 2)
    return by, muls, macs


work = switch_work
