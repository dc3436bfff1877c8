"""#10 (Shoup-form key) and #9 (Montgomery-form key), the key switch of
one width group without the mod-down (``cuda_mxu.mxu_switch_inv``): #11's
work (``mxu_switch.py``) with no mod-down steps, and with a Montgomery
key one word a key entry and Montgomery key products."""

from fhebench.harness.kernels import load

MODULE = "liberate_tpu_torch.ntt.cuda_mxu"
_switch = load("mxu_switch")
work = _switch.switch_work


def shape(st, terms, off0, k0, k1, plan, key_ch, part_off, out=None,
          parts=None):
    return _switch.switch_shape(st, plan, parts, 0,
                                not isinstance(k0, tuple))
