#!/usr/bin/env python3
"""Where the time of the tensor-core stage kernel goes, on one NVIDIA GPU.

    python3 stage_variants.py

Builds variants of ``liberate_tpu_torch/csrc/mxu.cuh`` with one part of
the stage switched off (into ``build/stage_variants``, one nvcc per
variant, all started together) and times the gold (6, 6) forward
transform of the multiply (B=4 enter over the 33 channels of the width
group, both stage launches) with each, from the profiler's kernel events:

- ``base``: the kernel as it is (held bit-equal to the port's);
- ``no_wgmma``: no tensor-core products;
- ``no_x_tma``, ``no_table_tma``, ``no_tma``: no copies of the X words,
  of the table tiles, or of either (the products run on stale tiles);
- ``no_epilogue``: the products without the recombination, the twiddle
  and the stores.

The variants other than ``base`` compute wrong words: only their times
mean anything. Exits non-zero without a CUDA device.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (old, new) source edits of each variant.
_X_TMA = [("mbar_arrive_tx(&sm.xfull[xs], KW * PJ * 8);\n"
           "      if (IN == kRows)",
           "mbar_arrive_tx(&sm.xfull[xs], 0);\n      if (false)"),
          ("      else\n        tma_load_4d(", "      else if (false)\n"
           "        tma_load_4d(")]
_TABLE_TMA = [("mbar_arrive_tx(&sm.full[slot], tx);\n        tma_load_3d(",
               "mbar_arrive_tx(&sm.full[slot], 0);\n        if (false) "
               "tma_load_3d(")]
VARIANTS = {
    "base": [],
    "no_wgmma": [("          wgmma<TO>(acc[u]",
                  "          if (false) wgmma<TO>(acc[u]")],
    "no_x_tma": _X_TMA,
    "no_table_tma": _TABLE_TMA,
    "no_tma": _X_TMA + _TABLE_TMA,
    "no_epilogue": [("      for (int i = 0; i < NF; ++i) {\n        u64 tw[4];",
                     "      for (int i = 0; i < 0; ++i) {\n        u64 tw[4];")],
}


def build(out):
    """One library of csrc/mxu_ntt.cu per variant: {name: path}."""
    from liberate_tpu_torch import _build

    csrc = REPO / "liberate_tpu_torch" / "csrc"
    base = (csrc / "mxu.cuh").read_text()
    texts = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit {old!r} does not apply")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "mxu.cuh").write_text(text)
        for f in ("modarith.cuh", "mxu_ntt.cu"):
            shutil.copy(csrc / f, d / f)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "mxu_ntt.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log}")
    return {name: out / name / "lib.so" for name in VARIANTS}


def main():
    import torch

    if not torch.cuda.is_available():
        print("stage_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("LIBERATE_TPU_TORCH_CACHE",
                          str(REPO / "build" / "liberate_tpu_torch" / "cache"))
    import chip_smoke
    import liberate_tpu_torch
    from liberate_tpu_torch.ntt import cuda_mxu

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    libs = build(REPO / "build" / "stage_variants")
    eng = liberate_tpu_torch.CkksEngine(**liberate_tpu_torch.params["gold"],
                                        seed=chip_smoke.SEED,
                                        use_mxu_ntt=True)
    g = next(g for g in eng.pack(1, -1).mxu if g.plan.dA == 6)
    plan = g.plan
    C, N = plan.num_channels, plan.S * plan.R
    gen = torch.Generator(device="cuda:0").manual_seed(chip_smoke.SEED)
    x = chip_smoke.random_words(plan.q, (4, C, N), gen, lazy=True)
    y, scratch = torch.empty_like(x), torch.empty_like(x)
    tables = (plan.m1e, plan.m1e_rs, plan.tw, plan.m2, plan.m2_rs)
    consts = ("q", "k", "bp", "whi", "wphi", "corr", "c_lo", "c_hi")
    print(f"gold forward transform, B=4 enter, {C} channels at (6, 6) "
          f"digits")
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).ltt_mxu_ntt
        fn.argtypes = cuda_mxu._ARGTYPES["ltt_mxu_ntt"]
        fn.restype = ctypes.c_int

        def run(fn=fn):
            rc = fn(0, 6, x.data_ptr(), x.stride(0), x.stride(1),
                    y.data_ptr(), y.stride(0), y.stride(1),
                    scratch.data_ptr(), 4, C, 16,
                    *(t.data_ptr() for t in tables),
                    *(getattr(plan, f).data_ptr() for f in consts), 0, 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch error {rc}")

        if name == "base":
            run()
            if not torch.equal(y, cuda_mxu.mxu_ntt_fwd(x, plan, enter=True)):
                raise AssertionError("the base variant differs from the "
                                     "port's kernel")
        chip_smoke.launch_split(name, run, ["stage 1", "stage 2"], groups=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
