"""Layout variants of the semi-carry kernel K8, built side by side from
`csrc/ntt_v3.cu` and timed in turns on one CUDA card, with the build,
timing and SASS helpers of `tune_ntt_hints`.

    python -m falcon_r1cs_tpu_torch.ops.tune_ntt_v3 [--out DIR]

Each variant is the committed source with one change:

- `per4` (the committed form): 4 coefficients a thread (n / 4 threads),
  phases of two stages, the limb trim, one exchange region;
- `per8`: 8 coefficients a thread (n / 8 threads), phases of three
  stages, with the hint kernels' swizzle for those ownerships (bits 5, 6
  and 7 of j flip bank bits 0x02, 0x09 and 0x14);
- `no_trim`: all 12 limbs in every stage and exchange, as before the trim;
- `per4_4_ctas`: `__launch_bounds__(n / 4, 4)`, so that at n = 1024 ptxas
  keeps to 64 registers and 4 CTAs fit an SM.

For each it prints the ptxas lines, then, on random rows but for one of
all q - 1, one of all 0 and a one-hot one, at (n, B) = (1024, 1024) and
(512, 1024): the semi epilogue's equality with `ntt_semi` limb for limb
and the hints epilogue's with `ntt_with_hints`, the median CUDA-event ms a
call (20 samples of 5 back-to-back calls) and the profiler device ms a
launch (a window of 20 launches that caught all 20, as in
`tune_ntt_hints`), variants in order, then reversed.  It also counts
the committed form's SASS instructions by opcode.  Needs nvcc and a card;
builds under DIR (default build/tune_v3 in the checkout).
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np
import torch

from ..params import FALCON_512, FALCON_1024, Q
from . import _build, cuda_ntt, ntt_limb
from .tune_ntt_hints import build_variants, card_name, in_turns, print_sass, print_turns


def _replace(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def variants(src: str) -> dict:
    """name -> ntt_v3.cu text; each transform must change the source."""
    per8 = src
    for old, new in (
        ("kPer = 4;", "kPer = 8;"), ("kPhaseStages = 2;", "kPhaseStages = 3;"),
        ("kSwz5 = 0x0A;", "kSwz5 = 0x02;"), ("kSwz6 = 0x15;", "kSwz6 = 0x09;"),
        ("(((j >> 6) & 1) * kSwz6);", "(((j >> 6) & 1) * kSwz6) ^ (((j >> 7) & 1) * 0x14);"),
    ):
        per8 = _replace(per8, old, new)
    no_trim = _replace(src, "{2, 3, 4, 6, 8, 10, 12, 12, 12, 12}", "{" + ", ".join(["12"] * 10) + "}")
    four = _replace(src, "__launch_bounds__((1 << LOG_N) / kPer)",
                    "__launch_bounds__((1 << LOG_N) / kPer, 4)")
    return {"per4": src, "per8": per8, "no_trim": no_trim, "per4_4_ctas": four}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build._BUILD_DIR.parent / "tune_v3"))
    root = Path(ap.parse_args().out)
    if root.exists():
        shutil.rmtree(root)
    src = (_build._CSRC / "ntt_v3.cu").read_text()
    libs = build_variants(root, "ntt_v3.cu", variants(src),
                          ("ntt_semi_launch", "ntt_semi_hints_launch"))
    print_sass(root / "per4" / "lib.so")
    print(card_name())
    dev = torch.device("cuda")
    for p in (FALCON_1024, FALCON_512):
        x = torch.from_numpy(np.random.default_rng(p.n + 2).integers(0, Q, size=(1024, p.n))
                             .astype(np.int32)).to(dev)
        x[-3], x[-2], x[-1] = Q - 1, 0, 0
        x[-1, 7] = 1
        tab = cuda_ntt._semi_tables(p.n, dev)
        want = {"semi": (ntt_limb.ntt_semi(x, p),), "hints": ntt_limb.ntt_with_hints(x, p)}
        batch, n = x.shape
        outs = {"semi": (torch.empty((12, batch, n), dtype=torch.int32, device=dev),),
                "hints": (torch.empty((11, batch, n), dtype=torch.int32, device=dev),
                          torch.empty((batch, n), dtype=torch.int32, device=dev))}

        def launch(lib, epilogue):
            entry = "ntt_semi_launch" if epilogue == "semi" else "ntt_semi_hints_launch"
            rc = getattr(lib, entry)(x.data_ptr(), tab["tw"].data_ptr(), tab["bounds"].data_ptr(),
                                     *(o.data_ptr() for o in outs[epilogue]), batch, p.log_n,
                                     torch.cuda.current_stream().cuda_stream)
            _build.check_launch(rc, entry)

        def check(lib, epilogue):
            for o in outs[epilogue]:
                o.fill_(-1)
            launch(lib, epilogue)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(outs[epilogue], want[epilogue])), \
                epilogue

        kinds = {"semi": "ntt_semi_kernel", "hints": "ntt_semi_kernel"}
        print_turns(in_turns(libs, kinds, check, launch), f"n={p.n} B={batch}")


if __name__ == "__main__":
    main()
