"""The merge-level kernel's lanes-a-CTA forms (`csrc/msm_bucket.cu`),
timed in turns at every level of two 22-window 2^17 groups on one CUDA
card, with the build, timing and SASS helpers of `tune_ntt_hints`.

    python -m falcon_r1cs_tpu_torch.ops.tune_msm_bucket [--out DIR]
        [--forms 256,32,...] [--variants committed,key_order,...]
        [--parent PATH]

The forms are template instances of one library, chosen by the C entry's
`lanes` argument.  The variants are the committed source with one change,
each built into its own library under DIR: `committed`; `lane_order`, a
CTA writes the buckets of its own lanes at every level, `key_order`, of
its nodes in key order at every level (committed: key order where c <=
nb, the narrow levels);
`unroll7`, 7 limbs of a coordinate loaded at once in the copy (5
committed); `blocks8`, `__launch_bounds__(256, 8)` (at most 32 registers
a thread, 64 warps an SM); `batch4`, 4 words a thread loaded before they
are stored in the bucket writes (8 committed).  `--parent PATH` adds the
variant `parent`, the kernel of PATH (a `msm_bucket.cu` whose entry takes
no lanes count: one form, a thread a lane).  Each (variant, form) runs
through the wrapper `msm_bucket.bucket_level_cuda` with the variant's
entry point bound in place of the library's.

The groups: "r", the window-12 digits of random scalars below r
(`random_keys`, as chip_smoke.py's); "b", cell B's a query, the digits of
the Falcon-512 assignment of instance seed 5 (`witness_keys`: 62.5 % of
the scalars 0, windows 12-21 all zero), each recoded, sorted and placed
bit-reversed as `gpu_msm._window_sums` does; H, T, the bridge and the
bank random limbs and flags (`level_inputs`).

It prints the ptxas lines of every instantiation of every variant, the
SASS opcode counts of each of the committed source's and of its
bucket-write loop (the kernel's last loop; the listing goes to
DIR/bucket_level_sass.txt), then for each (variant, form) in order, then
reversed, and each level of each group: bit-equality with the plain
version (H', T', kf', kl' and the whole bank), the median CUDA-event ms a
call (20 samples of 5 calls) and the profiler device ms a launch (a
window of 20 launches); then for each variant a level's form that the
entry picks (`msm_bucket.lanes_a_cta`) beside its fastest by device ms.
Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import _build, msm_bucket, msm_recode
from .tune_ntt_hints import build_variants, card_name, in_turns, print_sass, print_turns

WINDOW = 12
NB = (1 << (WINDOW - 1)) + 1


def _keys(scalars, n_pad: int):
    """The sorted, bit-reversed window keys (nw, n_pad) of (n, 4) int64
    scalars (u64 limbs), no point infinite, as `gpu_msm._window_sums`
    sorts them."""
    from ..snark import gpu_msm

    inf = torch.zeros(scalars.shape[0], dtype=torch.bool, device=scalars.device)
    digits, _ = msm_recode.signed_digits_cuda(scalars, inf, WINDOW, n_pad)
    return gpu_msm._sorted_leaves(digits, WINDOW)[1]


def random_keys(log_n: int, device, seed: int = 20261027):
    """The keys of 2^log_n random scalars below r."""
    from ..snark.bls12_381 import R
    from ..snark.points import ints_to_limbs

    rng = np.random.default_rng(seed)
    sc = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(1 << log_n)]
    return _keys(torch.from_numpy(ints_to_limbs(sc, 4).view(np.int64)).to(device), 1 << log_n)


def witness_keys(z, device):
    """The keys of an assignment z ((N, 4) u64 rows) as an MSM's scalars,
    padded with zeros to the next power of two (cell B's a query)."""
    n_pad = 1 << (len(z) - 1).bit_length()
    return _keys(torch.from_numpy(np.ascontiguousarray(z).view(np.int64)).to(device), n_pad)


def falcon512_assignment():
    """Cell B's assignment: the host trace of the Falcon-512
    verify-with-NTT circuit on instance seed 5, (N, 4) u64 rows."""
    from ..falcon import make_instance
    from ..params import FALCON_512
    from ..tools.profile_prove import INSTANCE_SEED, trace_assignment

    return trace_assignment(make_instance(np.random.default_rng(INSTANCE_SEED), FALCON_512))[1]


def level_inputs(keys, c: int, g: torch.Generator):
    """(bridge, H, T, kf, kl, bank, nb) of the level of c lanes of a group
    with these keys (W, n): kf = keys[:, :c], kl = keys[:, n - c:] (at c =
    n the affine leaves, kf = kl = the keys); H, T, the bridge and the
    bank random limbs and flags from `g` (the level only moves them)."""
    W, n = keys.shape
    dev = keys.device

    def limbs(*shape):
        return torch.randint(-2**12, 2**12, shape, generator=g, device=dev, dtype=torch.int32)

    def flags(*shape):
        return torch.randint(0, 2, shape, generator=g, device=dev).bool()

    if c == n:
        H = T = (limbs(35, W, n), limbs(35, W, n), None, flags(W, n))
        kf = kl = keys
    else:
        H, T = ((limbs(35, W, c), limbs(35, W, c), limbs(35, W, c), flags(W, c))
                for _ in range(2))
        kf, kl = keys[:, :c].contiguous(), keys[:, n - c:].contiguous()
    bridge = (limbs(35, W, c // 2), limbs(35, W, c // 2), limbs(35, W, c // 2),
              flags(W, c // 2))
    bank = (*limbs(3, 35, W * NB).unbind(), flags(W * NB))
    return bridge, H, T, kf, kl, bank, NB


def level_of(n: int, c: int) -> int:
    """The merge level of c lanes in a tree over n leaves (level 1: c = n)."""
    return n.bit_length() - c.bit_length() + 1


def loop_sass(so: Path, fragment: str, out: Path) -> dict:
    """name -> Counter of the SASS opcodes of the last loop (the last
    backward branch and the instructions from its target) of each kernel
    of `so` whose name holds `fragment`; their listings go to `out`."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and fragment in name:
            funcs[name].append(line)
    funcs = {k: v for k, v in funcs.items() if fragment in k}
    out.write_text("\n".join(f"Function : {k}\n" + "\n".join(v) for k, v in funcs.items()))
    loops = {}
    for name, lines in funcs.items():
        ins = []
        for line in lines:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*)", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
        back = [(t, a) for a, op, rest in ins if op == "BRA"
                for t in [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)", rest)[:1]] if t < a]
        if back:
            lo, hi = back[-1]
            loops[name] = collections.Counter(op for a, op, _ in ins if lo <= a <= hi)
    return loops


def _median_device(samples) -> float:
    """The median profiler device ms of a (variant, form)'s turns, those
    whose window caught no launch left out (the events' median if none
    caught one)."""
    dev = [d for _, d in samples if d == d]
    return statistics.median(dev or [e for e, _ in samples])


def variants(src: str) -> dict:
    """name -> source text; each transform must change the source."""
    out = {
        "committed": src,
        "lane_order": src.replace("const bool key_order = c <= nb;",
                                  "const bool key_order = false;"),
        "key_order": src.replace("const bool key_order = c <= nb;", "const bool key_order = true;"),
        "unroll7": src.replace("constexpr int kCopyUnroll = 5;", "constexpr int kCopyUnroll = 7;"),
        "blocks8": src.replace("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 8;"),
        "batch4": src.replace("constexpr int kBatch = 8;", "constexpr int kBatch = 4;"),
    }
    assert len(set(out.values())) == len(out), "a transform no longer applies"
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build._BUILD_DIR.parent / "tune_msm_bucket"))
    ap.add_argument("--forms", default=",".join(map(str, msm_bucket.LANE_FORMS)))
    ap.add_argument("--variants", default="committed")
    ap.add_argument("--parent")
    args = ap.parse_args()
    root = Path(args.out)
    root.mkdir(parents=True, exist_ok=True)
    names = args.variants.split(",")
    srcs = variants((_build._CSRC / "msm_bucket.cu").read_text())
    srcs = {k: srcs[k] for k in names}
    if args.parent:
        srcs["parent"] = Path(args.parent).read_text()
    libs = build_variants(root / "variants", "msm_bucket.cu", srcs, ())
    so = root / "variants" / names[0] / "lib.so"
    print_sass(so, "bucket_level_kernel")
    for name, ops in loop_sass(so, "bucket_level_kernel", root / "bucket_level_sass.txt").items():
        print(f"SASS loop {name}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
    print(card_name())
    _build.library()  # the wrapper's launch path, whose entry each variant's replaces
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20261027)
    groups = {"r": random_keys(17, dev), "b": witness_keys(falcon512_assignment(), dev)}
    cases, kinds = {}, {}
    for gname, keys in groups.items():
        W, n = keys.shape
        c = n
        while c > 1:
            kind = f"{gname}{level_of(n, c)}"
            args_ = level_inputs(keys, c, g)
            bank = tuple(a.clone() for a in args_[5])
            want = msm_bucket.bucket_level(*args_[:5], bank, NB)
            cases[kind] = (args_, want[0] + want[1] + want[2:] + bank, (W, c))
            kinds[kind] = "bucket_level_kernel"
            c //= 2
    torch.cuda.synchronize()

    def run(entry, kind, bank=None):
        fn, lanes = entry
        _build._FN["bucket_level_launch"] = fn
        args_ = cases[kind][0]
        return msm_bucket.bucket_level_cuda(*args_[:5], args_[5] if bank is None else bank,
                                            NB, lanes)

    def check(entry, kind):
        bank = tuple(a.clone() for a in cases[kind][0][5])
        got = run(entry, kind, bank)
        torch.cuda.synchronize()
        for a, b in zip(got[0] + got[1] + got[2:] + bank, cases[kind][1]):
            assert torch.equal(a, b), (kind, entry)

    forms = {}
    for v in names:
        fn = libs[v].bucket_level_launch
        fn.argtypes = _build._ARGTYPES["bucket_level_launch"]
        forms |= {f"{v}:L{L}": (fn, L) for L in map(int, args.forms.split(","))}
    if args.parent:
        # the parent's entry takes no lanes count: the wrapper's is dropped
        fn = libs["parent"].bucket_level_launch
        fn.argtypes = _build._ARGTYPES["bucket_level_launch"][:24] + [ctypes.c_void_p]
        forms["parent:L256"] = (lambda *a, fn=fn: fn(*a[:24], a[25]), 256)
        names.append("parent")
    res = in_turns(forms, kinds, check, run)
    print_turns(res, "bucket")
    for v in names:
        for gname in groups:
            total = collections.Counter()
            for kind in sorted((k for k in kinds if k[0] == gname), key=lambda k: int(k[1:])):
                W, c = cases[kind][2]
                dev_ms = {name: _median_device(res[kind, name])
                          for name in forms if name.startswith(v + ":")}
                best = min(dev_ms, key=dev_ms.get)
                auto = f"{v}:L{256 if v == 'parent' else msm_bucket.lanes_a_cta(W, c)}"
                total["best"] += dev_ms[best]
                total["auto"] += dev_ms.get(auto, float("nan"))
                print(f"bucket {kind:5s} {W * c // 2:8d} lanes: entry's form {auto} "
                      f"{dev_ms.get(auto, float('nan')):.4f} ms, fastest {best} "
                      f"{dev_ms[best]:.4f} ms (device)")
            print(f"bucket {v} group {gname}: summed device ms, entry's forms "
                  f"{total['auto']:.4f}, fastest forms {total['best']:.4f}")


if __name__ == "__main__":
    main()
