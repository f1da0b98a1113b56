"""Variants of the witness map's two redesigned Fr kernels, the transform
tile and the sparse product, built side by side from `csrc/fr_mont.cu`
and timed in turns on one CUDA card.

    python -m falcon_r1cs_tpu_torch.ops.tune_fr [--out DIR]

Each variant is the committed source with one change:

- `committed`: the tile 4 elements a thread (256 threads a tile of 2^10),
  `__launch_bounds__(256, 3)`; the sparse product 256 threads a CTA;
- `tile_4_ctas`: the tile under `__launch_bounds__(256, 4)` (64
  registers, 32 warps an SM);
- `tile_8_a_thread`: 8 elements a thread (128 threads a tile, phases of
  3 stages, the 3-bit slot swizzle), `__launch_bounds__(128, 4)`: the
  form this redesign measured first;
- `spmv_128`, `spmv_64`: the sparse product's CTA (a long row's threads)
  of 128 or 64 threads.

On one card, for each variant in order, then reversed: the round trip
over three random vectors (DIF over w^-1, the scale, DIT over w) and h's
DIF tile with its scale at 2^17 and 2^18, and A's sparse product of the
Falcon-512 (2^17) and Falcon-1024 (2^18) verify-with-NTT circuits on
random z, each held word for word to the plain version, then its median
CUDA-event ms a call (20 samples of 5 calls) and its profiler device ms
a launch (the kernel's rows of a window of 20 calls over the launches
the window caught).  Needs nvcc and a card; builds under DIR (default
build/tune_fr in the checkout).
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np
import torch

from ..params import FALCON_512, FALCON_1024
from . import _build, fr
from .tune_ntt_hints import _cuda_ms, build_variants, card_name

_SWZ4 = "return e ^ (((e >> 5) & 1) * 0x0a) ^ (((e >> 6) & 1) * 0x15);"
_SWZ8 = ("return e ^ (((e >> 5) & 1) * 0x04) ^ (((e >> 6) & 1) * 0x09) ^ "
         "(((e >> 7) & 1) * 0x12);")


def variants(src: str) -> dict:
    """name -> source text; each transform must change the source."""
    tile_bounds = "__launch_bounds__(kTileThreads, 3)"
    out = {
        "committed": src,
        "tile_4_ctas": src.replace(tile_bounds, "__launch_bounds__(kTileThreads, 4)"),
        "tile_8_a_thread": src.replace("constexpr int kPerLog = 2;", "constexpr int kPerLog = 3;")
        .replace(_SWZ4, _SWZ8).replace(tile_bounds, "__launch_bounds__(kTileThreads, 4)"),
        "spmv_128": src.replace("constexpr int kSpmvThreads = 256;",
                                "constexpr int kSpmvThreads = 128;"),
        "spmv_64": src.replace("constexpr int kSpmvThreads = 256;",
                               "constexpr int kSpmvThreads = 64;"),
    }
    assert len(set(out.values())) == len(out), "a transform no longer applies"
    return out


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Profiler device ms a launch: the rows of kernels whose names hold
    `kernel`, over the launches of them the window caught."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    caught = sum(e.count for e in rows)
    if not caught:
        raise RuntimeError(f"the profiler caught no launch of {kernel}")
    return sum(e.self_device_time_total for e in rows) / 1e3 / caught


def tile_case(log_n: int, dev):
    """kind -> (launch(lib), check(lib), kernel) of the round trip over
    three random vectors and of h's DIF tile with its scale, at 2^log_n."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    rows = torch.from_numpy(rng.integers(0, 2**63, size=(3 * n + n, 4), dtype=np.int64))
    planes = fr.to_mont(rows.to(dev))
    x0 = planes[:, :3 * n].reshape(fr.WORDS, 3, n).permute(1, 0, 2).contiguous()
    scale = planes[:, 3 * n:].contiguous()
    one = fr.planes_of([1], dev)
    omega = pow(5, (fr.R - 1) >> log_n, fr.R)
    tw = fr.powers(fr.squares_of(omega, dev), one, log_n, fr.MODE_STAGE)
    tw_inv = fr.powers(fr.squares_of(pow(omega, -1, fr.R), dev), one, log_n, fr.MODE_STAGE)
    x = x0.clone()
    cases = {}
    for kind, nvec, tw_dit in ((f"trip{log_n}", 3, tw), (f"dif{log_n}", 1, None)):
        src = x0[:nvec]
        want = fr.ntt_tile(src.clone(), tw_inv, True, scale, tw_dit)

        def launch(lib, nvec=nvec, tw_dit=tw_dit):
            rc = lib.fr_ntt_tile_launch(x.data_ptr(), tw_inv.data_ptr(), scale.data_ptr(),
                                        0 if tw_dit is None else tw_dit.data_ptr(), n,
                                        fr.TILE_LOG, 1, nvec,
                                        torch.cuda.current_stream().cuda_stream)
            _build.check_launch(rc, "fr_ntt_tile_launch")

        def check(lib, nvec=nvec, launch=launch, want=want, src=src):
            x[:nvec].copy_(src)
            launch(lib)
            torch.cuda.synchronize()
            assert torch.equal(x[:nvec], want)

        cases[kind] = (launch, check, "fr_ntt_tile_kernel")
    return cases


def spmv_case(params, dev):
    """kind -> (launch(lib), check(lib), kernel) of A's sparse product of
    the verify-with-NTT circuit at `params` on random z."""
    from ..falcon import make_instance
    from ..r1cs.coo import compile_circuit
    from ..snark import gpu_qap
    from ..snark.native_backend import _compiled_cache
    from ..tools.profile_prove import CIRCUIT

    compiled = compile_circuit(CIRCUIT, make_instance(np.random.default_rng(5), params),
                               cache=False)
    host = _compiled_cache(compiled)
    n = host["dom"].size
    (row_ptr, cols, vals), (order, n_long) = gpu_qap._csr(*host["a"], compiled.num_constraints,
                                                          n, dev)
    nz = compiled.num_variables
    z = fr.to_mont(torch.from_numpy(np.random.default_rng(params.n).integers(
        0, 2**63, size=(nz, 4), dtype=np.int64)).to(dev))
    ni = compiled.num_instance
    out = torch.empty((fr.WORDS, n), dtype=torch.int32, device=dev)
    want = fr.spmv(row_ptr, cols, vals, z, n, ni)

    def launch(lib):
        rc = lib.fr_spmv_launch(row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                                cols.shape[0], z.data_ptr(), nz, out.data_ptr(), n,
                                compiled.num_constraints, ni, order.data_ptr(), n_long,
                                torch.cuda.current_stream().cuda_stream)
        _build.check_launch(rc, "fr_spmv_launch")

    def check(lib):
        out.zero_()
        launch(lib)
        torch.cuda.synchronize()
        assert torch.equal(out, want)

    return {f"spmvA{n.bit_length() - 1}": (launch, check, "fr_spmv_kernel")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build._BUILD_DIR.parent / "tune_fr"))
    root = Path(ap.parse_args().out)
    if root.exists():
        shutil.rmtree(root)
    src = (_build._CSRC / "fr_mont.cu").read_text()
    libs = build_variants(root, "fr_mont.cu", variants(src),
                          ("fr_ntt_tile_launch", "fr_spmv_launch"))
    print(card_name())
    dev = torch.device("cuda")
    cases = {**tile_case(17, dev), **tile_case(18, dev), **spmv_case(FALCON_512, dev),
             **spmv_case(FALCON_1024, dev)}
    res = {}
    for name in list(libs) + list(libs)[::-1]:
        for kind, (launch, check, kernel) in cases.items():
            check(libs[name])
            run = lambda lib=libs[name], launch=launch: launch(lib)  # noqa: E731
            res.setdefault((kind, name), []).append((_cuda_ms(run), device_ms(run, kernel)))
    for (kind, name), vals in sorted(res.items()):
        print(f"{kind:8s} {name:16s} equal word for word; "
              + "; ".join(f"events {e:.4f} ms, device {d:.4f} ms" for e, d in vals))


if __name__ == "__main__":
    main()
