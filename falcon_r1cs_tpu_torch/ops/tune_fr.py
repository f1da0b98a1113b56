"""Variants of the witness map's redesigned Fr kernels, the transform
tile, the sparse product, the entry, the exit and the power tables, built
side by side from `csrc/fr_mont.cu` and timed in turns on one CUDA card.

    python -m falcon_r1cs_tpu_torch.ops.tune_fr [--out DIR] [--variants a,b]
        [--families tile,spmv,exit,entry,powers] [--form NAME=FILE ...]

Each variant is the committed source with one change, timed on the cases
of its family:

- `committed` (every family): the tile 4 elements a thread (256 threads a
  tile of 2^10), `__launch_bounds__(256, 3)`; the sparse product 256
  threads a CTA; the entry 1 row a thread, 128 threads a CTA, the word
  skip on in warps whose rows stay below word 7, rows read as two 16-byte
  loads a thread; the exit a tile of 2^2s elements with s = 4, 1 element
  a thread (256 threads); the power tables a tile of 2^(s + t) values, s
  <= 6, t <= 5, at least 2^8 tiles (`fr.powers_tile`), stage mode's
  strides written from its staged even values level by level;
- NAME (every family, with --form NAME=FILE): the file given, e.g. the
  parent commit's `csrc/fr_mont.cu` (`git show <commit>:falcon_r1cs_tpu_torch/
  csrc/fr_mont.cu > build/parent_fr_mont.cu`, then `--form
  parent=build/parent_fr_mont.cu`), whose C entry points must be the
  committed ones;
- tile: `tile_4_ctas`, the tile under `__launch_bounds__(256, 4)` (64
  registers, 32 warps an SM); `tile_8_a_thread`, 8 elements a thread (128
  threads a tile, phases of 3 stages, the 3-bit slot swizzle),
  `__launch_bounds__(128, 4)`: the tile's first redesigned form;
- spmv: `spmv_128`, `spmv_64`, the sparse product's CTA (a long row's
  threads) of 128 or 64 threads;
- exit: `exit_per_2`, `exit_per_4` (elements a thread at s = 4: 128, 64
  threads), `exit_s5`, `exit_s5_per_2`, `exit_s5_per_4` (s = 5: 1024, 512,
  256 threads; the last the form this redesign measured first);
- entry: `entry_per_2`, `entry_per_4` (rows a thread), `entry_256_threads`,
  `entry_no_skip` (every a b_i round in every warp: the parent's product),
  `entry_row_shuffle` (a warp reads its 32 rows as two contiguous 512-byte
  spans and shuffles the words);
- powers: `pow_s5` (s <= 5: the table L of 32 values), `pow_t3`, `pow_t4`
  (t <= 3, 4: tiles of at most 2^9, 2^10 values),
  `pow_min_cta_7`, `pow_min_cta_9` (t shrinks until 2^7, 2^9 tiles),
  `pow_512_threads`, `pow_copy_loop` (stage mode's strides written by
  each element's thread, a divergent loop over z, not from the staged
  values level by level).

On one card, for each variant in order, then reversed, each case of its
families: the round trip over three random vectors (DIF over w^-1, the
scale, DIT over w) and h's DIF tile with its scale at 2^17 and 2^18; A's
sparse product of the Falcon-512 (2^17) and Falcon-1024 (2^18)
verify-with-NTT circuits on random z; the exit of random canonical planes
at 2^17 and 2^18; the entry of cell B's z (Falcon-512, instance seed 5)
and the Falcon-1024 map's z, and of the Falcon-1024 circuit's A values
(full-width rows); the stage twiddles of w and the bit-reversed scales of
5, each with a random c, at 2^17, 2^18 and 2^21.  Each is held word for word to the plain version, then
timed: its median CUDA-event ms a call (20 samples of 5 calls) and its
profiler device ms a launch (the kernel's rows of a window of 20 calls
over the launches the window caught).  The static SASS counts (IMAD, all
but NOP) of the chosen families' entry, exit and power kernels of each
variant are printed beside ptxas.  Needs nvcc and a card; builds under DIR (default build/tune_fr in
the checkout).
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


FAMILIES = ("tile", "spmv", "exit", "entry", "powers")
_EXIT_S = "constexpr int kExitSideLog = 4;"
_EXIT_PER = "constexpr int kExitPer = 1;"
_ENTRY_PER = "constexpr int kEntryPer = 1;"
_ENTRY_VOTE = "__any_sync(0xffffffffu, x[j].w[kW - 1] != 0)"
# the entry's row loads, committed and as entry_row_shuffle reads them: a
# warp's 32 rows as two contiguous 512-byte spans (lane L chunks L and 32 +
# L), each lane's row words handed to it by shuffles
_ENTRY_LOADS = """  Fr x[kEntryPer];
#pragma unroll
  for (int j = 0; j < kEntryPer; ++j) {
    const size_t i = base + j * kEntryThreads + q;
    const bool in = i < static_cast<size_t>(n);
    const ulonglong2 zero = make_ulonglong2(0, 0);
    x[j] = row_words(in ? rows[2 * i] : zero, in ? rows[2 * i + 1] : zero);
  }
"""
_ENTRY_SHUFFLED_LOADS = """  Fr x[kEntryPer];
  const int lane = q & 31;
  ulonglong2 c[kEntryPer][2];
#pragma unroll
  for (int j = 0; j < kEntryPer; ++j) {
    const size_t first = 2 * (base + j * kEntryThreads + (q - lane));  // the warp's chunk 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t chunk = first + 32 * h + lane;
      c[j][h] = chunk < 2 * static_cast<size_t>(n) ? rows[chunk] : make_ulonglong2(0, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < kEntryPer; ++j) {
    // row `lane` is chunks 2 lane, 2 lane + 1 of span lane / 16
    ulonglong2 half[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = (2 * lane + h) & 31;
      const uint64_t x0 = __shfl_sync(0xffffffffu, c[j][0].x, src);
      const uint64_t y0 = __shfl_sync(0xffffffffu, c[j][0].y, src);
      const uint64_t x1 = __shfl_sync(0xffffffffu, c[j][1].x, src);
      const uint64_t y1 = __shfl_sync(0xffffffffu, c[j][1].y, src);
      half[h] = lane < 16 ? make_ulonglong2(x0, y0) : make_ulonglong2(x1, y1);
    }
    x[j] = row_words(half[0], half[1]);
  }
"""


# fr_powers_kernel's stage-mode strides: what follows the direct store, up
# to the end of the staged pass, and the per-element loop over z before it
_POW_DIRECT = "    store(out, n, (n >> 1) + x0 + e, v);\n"
_POW_LAST = "    if (!x0) store(out, n, 0, v);\n  }\n"
_POW_COPY_LOOP = """    const unsigned x = x0 + e;
    const int zmax = x ? min(__ffs(x) - 1, log_n - 1) : log_n - 1;
    for (int z = 1; z <= zmax; ++z) store(out, n, (n >> (z + 1)) + (x >> z), v);
    if (!x) store(out, n, 0, v);
  }
"""


def variants(src: str, forms: dict | None = None) -> dict:
    """name -> (source text, the case families it is timed on); each
    transform must change the source."""
    tile_bounds = "__launch_bounds__(kTileThreads, 3)"

    def exit_form(side, per):
        return src.replace(_EXIT_S, f"constexpr int kExitSideLog = {side};").replace(
            _EXIT_PER, f"constexpr int kExitPer = {per};")

    def entry_per(per):
        return src.replace(_ENTRY_PER, f"constexpr int kEntryPer = {per};")

    def pow_form(name, committed, value):
        return src.replace(f"constexpr int kPow{name} = {committed};",
                           f"constexpr int kPow{name} = {value};")

    copies = src.index(_POW_DIRECT) + len(_POW_DIRECT)
    copies_end = src.index(_POW_LAST, copies) + len(_POW_LAST)

    out = {
        "committed": (src, FAMILIES),
        "tile_4_ctas": (src.replace(tile_bounds, "__launch_bounds__(kTileThreads, 4)"),
                        ("tile",)),
        "tile_8_a_thread": (src.replace("constexpr int kPerLog = 2;",
                                        "constexpr int kPerLog = 3;")
                            .replace(_SWZ4, _SWZ8)
                            .replace(tile_bounds, "__launch_bounds__(kTileThreads, 4)"),
                            ("tile",)),
        "spmv_128": (src.replace("constexpr int kSpmvThreads = 256;",
                                 "constexpr int kSpmvThreads = 128;"), ("spmv",)),
        "spmv_64": (src.replace("constexpr int kSpmvThreads = 256;",
                                "constexpr int kSpmvThreads = 64;"), ("spmv",)),
        "exit_per_2": (exit_form(4, 2), ("exit",)),
        "exit_per_4": (exit_form(4, 4), ("exit",)),
        "exit_s5": (exit_form(5, 1), ("exit",)),
        "exit_s5_per_2": (exit_form(5, 2), ("exit",)),
        "exit_s5_per_4": (exit_form(5, 4), ("exit",)),
        "entry_per_2": (entry_per(2), ("entry",)),
        "entry_per_4": (entry_per(4), ("entry",)),
        "entry_256_threads": (src.replace("constexpr int kEntryThreads = 128;",
                                          "constexpr int kEntryThreads = 256;"), ("entry",)),
        "entry_no_skip": (src.replace(_ENTRY_VOTE, "true"), ("entry",)),
        "entry_row_shuffle": (src.replace(_ENTRY_LOADS, _ENTRY_SHUFFLED_LOADS), ("entry",)),
        "pow_s5": (pow_form("LowLog", 6, 5), ("powers",)),
        "pow_t3": (pow_form("HighLog", 5, 3), ("powers",)),
        "pow_t4": (pow_form("HighLog", 5, 4), ("powers",)),
        "pow_min_cta_7": (pow_form("MinCtaLog", 8, 7), ("powers",)),
        "pow_min_cta_9": (pow_form("MinCtaLog", 8, 9), ("powers",)),
        "pow_512_threads": (pow_form("Threads", 256, 512), ("powers",)),
        "pow_copy_loop": (src[:copies] + _POW_COPY_LOOP + src[copies_end:], ("powers",)),
    }
    for name, text in (forms or {}).items():
        out[name] = (text, FAMILIES)
    assert len({text for text, _ in out.values()}) == len(out), "a transform no longer applies"
    return out


def device_ms(fn, kernel: str, calls: int = 20, tries: int = 5) -> float:
    """Profiler device ms a launch: the rows of kernels whose names hold
    `kernel`, over the launches of them the window caught; a window that
    caught none (the profiler drops records, PERF.md section 7) is taken
    again, up to `tries` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        caught = sum(e.count for e in rows)
        if caught:
            return sum(e.self_device_time_total for e in rows) / 1e3 / caught
    raise RuntimeError(f"the profiler caught no launch of {kernel} in {tries} windows")


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


def exit_case(log_n: int, dev):
    """kind -> (launch(lib), check(lib), kernel) of the exit of random
    canonical planes at 2^log_n."""
    n = 1 << log_n
    x = fr.to_mont(torch.from_numpy(np.random.default_rng(log_n).integers(
        0, 2**63, size=(n, 4), dtype=np.int64)).to(dev))
    want = fr.from_mont(x)
    rows = torch.empty_like(want)

    def launch(lib):
        rc = lib.fr_from_mont_launch(x.data_ptr(), rows.data_ptr(), n, log_n,
                                     torch.cuda.current_stream().cuda_stream)
        _build.check_launch(rc, "fr_from_mont_launch")

    def check(lib):
        rows.zero_()
        launch(lib)
        torch.cuda.synchronize()
        assert torch.equal(rows, want)

    return {f"exit{log_n}": (launch, check, "fr_from_mont_kernel")}


def entry_case(params, dev):
    """kind -> (launch(lib), check(lib), kernel) of the entry of the
    verify-with-NTT circuit's z at `params` (instance seed 5: cell B's at
    Falcon-512) and, at Falcon-1024, of its A values."""
    from ..falcon import make_instance
    from ..r1cs.coo import compile_circuit
    from ..snark.native_backend import _compiled_cache, z_rows
    from ..tools.profile_prove import CIRCUIT, trace_assignment

    inst = make_instance(np.random.default_rng(5), params)
    _, z = trace_assignment(inst)
    host = _compiled_cache(compile_circuit(CIRCUIT, inst, cache=False))
    k = host["dom"].log_size
    inputs = {f"entry_z{k}": z_rows(z)}
    if params.n == FALCON_1024.n:
        inputs[f"entry_a{k}"] = host["a"][2]
    cases = {}
    for kind, host in inputs.items():
        rows = torch.from_numpy(np.ascontiguousarray(host).view(np.int64)).to(dev)
        want = fr.to_mont(rows)
        out = torch.empty_like(want)

        def launch(lib, rows=rows, out=out):
            rc = lib.fr_to_mont_launch(rows.data_ptr(), out.data_ptr(), rows.shape[0],
                                       torch.cuda.current_stream().cuda_stream)
            _build.check_launch(rc, "fr_to_mont_launch")

        def check(lib, launch=launch, out=out, want=want):
            out.zero_()
            launch(lib)
            torch.cuda.synchronize()
            assert torch.equal(out, want)

        cases[kind] = (launch, check, "fr_to_mont_kernel")
    return cases


def powers_case(log_n: int, dev):
    """kind -> (launch(lib), check(lib), kernel) of the stage twiddles of w
    (order 2^log_n) and the bit-reversed scales of 5, each with a random c."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    cases = {}
    for kind, base, mode in ((f"stage{log_n}", pow(5, (fr.R - 1) >> log_n, fr.R),
                              fr.MODE_STAGE), (f"bitrev{log_n}", 5, fr.MODE_BITREV)):
        sq = fr.squares_of(base, dev)
        c = fr.planes_of([int.from_bytes(rng.bytes(32), "little") % fr.R], dev)
        want = fr.powers(sq, c, log_n, mode)
        out = torch.empty_like(want)

        def launch(lib, sq=sq, c=c, out=out, mode=mode):
            rc = lib.fr_powers_launch(out.data_ptr(), sq.data_ptr(), c.data_ptr(), n, log_n,
                                      mode, torch.cuda.current_stream().cuda_stream)
            _build.check_launch(rc, "fr_powers_launch")

        def check(lib, launch=launch, out=out, want=want):
            out.zero_()
            launch(lib)
            torch.cuda.synchronize()
            assert torch.equal(out, want)

        cases[kind] = (launch, check, "fr_powers_kernel")
    return cases


_SASS_KERNELS = {"exit": "fr_from_mont_kernel", "entry": "fr_to_mont_kernel",
                 "powers": "fr_powers_kernel"}


def print_sass(so: Path, name: str, families) -> None:
    """The static SASS counts (IMAD, all but NOP) of the entry, the exit
    and the power kernel, those of `families`."""
    wanted = [_SASS_KERNELS[f] for f in families if f in _SASS_KERNELS]
    for kernel, ops in _build.sass_counts(so).items():
        if any(w in kernel for w in wanted):
            print(f"{name}: SASS {kernel}: IMAD {ops['IMAD']}, issued "
                  f"{sum(v for k, v in ops.items() if k != 'NOP')}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build._BUILD_DIR.parent / "tune_fr"))
    ap.add_argument("--variants", default=None, help="comma-separated names (default: all)")
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--form", action="append", default=[],
                    help="NAME=FILE: another fr_mont.cu, e.g. the parent's, timed as NAME")
    args = ap.parse_args()
    root = Path(args.out)
    if root.exists():
        shutil.rmtree(root)
    families = args.families.split(",")
    src = (_build._CSRC / "fr_mont.cu").read_text()
    extra = {name: Path(file).read_text()
             for name, file in (form.split("=", 1) for form in args.form)}
    forms = {name: (text, [f for f in fams if f in families])
             for name, (text, fams) in variants(src, extra).items()
             if (args.variants is None or name in args.variants.split(","))
             and set(fams) & set(families)}
    libs = build_variants(root, "fr_mont.cu", {name: text for name, (text, _) in forms.items()},
                          ("fr_ntt_tile_launch", "fr_spmv_launch", "fr_to_mont_launch",
                           "fr_from_mont_launch", "fr_powers_launch"))
    for name in libs:
        print_sass(root / name / "lib.so", name, families)
    print(card_name())
    dev = torch.device("cuda")
    makers = {"tile": lambda: {**tile_case(17, dev), **tile_case(18, dev)},
              "spmv": lambda: {**spmv_case(FALCON_512, dev), **spmv_case(FALCON_1024, dev)},
              "exit": lambda: {**exit_case(17, dev), **exit_case(18, dev)},
              "entry": lambda: {**entry_case(FALCON_512, dev), **entry_case(FALCON_1024, dev)},
              "powers": lambda: {**powers_case(17, dev), **powers_case(18, dev),
                                 **powers_case(21, dev)}}
    cases = {kind: (*case, family) for family in families
             for kind, case in makers[family]().items()}
    res = {}
    for name in list(libs) + list(libs)[::-1]:
        for kind, (launch, check, kernel, family) in cases.items():
            if family not in forms[name][1]:
                continue
            check(libs[name])
            run = lambda lib=libs[name], launch=launch: launch(lib)  # noqa: E731
            res.setdefault((kind, name), []).append((_cuda_ms(run), device_ms(run, kernel)))
    for (kind, name), vals in sorted(res.items()):
        print(f"{kind:9s} {name:18s} equal word for word; "
              + "; ".join(f"events {e:.4f} ms, device {d:.4f} ms" for e, d in vals))


if __name__ == "__main__":
    main()
