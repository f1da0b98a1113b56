"""The Groth16 witness map on a CUDA card: the coefficients of h(X) = (a(X)
b(X) - c(X)) / Z(X) from a wire vector, on the Fr kernels of
`csrc/fr_mont.cu` (`ops/fr.py`).

The device counterpart of `native_backend.witness_map` (the host C that
the `native` backend runs, the JAX package's only form), equal to it limb
for limb.  Per call, all in Montgomery word planes on the device:

- z, the host's (N, 4) u64 rows, uploaded and converted once
  (`to_mont_cuda`);
- a, b, c over the domain of n = 2^k points, into one (3, 8, n) buffer:
  the sparse products of the CSR matrices A, B, C with z (`spmv_cuda`),
  rows nc .. nc + ni - 1 of a taking z[:ni] (the instance augmentation of
  `qap.evaluate_on_domain`);
- each: an inverse transform (DIF over w^-1, natural order in,
  bit-reversed out), the product by n^-1 g^i, g = 5, with i the
  coefficient's index, then a forward transform (DIT over w, bit-reversed
  in, natural out): the evaluations on the coset g w^i (`coset_ntt`: the
  wide stages a launch each, the tile stages and the scale of all three
  vectors in one launch);
- (a b - c) Z^-1 on the coset, into a (`quotient_cuda`; Z = g^n - 1
  there);
- an inverse transform scaled by n^-1 g^-i, and the exit to canonical
  u64 rows, element p written at row bitrev(p) (`from_mont_cuda`).

Cached on the compiled circuit, per device (`_gpu_qap_cache`, as
`gpu_msm._points_mont` caches the CRS points): the CSR arrays of A, B and
C (values converted by `to_mont_cuda`, one launch a matrix) and the bins
of their rows by length (`fr.spmv_order`, key "a_bins" beside "a"), the
stage twiddles of w and w^-1 and the two scale tables (`powers_cuda`, one
launch each: a CTA builds two small tables of powers and takes one
product an element), and Z^-1.  A warm call launches 8 + 7 (k - 10) kernels at
k >= 10 (57 at k = 17, 64 at k = 18, 85 at k = 21): the entry, three
sparse products, the round-trip tile, the quotient, h's last tile, the
exit and 7 (k - 10) wide stages; it reads 32 bytes back: the top
coefficient.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fr
from .bls12_381 import R
from .gpu_msm import _device_key
from .native_backend import _compiled_cache, z_rows
from .points import limbs_to_int

COSET_G = 5


def _csr(rows, cols, vals, nc: int, n_out: int, device):
    """((row_ptr (nc + 1,) int32, cols int32, vals (8, nnz) Montgomery
    planes), bins (order (n_out,) int32, n_long): `fr.spmv_order`) on
    `device` of a COO matrix with u64 value rows."""
    by_row = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[by_row], cols[by_row], vals[by_row]
    row_ptr = np.zeros(nc + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=nc), out=row_ptr[1:])
    vals_dev = torch.from_numpy(np.ascontiguousarray(vals).view(np.int64)).to(device)
    planes = (fr.to_mont_cuda(vals_dev) if len(vals) else
              torch.empty((fr.WORDS, 0), dtype=torch.int32, device=device))
    order, n_long = fr.spmv_order(row_ptr, n_out)
    return ((torch.from_numpy(row_ptr).to(device),
             torch.from_numpy(np.ascontiguousarray(cols, dtype=np.int32)).to(device), planes),
            (torch.from_numpy(order).to(device), n_long))


def tables(dom, device) -> dict:
    """The domain's tables on `device`: stage twiddles of w and w^-1, the
    scales n^-1 g^bitrev(p) and n^-1 g^-bitrev(p), and Z^-1 on the coset."""
    k = dom.log_size
    one = fr.planes_of([1], device)
    ninv = fr.planes_of([pow(dom.size, -1, R)], device)
    ginv = pow(COSET_G, -1, R)
    return {
        "tw": fr.powers_cuda(fr.squares_of(dom.omega, device), one, k, fr.MODE_STAGE),
        "tw_inv": fr.powers_cuda(fr.squares_of(dom.omega_inv, device), one, k, fr.MODE_STAGE),
        "scale": fr.powers_cuda(fr.squares_of(COSET_G, device), ninv, k, fr.MODE_BITREV),
        "scale_inv": fr.powers_cuda(fr.squares_of(ginv, device), ninv, k, fr.MODE_BITREV),
        "zinv": fr.planes_of([pow(dom.vanishing_on_coset(COSET_G), -1, R)], device),
    }


def _cache(compiled, device) -> dict:
    per = compiled.__dict__.setdefault("_gpu_qap_cache", {})
    key = _device_key(device)
    if key not in per:
        host = _compiled_cache(compiled)
        nc, n = compiled.num_constraints, host["dom"].size
        per[key] = {"dom": host["dom"], **tables(host["dom"], device)}
        for name in ("a", "b", "c"):
            per[key][name], per[key][f"{name}_bins"] = _csr(*host[name], nc, n, device)
    return per[key]


def witness_map_gpu(compiled, z, device):
    """h's coefficients as a (n - 1, 4) int64 tensor of canonical u64 limbs
    on `device`, and the top coefficient as an int (nonzero iff z does not
    satisfy the system).  z: (N, 4) u64 rows or the wire ints."""
    device = torch.device(device)
    cache = _cache(compiled, device)
    n = cache["dom"].size
    z_dev = fr.to_mont_cuda(torch.from_numpy(z_rows(z).view(np.int64)).to(device))
    evals = torch.empty((3, fr.WORDS, n), dtype=torch.int32, device=device)
    for x, name in zip(evals, ("a", "b", "c")):
        fr.spmv_cuda(*cache[name], z_dev, n, compiled.num_instance if name == "a" else 0,
                     bins=cache[f"{name}_bins"], out=x)
    fr.coset_ntt(evals, cache["tw_inv"], cache["tw"], cache["scale"])
    h = fr.quotient_cuda(*evals, cache["zinv"])
    fr.ntt(h, cache["tw_inv"], True, cache["scale_inv"])
    rows = fr.from_mont_cuda(h)
    top = limbs_to_int(rows[n - 1].cpu().numpy().view(np.uint64))
    return rows[: n - 1], top

