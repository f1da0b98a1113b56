"""The (batch, coeff) device mesh and the sharded witness engines, on
torch.distributed.

The counterpart of `falcon_r1cs_tpu/parallel/mesh.py`.  Where the JAX
package wraps each engine in shard_map over a jax Mesh, the port runs one
process per rank (SPMD): the caller cuts its rank's block of a host batch
with `place_batch`, runs the engine on it, and gets the rank's block of
every segment; `gather_segments` assembles the global segment dict on
every rank where a check needs it.

  DP  ("batch" dim): signatures sharded across ranks; no exchange at all.
  SP  ("coeff" dim): the coefficient axis sharded across ranks.  The two
      hint NTTs exchange whole limb blocks with a partner rank in their
      first log2(D) stages (`ntt_sharded.ntt_with_hints_local`), the
      int32 product w = hm - sig_ntt * pk is all-gathered once for the
      inverse NTT, and the norm's partial sums are all-reduced.
  TP, PP, EP: as in the JAX package's docstring; `pipeline_pp.py` holds
      the PP demonstrator.

Outputs are bit-equal to the single-device engines in every mode.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..falcon.ntt import intt_torch
from ..ops.modq import divmod_q as fast_divmod_q
from ..ops.modq import mul_mod_q, sub_mod_q
from ..params import get_params
from ..pipeline import _batch_axis
from ..utils.device import entry_device, rank_device
from ..witness.engine import (
    _bits,
    _bound_block_512,
    _bound_block_1024,
    _lt_q_chain,
    _norm_block_t,
    witness_engine,
)
from ..witness.engine_dual import witness_engine_dual
from ..witness.engine_schoolbook import witness_engine_schoolbook
from .distributed import maybe_init_distributed
from .ntt_sharded import ntt_with_hints_local

# the dual engine's feature-first segments, batch on axis 1
# (falcon_r1cs_tpu/parallel/mesh.py _DUAL_LIMB_KEYS); pipeline._batch_axis
# gives them axis 1
_DUAL_LIMB_KEYS = frozenset({"sp_t", "sn_t", "vp_t", "vn_t", "pointwise_vals"})

# the coefficient-sharded engine's norm halves: the global norm segments
# are [v-block | sig-block] along axis 2, each half sharded over coeff
_NORM_HALVES = {"norm_bits": ("norm_bits_v", "norm_bits_sig"),
                "norm_vals": ("norm_vals_v", "norm_vals_sig")}


def make_mesh(n_devices: int | None = None, batch_axis: int | None = None,
              device="cuda") -> DeviceMesh:
    """A (batch, coeff) DeviceMesh over ranks 0 .. n_devices - 1 of the
    world (default: all), initialising the process group if needed.

    batch_axis: ranks on the data-parallel dim (default: all of them,
    coeff 1); the coeff dim shards the polynomial coefficients.  Every
    rank of the world must call it (the sub-groups are made collectively);
    a rank outside the mesh gets a mesh whose get_coordinate() is None."""
    dev = entry_device(device)
    maybe_init_distributed(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"{n} ranks asked for; the world has {world}")
    if batch_axis is None:
        batch_axis = n
    if n % batch_axis:
        raise ValueError(f"{n} devices not divisible by batch axis {batch_axis}")
    ranks = torch.arange(n).reshape(batch_axis, n // batch_axis)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("batch", "coeff"))


def place_batch(mesh: DeviceMesh, sig, pk_ntt, hm_ntt):
    """This rank's (batch, coeff) block of each (B, n) host batch (numpy
    or tensor), on its device.  B must divide by the batch dim and n by
    the coeff dim."""
    nb, nc = mesh.shape
    bi, ci = mesh.get_coordinate()
    dev = rank_device(mesh.device_type)

    def block(a):
        a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        B, n = a.shape
        if B % nb:
            raise ValueError(f"batch {B} not divisible by the batch dim {nb}")
        if n % nc:
            raise ValueError(f"n={n} not divisible by the coeff dim {nc}")
        rows, w = B // nb, n // nc
        return a[bi * rows:(bi + 1) * rows, ci * w:(ci + 1) * w].contiguous().to(dev)

    return block(sig), block(pk_ntt), block(hm_ntt)


def sharded_engine(n: int, mesh: DeviceMesh, fused_intt: bool = False):
    """The verify-with-NTT witness engine on this rank's block:
    (sig, pk_ntt, hm_ntt) local blocks -> the rank's segment dict.

      coeff dim 1: the whole single-device engine, witness_engine(n,
        fused_intt), on the rank's rows (on a card the hint kernel K1
        twice, or K2 and K1 with fused_intt);
      coeff dim > 1: the coefficient-sharded engine below, in plain torch
        (as in the JAX package, no kernel runs there).
    """
    if mesh.shape[1] == 1:
        return witness_engine(n, fused_intt)
    return _local_sp_engine(get_params(n), mesh)


def _local_sp_engine(params, mesh: DeviceMesh):
    """The coefficient-sharded engine body (falcon_r1cs_tpu/parallel/mesh.py
    _make_local_sp_engine): bit-equal to witness/engine.generate_witness_ntt
    once gathered.  The norm segment comes in its two halves (_NORM_HALVES),
    which gather_segments glues."""
    n = params.n
    group = mesh.get_group("coeff")
    D = mesh.shape[1]
    r = mesh.get_local_rank("coeff")
    w = n // D
    bound_block = _bound_block_512 if n == 512 else _bound_block_1024

    def run(sig, pk_ntt, hm_ntt):
        sig = sig.to(torch.int32)
        pk_ntt = pk_ntt.to(torch.int32)
        hm_ntt = hm_ntt.to(torch.int32)

        sig_t, sig_b = ntt_with_hints_local(sig, group, params, D)

        # v = intt(hm - sig_ntt * pk): the int32 product is gathered once
        # (4n bytes a signature) and the inverse NTT runs locally; the
        # limb NTTs stay sharded
        prod_local = sub_mod_q(hm_ntt, mul_mod_q(sig_b, pk_ntt))
        v = intt_torch(_all_gather(prod_local, group, 1), n)[:, r * w:(r + 1) * w]
        v = v.contiguous()

        v_bits = _bits(v, 14)
        range_v = torch.cat([v_bits, _lt_q_chain(v_bits, v)], dim=-1)

        v_t, v_b = ntt_with_hints_local(v, group, params, D)

        sig_bits = _bits(sig_b, 14)
        v_bits_n = _bits(v_b, 14)
        sig_tail = torch.cat([sig_bits, _lt_q_chain(sig_bits, sig_b)], dim=-1)
        v_tail = torch.cat([v_bits_n, _lt_q_chain(v_bits_n, v_b)], dim=-1)

        prod = sig_b * pk_ntt
        t_pw, c_pw = fast_divmod_q(v_b + prod)
        pw_bits = _bits(c_pw, 14)
        pointwise = torch.stack([prod, t_pw, c_pw], dim=-1)
        pointwise_tail = torch.cat([pw_bits, _lt_q_chain(pw_bits, c_pw)], dim=-1)

        nbits_v, sel_v, sq_v = _norm_block_t(v)
        nbits_s, sel_s, sq_s = _norm_block_t(sig)
        sq = torch.cat([sq_v, sq_s], dim=-1)
        sums = torch.stack([torch.sum(sq & 0xFFFF, dim=-1, dtype=torch.int32),
                            torch.sum(sq >> 16, dim=-1, dtype=torch.int32)])
        dist.all_reduce(sums, group=group)
        sum_lo, sum_hi = sums[0], sums[1]
        norm_lo = sum_lo & 0xFFFF
        norm_hi = sum_hi + (sum_lo >> 16)

        return {
            "sig": sig, "v": v, "range_v": range_v,
            "sig_ntt_t": sig_t, "sig_ntt_b": sig_b, "sig_ntt_tail": sig_tail,
            "v_ntt_t": v_t, "v_ntt_b": v_b, "v_ntt_tail": v_tail,
            "pointwise": pointwise, "pointwise_tail": pointwise_tail,
            "norm_bits_v": nbits_v, "norm_bits_sig": nbits_s,
            "norm_vals_v": torch.stack([sel_v, sq_v], dim=0),
            "norm_vals_sig": torch.stack([sel_s, sq_s], dim=0),
            "bound": bound_block(norm_lo, norm_hi),
            "pk_ntt": pk_ntt, "hm_ntt": hm_ntt,
        }

    return run


def _whole_rows(engine, mesh: DeviceMesh):
    """`engine` (a single-device engine over whole (rows, n) polynomials)
    on this rank's (batch, coeff) blocks: on a coeff dim > 1 the blocks of
    the rank's coeff group are gathered into the whole rows first, so that
    every rank of the group runs the whole engine and holds an equal copy
    of its batch row's segments (the JAX package's shard_map with
    in_specs P("batch", None), replicated over "coeff")."""
    if mesh.shape[1] == 1:
        return engine
    group = mesh.get_group("coeff")

    def run(*blocks):
        return engine(*(_all_gather(b, group, 1) for b in blocks))

    return run


def sharded_engine_dual(n: int, mesh: DeviceMesh):
    """The batch-sharded dual-NTT engine: each rank runs the whole
    single-device engine on its batch row's whole polynomials (on a card
    K1 four times), replicated over the coeff dim."""
    return _whole_rows(witness_engine_dual(n), mesh)


def sharded_engine_schoolbook(n: int, mesh: DeviceMesh):
    """The batch-sharded schoolbook engine: each rank runs the whole
    single-device engine on its batch row's whole polynomials (on a card
    K3 once), replicated over the coeff dim."""
    return _whole_rows(witness_engine_schoolbook(n), mesh)


# one gather into one output tensor (its name from torch 2.13; before,
# all_gather_into_tensor)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather(t, group, axis: int):
    """The blocks of `t` of every rank of `group`, concatenated on `axis`
    in group-rank order (a mesh dim's group rank is the coordinate): one
    collective into one buffer, the blocks stacked on a new leading dim,
    then moved to `axis` (a copy unless axis is 0 or the group has one
    rank)."""
    t = t.contiguous()
    D = dist.get_world_size(group)
    out = torch.empty((D * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _all_gather_single(out, t, group=group)
    shape = t.shape[:axis] + (D * t.shape[axis],) + t.shape[axis + 1:]
    return out.view((D,) + tuple(t.shape)).movedim(0, axis).reshape(shape)


def gather_segments(mesh: DeviceMesh, seg: dict) -> dict:
    """The global segment dict, on every rank, from each rank's block of
    any engine above.  The coefficient-sharded engine's segments (known by
    its norm halves) are gathered over the coeff dim (on the axis after
    their batch axis; `bound` is whole on every coeff rank), its norm
    halves each on its own and glued [v-block | sig-block]; every other
    engine's segments are whole on every coeff rank already.  Then every
    segment is gathered over the batch dim (its batch axis,
    pipeline._batch_axis)."""
    batch_group = mesh.get_group("batch")
    sp = mesh.shape[1] > 1 and any(v_half in seg for v_half, _ in _NORM_HALVES.values())
    coeff_group = mesh.get_group("coeff") if sp else None

    def gather(name, t):
        axis = _batch_axis(name)
        if coeff_group is not None and name != "bound":
            t = _all_gather(t, coeff_group, axis + 1)
        return _all_gather(t, batch_group, axis)

    out = {}
    for key, t in seg.items():
        if not any(key in halves for halves in _NORM_HALVES.values()):
            out[key] = gather(key, t)
    for key, (v_half, sig_half) in _NORM_HALVES.items():
        if v_half in seg:
            out[key] = torch.cat(
                [gather(key, seg[v_half]), gather(key, seg[sig_half])], dim=2)
    return out
