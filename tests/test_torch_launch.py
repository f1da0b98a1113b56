"""Every kernel wrapper of the port launches through the one helper
`ops._build.launch`, on the CPU, with a mock kernel library.

The mock replaces the bound C entry points (`_build._FN`) with recorders,
and torch's current device and raw stream with stubs; the inputs are
fake CUDA tensors (`FakeTensorMode`: metadata only, no card, data
pointers 0).  So each wrapper runs its CUDA branch up to the C call: its
checks, its output allocation, its launch through the helper and its
launch count.  No JAX is imported.
"""

import warnings

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from falcon_r1cs_tpu_torch import FALCON_512
from falcon_r1cs_tpu_torch.ops import _build, cuda_ntt, fq, fr, msm_bucket, msm_recode, ntt_v3
from falcon_r1cs_tpu_torch.ops.schoolbook import schoolbook_prods_cuda

STREAM = 0x5EED


@pytest.fixture()
def mock_library(monkeypatch):
    """(calls, set_rc, contexts): the recorded C calls, a setter of the
    mock's return code and the device contexts entered."""
    calls, contexts, rc = [], [], [0]

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return rc[0]

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            contexts.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "_FN", {n: Entry(n) for n in _build._ARGTYPES})
    monkeypatch.setattr(_build, "_get_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: STREAM + index)
    monkeypatch.setattr(_build.torch.cuda, "device", Device)
    for cache in (cuda_ntt._tables, cuda_ntt._semi_tables):
        cache.cache_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # data_ptr() of a fake tensor
        yield calls, lambda v: rc.__setitem__(0, v), contexts
    for cache in (cuda_ntt._tables, cuda_ntt._semi_tables):
        cache.cache_clear()


def _wrapper_calls(dev):
    """(wrapper, C entry, thunk) of every kernel wrapper on fake inputs."""
    n, m = FALCON_512.n, 8
    x = torch.zeros((2, n), dtype=torch.int32, device=dev)
    limbs = torch.zeros((35, m), dtype=torch.int32, device=dev)
    flags = torch.zeros(m, dtype=torch.bool, device=dev)
    jac = (limbs, limbs, limbs, flags)
    aff = (limbs, limbs, flags)
    scalars = torch.zeros((2, m, 4), dtype=torch.int64, device=dev)
    nodes = torch.zeros((35, 2, m), dtype=torch.int32, device=dev)
    node_flags = torch.zeros((2, m), dtype=torch.bool, device=dev)
    keys = torch.zeros((2, m), dtype=torch.int32, device=dev)
    level = (nodes, nodes, nodes, node_flags)
    leaves = (nodes, nodes, None, node_flags)
    half = torch.zeros((35, 2, m // 2), dtype=torch.int32, device=dev)
    bridge = (half, half, half, torch.zeros((2, m // 2), dtype=torch.bool, device=dev))
    bank = msm_bucket.bucket_bank(2, 3, dev)
    planes, rows, row_ptr, cols, vals, one, squares = _fr_inputs(dev)
    order = torch.zeros(16, dtype=torch.int32, device=dev)
    batch = torch.zeros((3, 8, 1 << 11), dtype=torch.int32, device=dev)
    out = torch.zeros((8, 16), dtype=torch.int32, device=dev)
    return [
        (_build.add_one, "add_one_launch", lambda: _build.add_one(x)),
        (cuda_ntt.ntt_with_hints_cuda, "ntt_hints_launch",
         lambda: cuda_ntt.ntt_with_hints_cuda(x, FALCON_512)),
        (cuda_ntt.intt_ntt_hints_cuda, "intt_ntt_hints_launch",
         lambda: cuda_ntt.intt_ntt_hints_cuda(x, FALCON_512)),
        (schoolbook_prods_cuda, "schoolbook_prods_launch",
         lambda: schoolbook_prods_cuda(x, x, n)),
        (ntt_v3.ntt_semi_cuda, "ntt_semi_launch", lambda: ntt_v3.ntt_semi_cuda(x, FALCON_512)),
        (ntt_v3.ntt_semi_cuda, "ntt_semi_hints_launch",
         lambda: ntt_v3.ntt_with_hints_v3(x, FALCON_512)),
        (fq.mont_mul_cuda, "mont_mul_launch", lambda: fq.mont_mul_cuda(limbs, limbs, 3)),
        (fq.point_add_cuda, "point_add_launch", lambda: fq.point_add_cuda(jac, jac)),
        (fq.point_add_aff_cuda, "point_add_aff_launch",
         lambda: fq.point_add_aff_cuda(aff, aff)),
        (msm_recode.signed_digits_cuda, "signed_digits_launch",
         lambda: msm_recode.signed_digits_cuda(scalars, flags, 12, 2 * m)),
        (msm_bucket.bucket_level_cuda, "bucket_level_launch",
         lambda: msm_bucket.bucket_level_cuda(bridge, level, level, keys, keys, bank, 3)),
        (msm_bucket.bucket_level_cuda, "bucket_level_launch",
         lambda: msm_bucket.bucket_level_cuda(bridge, leaves, leaves, keys, keys, bank, 3)),
        (fr.to_mont_cuda, "fr_to_mont_launch", lambda: fr.to_mont_cuda(rows)),
        (fr.from_mont_cuda, "fr_from_mont_launch", lambda: fr.from_mont_cuda(planes)),
        (fr.spmv_cuda, "fr_spmv_launch",
         lambda: fr.spmv_cuda(row_ptr, cols, vals, planes, 16, 2, bins=(order, 2))),
        (fr.spmv_cuda, "fr_spmv_launch",
         lambda: fr.spmv_cuda(row_ptr, cols, vals, planes, 16, 2, bins=(order, 0), out=out)),
        (fr.ntt_tile_cuda, "fr_ntt_tile_launch",
         lambda: fr.ntt_tile_cuda(planes, planes, True, planes)),
        (fr.ntt_tile_cuda, "fr_ntt_tile_launch",
         lambda: fr.ntt_tile_cuda(batch, planes, True, planes, planes)),
        (fr.ntt_tile_cuda, "fr_ntt_tile_launch", lambda: fr.ntt_tile_cuda(batch, planes, False)),
        (fr.ntt_stage_cuda, "fr_ntt_stage_launch",
         lambda: fr.ntt_stage_cuda(planes, planes, 10, False)),
        (fr.quotient_cuda, "fr_quotient_launch",
         lambda: fr.quotient_cuda(planes, planes, planes, one)),
        (fr.powers_cuda, "fr_powers_launch",
         lambda: fr.powers_cuda(squares, one, 11, fr.MODE_STAGE)),
    ]


def _fr_inputs(dev):
    """Inputs of the Fr wrappers at n = 2^11: planes (8, n), rows (n, 4),
    a CSR matrix of 8 rows and 16 entries, zinv and the squares table."""
    n = 1 << 11
    return (torch.zeros((8, n), dtype=torch.int32, device=dev),
            torch.zeros((n, 4), dtype=torch.int64, device=dev),
            torch.zeros(9, dtype=torch.int32, device=dev),
            torch.zeros(16, dtype=torch.int32, device=dev),
            torch.zeros((8, 16), dtype=torch.int32, device=dev),
            torch.zeros((8, 1), dtype=torch.int32, device=dev),
            torch.zeros((8, 32), dtype=torch.int32, device=dev))


def _z(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device=torch.device("cuda", 0))


def _strided(shape, stride):
    return torch.empty_strided(shape, stride, dtype=torch.int32, device=torch.device("cuda", 0))


def _bins(n_out=16, n_long=2, dtype=torch.int32):
    return _z(n_out, dtype=dtype), n_long


# wrong dtypes and shapes, each with the other arguments right (n = 2^11)
FR_BAD = {
    "to_mont dtype": lambda p, r, rp, c, v, o, sq: fr.to_mont_cuda(_z(2048, 4)),
    "to_mont shape": lambda p, r, rp, c, v, o, sq: fr.to_mont_cuda(_z(2048, 3, dtype=torch.int64)),
    "from_mont dtype": lambda p, r, rp, c, v, o, sq: fr.from_mont_cuda(_z(8, 2048,
                                                                          dtype=torch.int64)),
    "from_mont perm": lambda p, r, rp, c, v, o, sq: fr.from_mont_cuda(_z(8, 1000)),
    "spmv cols dtype": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, _z(16, dtype=torch.int64),
                                                                  v, p, 16, bins=_bins()),
    "spmv vals shape": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, c, _z(8, 15), p, 16,
                                                                  bins=_bins()),
    "spmv rows": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, c, v, p, 4, bins=_bins(4)),
    "spmv no bins": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, c, v, p, 16),
    "spmv order rows": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, c, v, p, 16,
                                                                  bins=_bins(15)),
    "spmv order dtype": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(
        rp, c, v, p, 16, bins=_bins(dtype=torch.int64)),
    "spmv long rows": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, c, v, p, 16,
                                                                 bins=_bins(n_long=9)),
    "spmv out shape": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(rp, c, v, p, 16, bins=_bins(),
                                                                 out=_z(8, 15)),
    "spmv out strided": lambda p, r, rp, c, v, o, sq: fr.spmv_cuda(
        rp, c, v, p, 16, bins=_bins(), out=_strided((8, 16), (1, 8))),
    "tile size": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(_z(8, 1000), _z(8, 1000), True),
    "tile twiddles": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(p, _z(8, 1024), True),
    "tile scale dit": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(p, p, False, p),
    "tile dit after dit": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(p, p, False, None, p),
    "tile dit table": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(p, p, True, p, _z(8, 1024)),
    "tile empty batch": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(_z(0, 8, 2048), p, True),
    "tile batch words": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(_z(3, 4, 2048), p, True),
    "tile batch strided": lambda p, r, rp, c, v, o, sq: fr.ntt_tile_cuda(
        _strided((3, 8, 2048), (8 * 4096, 4096, 1)), p, True),
    "stage span": lambda p, r, rp, c, v, o, sq: fr.ntt_stage_cuda(p, p, 11, True),
    "stage in tile": lambda p, r, rp, c, v, o, sq: fr.ntt_stage_cuda(p, p, 9, True),
    "quotient zinv": lambda p, r, rp, c, v, o, sq: fr.quotient_cuda(p, p, p, p),
    "quotient dtype": lambda p, r, rp, c, v, o, sq: fr.quotient_cuda(
        p, _z(8, 2048, dtype=torch.int64), p, o),
    "powers table": lambda p, r, rp, c, v, o, sq: fr.powers_cuda(_z(8, 16), o, 11, 0),
    "powers mode": lambda p, r, rp, c, v, o, sq: fr.powers_cuda(sq, o, 11, 2),
}


@pytest.mark.parametrize("case", sorted(FR_BAD))
def test_fr_wrappers_refuse_bad_inputs(mock_library, case):
    """Each Fr wrapper refuses a wrong dtype or shape with a ValueError
    before any C call, and counts no launch."""
    calls, _, _ = mock_library
    with FakeTensorMode(allow_non_fake_inputs=True):
        inputs = _fr_inputs(torch.device("cuda", 0))
        before = {k: w.launches for k, w in fr.KERNELS.items()}
        with pytest.raises(ValueError):
            FR_BAD[case](*inputs)
    assert calls == [] and {k: w.launches for k, w in fr.KERNELS.items()} == before


def test_every_wrapper_launches_through_the_helper(mock_library):
    """Each wrapper makes exactly one C call, through `_build.launch`, with
    the raw current-stream handle last, no device context (the device is
    current), and counts one launch."""
    calls, _, contexts = mock_library
    with FakeTensorMode(allow_non_fake_inputs=True):
        cases = _wrapper_calls(torch.device("cuda", 0))
        for wrapper, entry, thunk in cases:
            before = wrapper.launches
            del calls[:]
            thunk()
            assert [c[0] for c in calls] == [entry], entry
            args = calls[0][1]
            assert len(args) == len(_build._ARGTYPES[entry]) and args[-1] == STREAM, entry
            assert wrapper.launches == before + 1, entry
    assert contexts == []
    assert {e for _, e, _ in cases} == set(_build._ARGTYPES)


def test_launch_enters_the_device_only_when_not_current(mock_library, monkeypatch):
    """A tensor on another device than the current one takes a device
    context and that device's stream."""
    calls, _, contexts = mock_library
    monkeypatch.setattr(_build, "_get_device", lambda: 1)
    _build.launch("add_one_launch", torch.device("cuda", 0), 16, 32, 8)
    assert contexts == [0] and calls == [("add_one_launch", (16, 32, 8, STREAM))]
    monkeypatch.setattr(_build, "_get_device", lambda: 0)
    _build.launch("add_one_launch", torch.device("cuda", 0), 16, 32, 8)
    assert contexts == [0] and len(calls) == 2


def test_launch_raises_on_every_nonzero_return(mock_library):
    """A non-zero return of any entry point raises, and the wrapper counts
    no launch."""
    calls, set_rc, _ = mock_library
    for rc in (1, 98, 700):
        set_rc(rc)
        with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
            _build.launch("ntt_semi_launch", torch.device("cuda", 0), 0, 0, 0, 0, 1, 9)
    with FakeTensorMode(allow_non_fake_inputs=True):
        for wrapper, entry, thunk in _wrapper_calls(torch.device("cuda", 0)):
            before = wrapper.launches
            with pytest.raises(RuntimeError, match=entry):
                thunk()
            assert wrapper.launches == before, entry


@pytest.mark.parametrize("window, nw", [(5, 51), (5, 52), (3, 86), (12, 22), (17, 16)])
def test_recode_window_count_reaches_the_kernel(mock_library, window, nw):
    """The recode's wrapper passes its window count to the C entry point
    (before the stream) and sizes the digits (nw K, n_pad) by it; a count
    but ceil(255 / w) and 255 // w + 1 is refused before any call."""
    calls, _, _ = mock_library
    with FakeTensorMode(allow_non_fake_inputs=True):
        dev = torch.device("cuda", 0)
        scalars = torch.zeros((3, 8, 4), dtype=torch.int64, device=dev)
        flags = torch.zeros(8, dtype=torch.bool, device=dev)
        digits, _ = msm_recode.signed_digits_cuda(scalars, flags, window, 16, nw)
        assert tuple(digits.shape) == (3 * nw, 16)
        assert calls[-1][0] == "signed_digits_launch"
        assert calls[-1][1][4:] == (8, 16, 3, window, nw, STREAM)
        del calls[:]
        before = msm_recode.signed_digits_cuda.launches
        for bad in (nw - 1, nw + 1):
            if bad in (msm_recode.n_windows(window), msm_recode.n_windows_carry(window)):
                continue
            with pytest.raises(ValueError, match="windows at w"):
                msm_recode.signed_digits_cuda(scalars, flags, window, 16, bad)
        assert calls == [] and msm_recode.signed_digits_cuda.launches == before


@pytest.mark.parametrize("lanes", [0, 1, 32, 256])
def test_bucket_lanes_reach_the_kernel(mock_library, lanes):
    """The merge level's wrapper passes W, c, nb and its lanes a CTA (0:
    the entry's choice) to the C entry point, before the stream; a lanes
    count that is no form is refused before any call."""
    calls, _, _ = mock_library
    with FakeTensorMode(allow_non_fake_inputs=True):
        dev = torch.device("cuda", 0)
        nodes = torch.zeros((35, 2, 8), dtype=torch.int32, device=dev)
        level = (nodes, nodes, nodes, torch.zeros((2, 8), dtype=torch.bool, device=dev))
        half = torch.zeros((35, 2, 4), dtype=torch.int32, device=dev)
        bridge = (half, half, half, torch.zeros((2, 4), dtype=torch.bool, device=dev))
        keys = torch.zeros((2, 8), dtype=torch.int32, device=dev)
        bank = msm_bucket.bucket_bank(2, 3, dev)
        msm_bucket.bucket_level_cuda(bridge, level, level, keys, keys, bank, 3, lanes)
        assert calls[-1][0] == "bucket_level_launch"
        assert calls[-1][1][-5:] == (2, 8, 3, lanes, STREAM)
        del calls[:]
        before = msm_bucket.bucket_level_cuda.launches
        for bad in (3, 48, 512, -1):
            with pytest.raises(ValueError, match="lanes"):
                msm_bucket.bucket_level_cuda(bridge, level, level, keys, keys, bank, 3, bad)
        assert calls == [] and msm_bucket.bucket_level_cuda.launches == before


@pytest.mark.parametrize("log_n, nvec", [(11, 1), (11, 3), (17, 3), (3, 3)])
def test_fr_tile_batch_reaches_the_kernel(mock_library, log_n, nvec):
    """The tile's wrapper passes n, the tile's log (at most 10), the form
    and the batch's vector count to the C entry point; the round trip (DIF,
    scale, DIT) is one call for the whole batch."""
    calls, _, _ = mock_library
    with FakeTensorMode(allow_non_fake_inputs=True):
        dev, n = torch.device("cuda", 0), 1 << log_n
        x = torch.zeros((nvec, 8, n) if nvec > 1 else (8, n), dtype=torch.int32, device=dev)
        tw = torch.zeros((8, n), dtype=torch.int32, device=dev)
        for dif, scale, tw_dit in ((True, tw, tw), (True, None, None), (False, None, None)):
            del calls[:]
            assert fr.ntt_tile_cuda(x, tw, dif, scale, tw_dit) is x
            assert [c[0] for c in calls] == ["fr_ntt_tile_launch"]
            assert calls[0][1][4:] == (n, min(log_n, 10), int(dif), nvec, STREAM)


@pytest.mark.parametrize("n_long", [0, 3])
def test_fr_spmv_bins_reach_the_kernel(mock_library, n_long):
    """The sparse product's wrapper passes its rows, the copied rows and
    the count of long rows to the C entry point, and writes into the
    caller's buffer where given."""
    calls, _, _ = mock_library
    with FakeTensorMode(allow_non_fake_inputs=True):
        dev = torch.device("cuda", 0)
        row_ptr = torch.zeros(9, dtype=torch.int32, device=dev)
        cols = torch.zeros(16, dtype=torch.int32, device=dev)
        vals = torch.zeros((8, 16), dtype=torch.int32, device=dev)
        z = torch.zeros((8, 40), dtype=torch.int32, device=dev)
        order = torch.zeros(32, dtype=torch.int32, device=dev)
        out = torch.zeros((8, 32), dtype=torch.int32, device=dev)
        assert fr.spmv_cuda(row_ptr, cols, vals, z, 32, 5, bins=(order, n_long), out=out) is out
        assert calls[-1][0] == "fr_spmv_launch"
        args = calls[-1][1]
        assert (args[3], args[5], args[7:10], args[11:]) == (16, 40, (32, 8, 5), (n_long, STREAM))


@pytest.mark.parametrize("passes", [False, True])
def test_entry_points_published_only_after_self_test(monkeypatch, passes):
    """A library whose self-test fails is never launched: every later
    launch loads, self-tests and raises again.  One that passes publishes
    its entry points, and the launch goes through them."""
    calls, tested = [], []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    class Lib:
        def __getattr__(self, name):
            return Entry(name)

    def self_test(fn):
        tested.append(fn.name)
        if not passes:
            raise RuntimeError("kernel library self-test (x + 1) failed")

    monkeypatch.setattr(_build, "_FN", {})
    monkeypatch.setattr(_build, "build", lambda: ("libkernels.so", 0.0, ""))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build, "_self_test", self_test)
    monkeypatch.setattr(_build, "_get_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: STREAM + index)
    _build.library.cache_clear()
    try:
        for attempt in (1, 2):
            if passes:
                _build.launch("add_one_launch", torch.device("cuda", 0), 16, 32, 8)
                assert calls == [("add_one_launch", (16, 32, 8, STREAM))] * attempt
                assert tested == ["add_one_launch"]
                assert set(_build._FN) == set(_build._ARGTYPES)
            else:
                with pytest.raises(RuntimeError, match="self-test"):
                    _build.launch("add_one_launch", torch.device("cuda", 0), 16, 32, 8)
                assert calls == [] and _build._FN == {}
                assert tested == ["add_one_launch"] * attempt
    finally:
        _build.library.cache_clear()


def test_sass_counts_parses_a_listing(monkeypatch):
    """`sass_counts` counts each kernel's opcodes without modifiers,
    predicated instructions included, from a `cuobjdump -sass` listing."""
    listing = """
	code for sm_90a
		Function : _Z3fooPi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   LOP3.LUT R2, R0, 0xffff, RZ, 0xc0, !PT ;
        /*0020*/                   LEA.HI R3, R0, R2, RZ, 0x10 ;
        /*0030*/              @!P0 IMAD.MOV.U32 R4, RZ, RZ, R3 ;
        /*0040*/                   EXIT ;
        /*0050*/                   BRA 0x50;
		Function : _Z3barPi
        /*0000*/                   IADD3 R1, R1, R2, R3 ;
"""

    class Done:
        stdout = listing

    monkeypatch.setattr(_build, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: Done())
    counts = _build.sass_counts("lib.so")
    assert dict(counts["_Z3fooPi"]) == {"LDC": 1, "LOP3": 1, "LEA": 1, "IMAD": 1,
                                        "EXIT": 1, "BRA": 1}
    assert dict(counts["_Z3barPi"]) == {"IADD3": 1}
