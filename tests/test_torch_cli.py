"""The port's user entry points against the JAX package's: `python -m
falcon_r1cs_tpu_torch` (`__main__.main`, in-process) prints the same
counts table and verdicts and returns the same exit codes, `entry()`
gives the JAX package's `generate_witness_ntt` outputs, and without a
card every device command asks for `--device cpu` instead of running on
the CPU."""

import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from falcon_r1cs_tpu.__main__ import main as jax_main
from falcon_r1cs_tpu_torch.__main__ import main
from falcon_r1cs_tpu_torch.entry import _example_batch, entry
from falcon_r1cs_tpu_torch.examples import pok_sig
from falcon_r1cs_tpu_torch.r1cs import coo
from falcon_r1cs_tpu_torch.tools import default_route
from falcon_r1cs_tpu_torch.utils.device import DeviceUnavailableError


@pytest.fixture
def port_cache(tmp_path, monkeypatch):
    """The port's artifact directory (COO and CRS) under tmp_path."""
    monkeypatch.setattr(coo, "cache_dir", lambda: tmp_path)
    monkeypatch.setattr(pok_sig, "cache_dir", lambda: tmp_path)
    return tmp_path


def _jax_cli(argv, monkeypatch):
    """The JAX package's CLI in-process; it rewrites sys.argv and sys.path,
    which the test restores."""
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setattr(sys, "path", list(sys.path))
    return jax_main(argv)


def test_counts_prints_the_jax_text(capsys, monkeypatch):
    assert main(["counts", "--n", "512"]) == 0
    got = capsys.readouterr().out
    assert _jax_cli(["counts", "--n", "512"], monkeypatch) == 0
    assert got == capsys.readouterr().out
    rows = {line[:22].strip(): line[22:].split("|")[:3] for line in got.splitlines()[1:5]}
    assert [int(x) for x in rows["verify with ntt"]] == [1025, 78386, 81460]


def test_selftest():
    assert main(["selftest"]) == 0


def test_verify_prints_the_jax_verdicts(capsys, monkeypatch):
    assert main(["verify", "4", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _jax_cli(["verify", "4"], monkeypatch) == 0
    assert got == capsys.readouterr().out
    assert got.strip().endswith("[True, True, True, False]")


def test_aggregate_on_cpu(capsys, port_cache):
    """Wire bytes -> witnesses -> CRT verdict, then two proofs from one CRS
    through prove_batch (the native C multi-MSMs) and their verification."""
    argv = ["aggregate", "--n", "512", "--k", "4", "--prove", "2", "--device", "cpu"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "batched CRT satisfiability: all 4 valid = True" in out
    assert "all 2 proofs verify" in out
    # "auto" on the CPU, resolved, in the line tools.default_route reads
    assert default_route.COMMANDS["aggregate --prove 2"][1].search(out).group(1) == "native"
    assert (port_cache / "FalconNTTVerificationCircuit_512.r1cs").exists()
    assert (port_cache / "FalconNTTVerificationCircuit_512.pk.npz").exists()


def test_pok_sig_on_cpu(capsys, port_cache):
    """keygen, sign, witness, CRT check, setup (CRS cached), prove from the
    packed witness, verify, the tampered input rejected; twice, the second
    time from the cached CRS."""
    for first in (True, False):
        assert main(["pok-sig", "512", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert ("Groth16 setup" in out) == first and ("CRS load (cached)" in out) != first
        assert "R1CS satisfied (device CRT check): True" in out
        # "auto" on the CPU, resolved, in the line tools.default_route reads
        assert default_route.COMMANDS["pok-sig"][1].search(out).group(1) == "native"
        assert out.rstrip().endswith("tampered public input rejected")


def test_entry_matches_jax():
    step, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    jstep, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), b)
    assert all(np.array_equal(a, b) for a, b in zip(_example_batch(1024, 8), jargs))
    got = step(*args)
    want = jax.jit(jstep)(*jargs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("argv", [
    ["verify", "2"],
    ["aggregate", "--n", "512", "--k", "2"],
    ["pok-sig", "512", "--g1-backend", "gpu"],
])
def test_device_commands_need_a_card_unless_cpu_is_asked(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err and "torch.cuda.is_available() is false" in err


def test_entry_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError, match="device='cuda'"):
        entry()


def test_usage_errors_return_argparse_codes(capsys):
    assert main(["--help"]) == 0
    assert main(["nonsense"]) == 2
    assert main(["aggregate", "--n", "7"]) == 2
    assert main(["pok-sig", "--help"]) == 0
    assert "--g1-backend" in capsys.readouterr().out
