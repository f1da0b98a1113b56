"""The port's measurement tools, each a plain function plus a `main()`:

    python -m falcon_r1cs_tpu_torch.tools.prove_large [schoolbook|dual]
    python -m falcon_r1cs_tpu_torch.tools.prove_batch_large [dual|schoolbook] [K]
    python -m falcon_r1cs_tpu_torch.tools.msm_multi [--k 1 2 4 8]

The counterparts of the JAX package's `tools/prove_large.py`,
`tools/bench_prove_batch_large.py` and `tools/bench_tpu_msm_multi.py`.
Each runs on the card unless it is given `--device cpu` (`device="cpu"`),
and raises `utils.device.DeviceUnavailableError` (exit code 2 from
`main`) when the card it defaults to is absent.
"""
