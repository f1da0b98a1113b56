"""The port's measurement tools, each a plain function plus a `main()`:

    python -m falcon_r1cs_tpu_torch.tools.prove_large [schoolbook|dual]
    python -m falcon_r1cs_tpu_torch.tools.prove_batch_large [dual|schoolbook] [K]
    python -m falcon_r1cs_tpu_torch.tools.msm_multi [--k 1 2 4 8]
    python -m falcon_r1cs_tpu_torch.tools.profile_prove [iters]
    python -m falcon_r1cs_tpu_torch.tools.prove_batch [K] [iters]
    python -m falcon_r1cs_tpu_torch.tools.pp_vs_dp [S] [n] [microbatch] [n_micro]

The counterparts of the JAX package's `tools/prove_large.py`,
`tools/bench_prove_batch_large.py`, `tools/bench_tpu_msm_multi.py`,
`tools/profile_prove.py`, `tools/bench_prove_batch.py` and
`tools/pp_vs_dp.py`.  Each runs on the card unless it is given
`--device cpu` (`device="cpu"`), and raises
`utils.device.DeviceUnavailableError` (exit code 2 from `main`) when the
card it defaults to is absent; `pp_vs_dp` on "cuda" needs a card a rank
and exits 2 with fewer.
"""
