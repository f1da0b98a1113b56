"""The port's examples: the counterparts of the repo's `examples/`
(`constraint_counts.py`, `pok_sig.py`, `aggregate_sig.py`), each with a
`main(argv)` that `python -m falcon_r1cs_tpu_torch` calls in-process."""
