"""The JAX repo's example programs on the card: the programs that train to
convergence, `train_synthetic_campaign` (the 500-epoch synthetic campaign)
and `halo_convergence` (single-device against 8-part halo training); and
its measuring scripts, `kernel_probe`, `trace_step`, `profile_step`,
`profile_large`, `probe_serial`, `probe_f1_327k`, `bench_dynamic`,
`probe_dynamic` and `halo_scaling_report` (sharing `_probe` and
`_sample`), each run as `python -m geobignn_tpu_torch.examples.<name>`."""
