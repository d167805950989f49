"""The JAX package's example programs that train to convergence, on the card:
`train_synthetic_campaign` (the 500-epoch synthetic campaign) and
`halo_convergence` (single-device against 8-part halo training)."""
