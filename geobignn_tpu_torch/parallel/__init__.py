"""Multi-device execution: data parallel (dp) x graph parallel (gp) over a
grid of devices (api.py), and halo-sharded node partitions (partition.py,
halo_model.py, halo_train.py, accounting.py)."""
