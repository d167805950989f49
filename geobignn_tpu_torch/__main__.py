"""`python -m geobignn_tpu_torch train|infer|eval|campaign` (see cli.py)."""

from geobignn_tpu_torch.cli import main

if __name__ == "__main__":
    main()
