"""python -m insider_tpu_torch fit|tune|simulate (cli.py)."""

from insider_tpu_torch.cli import main

main()
