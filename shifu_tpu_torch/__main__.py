"""`python -m shifu_tpu_torch ...` — the port's CLI (cli.py)."""

import sys

from shifu_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
