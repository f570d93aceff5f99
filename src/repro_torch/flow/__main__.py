"""``python -m repro_torch.flow`` entry point (see flow.cli)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
