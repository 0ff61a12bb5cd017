"""CLI entry: ``python -m repro_torch.analysis <paths...>``."""
import sys

from .engine import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
