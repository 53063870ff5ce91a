"""``python -m repro_torch.analysis``: the analyzer CLI (see cli.py)."""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
