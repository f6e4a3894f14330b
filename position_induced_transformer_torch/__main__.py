"""``python -m position_induced_transformer_torch``: the command line
(:mod:`position_induced_transformer_torch.cli`)."""

import sys

from position_induced_transformer_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
