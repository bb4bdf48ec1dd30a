"""``python -m repro_torch.analysis`` == ``python -m repro_torch.cli lint``."""

import sys

from repro_torch.analysis.core import main

if __name__ == "__main__":
    sys.exit(main())
