"""``python -m repro_torch.analysis [paths...]`` — run the lint gate."""

import sys

from .lint import main

if __name__ == "__main__":
    sys.exit(main())
