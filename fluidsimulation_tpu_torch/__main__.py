"""`python -m fluidsimulation_tpu_torch` runs the demo CLI (app/demo.py)."""

import sys

from fluidsimulation_tpu_torch.app.demo import main

if __name__ == "__main__":
    sys.exit(main())
