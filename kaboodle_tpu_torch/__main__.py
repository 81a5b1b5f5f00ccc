"""``python -m kaboodle_tpu_torch`` -- the demo CLI (see kaboodle_tpu_torch.cli)."""

import sys

from kaboodle_tpu_torch.cli import main

sys.exit(main())
