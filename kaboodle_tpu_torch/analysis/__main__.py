"""``python -m kaboodle_tpu_torch.analysis`` -- the analysis CLI entry point."""

import sys

from kaboodle_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except BrokenPipeError:  # output piped into head/grep that closed early
        rc = 0
    raise SystemExit(rc)
