"""``python -m tame_torch`` entry point."""

import sys

from tame_torch.cli import main

sys.exit(main())
