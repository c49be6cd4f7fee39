import sys

from tsta_tpu_torch.cli import main

sys.exit(main())
