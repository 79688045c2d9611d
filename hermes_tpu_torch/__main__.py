import sys

from hermes_tpu_torch.cli import main

sys.exit(main())
