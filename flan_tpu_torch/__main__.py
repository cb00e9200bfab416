import sys

from flan_tpu_torch.cli import main

sys.exit(main())
