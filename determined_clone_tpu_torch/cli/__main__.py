import sys

from determined_clone_tpu_torch.cli import main

sys.exit(main())
