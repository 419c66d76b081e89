import sys

from repro_torch.bench.cli import main

sys.exit(main())
