"""`python -m lightgbm_tpu_torch config=train.conf` — the command line
(cli.py; reference src/main.cpp:14)."""

import sys

from .cli import main

sys.exit(main())
