"""Shared bootstrap for the example scripts.

Importing this module makes the examples runnable from the repo root
(``python examples/<name>.py``).  JAX picks its platform from
``JAX_PLATFORMS`` as usual (``JAX_PLATFORMS=cpu`` keeps a run off the GPU).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
