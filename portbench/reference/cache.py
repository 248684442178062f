"""Where the reference keeps what it builds: the exact Moran matrices, one
file per sample size, at a fixed path inside the checkout
(``<checkout>/build/portbench/cache``), so that only a checkout's first run
builds them."""

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "portbench", "cache",
)
