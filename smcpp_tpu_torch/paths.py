"""Where the port writes what it builds and caches: one git-ignored
directory beside the package (``<checkout>/build/smcpp_tpu_torch``)."""

import os

BUILD_DIR = os.environ.get(
    "SMCPP_TPU_TORCH_BUILD",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "smcpp_tpu_torch",
    ),
)
