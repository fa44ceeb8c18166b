"""backpacks_flash_attn_tpu_torch: the PyTorch/CUDA port of
backpacks_flash_attn_tpu for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; every Pallas kernel on the ported path is a
hand-written CUDA kernel under ``csrc/`` (built by ``ops/_build.py``). The
package imports nothing of JAX or of the JAX package. Entry points allocate
on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from . import config
from .config import (BackpackConfig, GPTConfig, backpack_micro, backpack_mini,
                     backpack_small, backpack_test, gpt2_small)

__version__ = "0.1.0"
