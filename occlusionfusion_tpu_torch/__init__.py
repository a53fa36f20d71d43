"""occlusionfusion_tpu_torch — the PyTorch / CUDA port of occlusionfusion_tpu.

The same non-rigid RGB-D fusion engine, written in PyTorch for an NVIDIA
H100. The JAX package ``occlusionfusion_tpu`` stays the reference: each
module here mirrors its counterpart by name, keeps its tensor layouts
(static padded shapes, pivoted node transforms) and is held against it
in ``tests/test_torch_*.py``. This package never imports JAX or the JAX
package.

Every Pallas kernel of the JAX package on this package's path is a CUDA
kernel written by hand in ``csrc/``, built with ``nvcc`` at first use
(see ``device.py``); each has a plain PyTorch twin beside its wrapper,
which runs when the wrapper is given CPU tensors.
"""

from occlusionfusion_tpu_torch import device  # noqa: F401  (TF32 policy)

__version__ = "0.1.0"
