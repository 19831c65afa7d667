"""easyrec_torch: the PyTorch/CUDA port of easyrec_tpu.

Reads the same pipeline configs and trains the same models as the JAX
package beside it, on an NVIDIA GPU; the sparse embedding update runs as
CUDA kernels written for Hopper (easyrec_torch/csrc). Imports nothing of
JAX or of easyrec_tpu.
"""

__version__ = '0.1.0'
