"""signal_tpu_torch — the PyTorch/CUDA port of signal_tpu for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference): the same
module layout, PyTorch inside, and a hand-written CUDA kernel wherever the
JAX package wrote a Pallas kernel for the TPU. It imports neither ``jax``
nor ``signal_tpu``. Entry points run on ``cuda`` unless the caller asks
for ``cpu`` (``MODEL.DEVICE``).
"""

__version__ = "0.1.0"
