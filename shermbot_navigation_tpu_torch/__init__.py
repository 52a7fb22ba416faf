"""PyTorch + CUDA port of the EKF-SLAM engine, for NVIDIA Hopper (H100).

``shermbot_navigation_tpu`` (JAX/XLA/Pallas) is the frozen reference this
package is held against; this package imports ``torch`` and never ``jax``.
Every Pallas kernel on a ported path has a hand-written CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built at first use (``ops/kernels/_build.py``)
and launched by a wrapper beside its plain PyTorch version.

Importing the package pins full-precision f32 matrix products on the card:
reduced-precision (TF32) inputs diverge the EKF covariance algebra, the same
pathology the JAX package guards against with ``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
