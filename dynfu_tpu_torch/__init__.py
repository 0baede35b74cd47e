"""dynfu_tpu_torch — the PyTorch / CUDA port of dynfu_tpu for NVIDIA Hopper.

The same DynamicFusion and rigid KinFu engines as dynfu_tpu, with the same
module layout, in eager PyTorch. Every Pallas kernel of dynfu_tpu is a CUDA
C++ kernel written for sm_90a (csrc/), built at first use by
`dynfu_tpu_torch.kernels` and launched through its wrapper:

* marching-cubes triangle pack     -> mesh.mc_cuda.pack_triangles
* k-NN with node-feature fetch     -> ops.knn_cuda.knn_gather
* windowed 1-NN correspondence     -> ops.corr_cuda.nn1_window_sweep
* fused warp (k-NN + DQB or DLB)   -> ops.warp_cuda.warp_fused
* GN data-term Gram                -> solver.gram_cuda.data_normal
* SE(3) monomial Grams             -> solver.gram_cuda.monomial_grams
* rigid ICP's stencil fetch        -> ops.stencil_cuda.fetch_stencil

A wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; nothing falls back from one to the other.

The package never imports jax or dynfu_tpu (whose __init__ imports jax); the
numpy-only pieces it needs are copied, each naming its source.
"""

import torch

# The GN solve, the Gram assembly and the geometry products are held to
# IEEE float32. TF32 keeps about ten mantissa bits, so it is off for both
# matmuls and convolutions, for the whole process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from dynfu_tpu_torch.engine.params import (  # noqa: E402,F401
    DynFuParams, KinFuParams, SolverParams)
from dynfu_tpu_torch.core.camera import Intr  # noqa: E402,F401
