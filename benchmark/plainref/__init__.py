"""The benchmark's plain reference: a frozen copy of the PyTorch port's
engines with every hand-written kernel replaced by its plain PyTorch
version.

The subpackages core, engine, mesh, ops, rigid, solver, volume and warp are
copies of dynfu_tpu_torch's, taken at the commit that added the benchmark,
with their imports renamed; `kernels` is not a copy: its dispatch rule sends
every call to the plain version, on the card as on the CPU, and nothing here
builds or launches a CUDA kernel. The benchmark runs the reference on the
frames the program was given, from the state the program held before each
checked frame, and judges the program's outputs against it. Later changes to
the program do not change this copy, so it stays the yardstick.

It is not an independent implementation: outside the kernels it is the
port's own code as it stood, so it catches a departure from those
semantics (a kernel, or a later change to the engines), not an error the
engines already had. The port's tests hold the engines against the JAX
package on the CPU.
"""

import torch

# float32 everywhere, as the port holds it: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
