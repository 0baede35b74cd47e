"""kernels: the ICP stencil fetch's share of its roofline, over every call
of ops/stencil_cuda.fetch_stencil in the profiled frames (one span a
call).

Bytes as the port's chip_smoke.stencil_case counts them: the two int32
index maps read once, the (H, W, C) float32 image read once and the
output written once; no arithmetic."""

from dfbench.peaks import roofline_pct

SPANS = {"stencil": ["dynfu_tpu_torch.ops.stencil_cuda:fetch_stencil"]}


def cost(args, kw):
    H, W, C = args[0].shape
    return H * W * (8 + 2 * 4 * C), 0


def read(run):
    return roofline_pct(run, "stencil", cost)
