"""kernels: the GN data term's share of its roofline, over every call of
solver/gn.data_normal in the profiled frames (the data Gram, its right-hand
side and the data cost; one span a call).

Bytes and operations as the port's chip_smoke.gram_case counts them for
these inputs: the (N, K) indices and weights, s2 and delta read once, the
(D, D) Gram and (D, 3) right-hand side written once in float32; 2
operations a pair of valid slots in a row and 7 a valid slot, rows with
s2 = 0 and padded slots adding nothing."""

from dfbench.peaks import roofline_pct

SPANS = {"data_gram": ["dynfu_tpu_torch.solver.gn:data_normal"]}


def work(idx, s2, D: int, per_pair: int, per_slot: int) -> float:
    ok = (idx >= 0) & (idx < D) & (s2[:, None] > 0)
    n = ok.sum(1).double()
    return float((n * n).sum()) * per_pair + float(n.sum()) * per_slot


def cost(args, kw):
    idx, _, s2, _, D = args[:5]
    N, K = idx.shape
    return N * K * 8 + N * 16 + (D * D + D * 3) * 4, work(idx, s2, D, 2, 7)


def read(run):
    return roofline_pct(run, "data_gram", cost)
