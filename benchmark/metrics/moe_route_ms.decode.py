"""Device ms a decode step of the MoE router (models/transformer.py
`route`): the gate's product, the stable sort of the expert logits and
the softmax of the top two, matched in the trace by name: each radix
sort of the logits (torch.sort, stable), the product kernels launched
just before it, and each two-way softmax. Read over the traced window's
steps; None where no router ran."""

SORT = "radixSortKVInPlace"
SOFTMAX = "softmax_warp_forward<float, float, float, 1,"
PRODUCT = ("nvjet", "splitKreduce", "gemv", "gemm", "Kernel2")


def read(r):
    ops = r.ops
    total, sorts = 0.0, 0
    for i, (name, a, b) in enumerate(ops):
        if SORT in name:
            sorts += 1
            total += b - a
            j = i - 1
            while j >= 0 and i - j <= 2 and any(p in ops[j][0]
                                                for p in PRODUCT):
                total += ops[j][2] - ops[j][1]
                j -= 1
        elif SOFTMAX in name:
            total += b - a
    steps = sum(1 for s in r.steps if s["kind"] == "step")
    if not sorts or not steps:
        return None
    return 1e-3 * total / steps
