"""K2's share of its roofline in the batched step
(csrc/mxu_matvec_batch.cu): the least time the traced batched steps' K2
products need (each step's slots share the longest prefix the reference
selection finds their inputs need) over the time K2's calls inside the
steps took, each call from its selection kernel's start to its last
kernel's end."""

FIRST = "select_batch_kernel"
REST = ("mma_stream_kernel", "reduce_batch_kernel")


def read(r):
    calls = r.calls(FIRST, REST, within="step")
    if not calls:
        return None
    spent = sum(b - a for a, b in calls) * 1e-6
    return 100.0 * r.least_s(r.products("step")) / spent
