"""K1's share of its roofline in decode (csrc/mxu_matvec.cu): the least
time the traced steps' K1 products need (bytes and operations the
reference selection finds these inputs need, at the data sheet's peaks)
over the time K1's calls took, each call from its selection kernel's
start to its last kernel's end."""

FIRST = "k1_select_kernel"
REST = ("k1_stream_kernel", "k1_reduce_kernel")


def read(r):
    calls = r.calls(FIRST, REST)
    if not calls:
        return None
    spent = sum(b - a for a, b in calls) * 1e-6
    return 100.0 * r.least_s(r.products("step")) / spent
