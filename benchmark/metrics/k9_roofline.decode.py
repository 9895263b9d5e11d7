"""K9's share of its roofline in decode (csrc/mla_decode.cu, the latent
attention of an MLA model): the least time the traced steps' latent
attention needs (the architecture's latent_attention: each live latent
row's bytes once a layer, the queries and outputs, 2 H (R + rope + R)
operations a live row; at the data sheet's peaks) over the time of K9's
calls, each from its chunk kernel's start to its combine's end. None where
the architecture has no latent attention or no K9 call ran."""

from harness import work as W

FIRST = "mla_chunk_kernel"
REST = ("mla_combine_kernel",)


def read(r):
    lat = getattr(r.arch, "latent_attention", None)
    calls = r.calls(FIRST, REST)
    if lat is None or not calls:
        return None
    need = W.Work()
    for s, pos in zip(r.steps, r.step_pos):
        if s["kind"] == "step":
            for p in pos:
                need += lat(p + 1, p + 1, 1, r.d)
    if not need.bytes:
        return None
    need = W.Work(bytes=need.bytes * r.d.n_layers,
                  flops=need.flops * r.d.n_layers)
    spent = sum(b - a for a, b in calls) * 1e-6
    return 100.0 * r.least_s(need) / spent
