"""Host milliseconds a cold dense solve spends capturing its CUDA graphs (two
a solve, K1's kernels preloaded first): the program's ``dense.capture``
spans (``c3sc_tpu_torch.utils.metrics``) over its ``dense_vi`` spans."""


def read(ctx):
    try:
        from c3sc_tpu_torch.utils.metrics import snapshot
    except ImportError:     # a program without the port's spans
        return None
    rows = snapshot()["spans"]
    part = [r for r in rows if r["name"] == "dense.capture" and r["entries"]]
    n = sum(r["entries"] for r in rows if r["name"] == "dense_vi")
    return 1e3 * sum(r["host_s"] for r in part) / n if part and n else None
