"""Device milliseconds of the policy's neighbour values in one closed-loop
step of the whole batch (the value at the stencil's 2d neighbours of every
state: ``multilinear_interp`` here): the program's ``policy.values`` spans
(``c3sc_tpu_torch.utils.metrics``) over its ``integrate`` spans, one a step."""


def read(ctx):
    try:
        from c3sc_tpu_torch.utils.metrics import snapshot
    except ImportError:     # a program without the port's spans
        return None
    rows = snapshot()["spans"]
    part = [r for r in rows if r["name"] == "policy.values" and r["entries"]]
    n = sum(r["entries"] for r in rows if r["name"] == "integrate")
    return 1e3 * sum(r["device_s"] for r in part) / n if part and n else None
