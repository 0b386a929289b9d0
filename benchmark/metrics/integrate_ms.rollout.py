"""Device milliseconds of the integrator in one closed-loop step of the whole
batch (the Euler-Maruyama step, the boundaries, the cost and the masks): the
program's ``integrate`` spans (``c3sc_tpu_torch.utils.metrics``) over their
number, one a step."""


def read(ctx):
    try:
        from c3sc_tpu_torch.utils.metrics import snapshot
    except ImportError:     # a program without the port's spans
        return None
    rows = snapshot()["spans"]
    part = [r for r in rows if r["name"] == "integrate" and r["entries"]]
    n = sum(r["entries"] for r in rows if r["name"] == "integrate")
    return 1e3 * sum(r["device_s"] for r in part) / n if part and n else None
