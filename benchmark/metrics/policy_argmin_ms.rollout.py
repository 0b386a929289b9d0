"""Device milliseconds of the policy's candidates in one closed-loop step of
the whole batch (every candidate's right-hand side and the argmin): the
program's ``policy.argmin`` spans (``c3sc_tpu_torch.utils.metrics``) over its
``integrate`` spans, one a step."""


def read(ctx):
    try:
        from c3sc_tpu_torch.utils.metrics import snapshot
    except ImportError:     # a program without the port's spans
        return None
    rows = snapshot()["spans"]
    part = [r for r in rows if r["name"] == "policy.argmin" and r["entries"]]
    n = sum(r["entries"] for r in rows if r["name"] == "integrate")
    return 1e3 * sum(r["device_s"] for r in part) / n if part and n else None
