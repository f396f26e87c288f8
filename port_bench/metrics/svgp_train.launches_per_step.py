"""Device operations (kernels, memcpys, memsets) in the profiled slice over
its steps: the host's work a step, as launches."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["device"] or not t["units"]:
        return None
    return len(t["device"]) / t["units"]
