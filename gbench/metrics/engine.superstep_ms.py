"""The engine's superstep on the card: the device-cost profiler's
``engine.superstep`` milliseconds a call over the window."""


def read(run):
    if not run.get("on_card"):
        return None
    k = run.get("devprof", {}).get("engine.superstep")
    if not k or k["calls"] <= 0:
        return None
    return k["exec_s"] / k["calls"] * 1e3
