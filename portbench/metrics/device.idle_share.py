"""The share of the traced window in which no kernel, copy or set ran
on the card: 1 less the union of the trace's device intervals over the
window's wall time."""


def read(obs):
    dev = obs.get("device")
    if dev is None or not obs["window_s"]:
        return None
    return 1.0 - dev["busy_s"] / obs["window_s"]
