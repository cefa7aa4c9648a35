"""Share of the profiled window in which no kernel, memcpy or memset
ran on the card."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
