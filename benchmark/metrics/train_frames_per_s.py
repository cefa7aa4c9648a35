"""Frames of every step completed in the window over the window's wall
time, the loader's waits included (global frames across ranks)."""


def read(run):
    if "frames" not in run or run["window_s"] <= 0:
        return None
    return run["frames"] / run["window_s"]
