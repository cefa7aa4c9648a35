"""Seconds from the process's start to the window's: imports, the
first run's kernel builds, the port's context, weights, inputs, warm-up."""


def read(run):
    return run["setup_s"]
