"""Set-up time: from the start of the run's process to the service's readiness
(loading, kernels, warm-up of the cell's shapes, the loop's voices), before any
traffic."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
