"""Set-up: from the start of the process to the first timed unit of work
(kernel builds or their cache, weights and inputs from the seed, warm-up)."""
UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.values.get("setup_s")
